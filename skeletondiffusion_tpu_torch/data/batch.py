"""Batching and on-device preprocessing: the port's input pipeline.

The host stacks raw numpy segments (``collate``, ``DataLoader``: copies of
``skeletondiffusion_tpu/data/batch.py:107``, `:254`), a background thread
ships each batch to the device through pinned memory
(``prefetch_iterator``), and ``preprocess_batch`` applies the input-space
transform, the training augmentations (mirroring, rotation) and the optional
noisy observation there, batched.  ``bounded_batches`` and
``cycled_batches`` size a training epoch.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# the collated keys that ``prefetch_iterator`` moves to the device; the rest
# (the real-item count, segment ids, metadata) stay on the host
DEVICE_KEYS = ("obs", "pred", "mm_gt", "mm_idx", "mm_mask")


def draw_augmentation(generator: torch.Generator, batch: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """The per-item draws of the training augmentations, from ``generator``
    (on ``device``) in this order: the x and the y mirroring's uniforms, the
    rotation's uniform and its integer degree in [0, 360).  ``preprocess_batch``
    compares the uniforms with the augmentation probabilities."""
    def uniform():
        return torch.rand(batch, generator=generator, device=device)

    u_x, u_y, u_rot = uniform(), uniform(), uniform()
    degrees = torch.randint(0, 360, (batch,), generator=generator, device=device)
    return {"mirror_x": u_x, "mirror_y": u_y, "rotate": u_rot, "degrees": degrees}


def augment(draws: Dict[str, torch.Tensor], tensors: List[Optional[torch.Tensor]],
            da_mirroring: float = 0.0, da_rotations: float = 0.0) -> List[Optional[torch.Tensor]]:
    """Mirroring and rotation of ``skeletondiffusion_tpu/data/batch.py:47-84``
    on the draws of ``draw_augmentation``: x, then y, mirrored where the
    item's uniform is below ``da_mirroring``; one z-rotation by its degree
    where its rotation uniform is below ``da_rotations`` (scipy's
    ``R.from_euler('z', d)``).  The same transform goes to every tensor of
    an item ([B, ..., 3], None passes through)."""
    ref = next(t for t in tensors if t is not None)
    b = ref.shape[0]

    def each(fn, tensors):
        return [None if t is None else fn(t) for t in tensors]

    def per_item(v: torch.Tensor, x: torch.Tensor, tail: int) -> torch.Tensor:
        return v.reshape(b, *([1] * (x.ndim - 1 - tail)), *v.shape[1:])

    if da_mirroring > 0:
        for axis, key in ((0, "mirror_x"), (1, "mirror_y")):
            flip = (draws[key] < da_mirroring).to(ref.device)
            sign = torch.ones((b, 3), dtype=ref.dtype, device=ref.device)
            sign[:, axis] = torch.where(flip, -1.0, 1.0).to(ref.dtype)
            tensors = each(lambda x, sign=sign: x * per_item(sign, x, 1), tensors)
    if da_rotations > 0:
        theta = draws["degrees"].to(ref.device, torch.float32) * (np.pi / 180.0)
        theta = torch.where((draws["rotate"] < da_rotations).to(ref.device), theta, 0.0)
        c, s = torch.cos(theta), torch.sin(theta)
        zeros, ones = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([torch.stack([c, -s, zeros], -1), torch.stack([s, c, zeros], -1),
                           torch.stack([zeros, zeros, ones], -1)], dim=-2)  # [B,3,3]
        tensors = each(lambda x: torch.einsum("...ij,...nj->...ni", per_item(rot, x, 2), x),
                       tensors)
    return tensors


def preprocess_batch(
    skeleton,
    generator: Optional[torch.Generator],
    obs: torch.Tensor,
    pred: torch.Tensor,
    mm_gt: Optional[torch.Tensor] = None,
    train: bool = True,
    da_mirroring: float = 0.0,
    da_rotations: float = 0.0,
    if_noisy_obs: bool = False,
    noise_level: float = 0.25,
    noise_std: float = 0.02,
    draws: Optional[Dict[str, torch.Tensor]] = None,
):
    """Raw metric-space (obs [B,To,J,3], pred [B,Tp,J,3], optional mm_gt
    [B,M,Tp,J,3]) → augmented input-space tensors;
    ``skeletondiffusion_tpu/data/batch.py:22``.

    With ``train`` and a positive ``da_mirroring`` or ``da_rotations`` the
    augmentations (``augment``) run on ``draws``, by default drawn from
    ``generator`` on the tensors' device (``draw_augmentation``).
    ``if_noisy_obs`` adds N(0, ``noise_std``²) to a share ``noise_level`` of
    the non-root joints of the observation (reference
    `motion_dataset.py:11-19,187-188`), drawn from ``generator`` after the
    augmentations' draws: the noise and the mask, in that order.
    """
    augmenting = train and (da_mirroring > 0 or da_rotations > 0)
    if generator is None and (if_noisy_obs or (augmenting and draws is None)):
        raise ValueError("the augmentations and if_noisy_obs draw from a torch.Generator; "
                         "got None")
    if augmenting:
        if draws is None:
            draws = draw_augmentation(generator, obs.shape[0], obs.device)
        obs, pred, mm_gt = augment(draws, [obs, pred, mm_gt], da_mirroring, da_rotations)
    if if_noisy_obs:
        body = obs[..., 1:, :]
        noise = torch.randn(body.shape, generator=generator, device=obs.device,
                            dtype=obs.dtype) * noise_std
        mask = torch.rand(body.shape[:-1], generator=generator, device=obs.device) < noise_level
        obs = torch.cat([obs[..., :1, :], body + noise * mask[..., None]], dim=-2)
    To = obs.shape[-3]
    data = skeleton.tranform_to_input_space(torch.cat([obs, pred], dim=-3))
    obs_t, pred_t = data[..., :To, :, :], data[..., To:, :, :]
    if mm_gt is not None:
        mm_gt = skeleton.tranform_to_input_space(mm_gt)
    return obs_t, pred_t, mm_gt


# unique-row granularity of the deduped mm-GT tensor: padding U to a bucket
# multiple keeps the number of distinct tensor shapes per split small
MM_DEDUP_BUCKET = 128


def collate(batch_items: List[Tuple], max_mmgt: int = 0,
            dedup_mm: bool = False, mm_fetch=None) -> Dict[str, np.ndarray]:
    """Stack raw segments; pad the ragged mm-GT neighbor axis to a fixed
    ``max_mmgt`` (fixed shapes — replaces the reference's Python list
    collate, `motion_dataset.py:21-29`).

    ``dedup_mm``: emit the mm-GT neighbors DEDUPED across the batch —
    ``mm_gt`` becomes the [U,Tp,J,F] unique futures (U padded to a
    MM_DEDUP_BUCKET multiple) plus an ``mm_idx`` [B,max_mmgt] gather table
    into it.  Neighbor sets of nearby segments overlap heavily on real data,
    so this cuts both the host collate and the host→device bytes by the
    duplication factor; the consumer gathers back to the dense
    [B,M,Tp,J,F] form on the device (one gather) before the metric math.
    Requires items to carry ``mm_gt_idces`` (neighbor segment ids,
    row-aligned with ``mm_gt``).

    ``mm_fetch``: optional ``segment_id -> future [Tp,J,F]`` callable
    (``MotionDataset.future_of_segment``).  With it, the dedup path fills
    each unique row straight from the dataset's clip arrays and the items
    need not carry a dense ``mm_gt`` at all (``MotionDataset.mm_lazy``) —
    skipping the per-item neighbor stacks whose rows the dedup would mostly
    discard."""
    obs = np.stack([b[0] for b in batch_items])
    pred = np.stack([b[1] for b in batch_items])
    out: Dict[str, np.ndarray] = {"obs": obs, "pred": pred}
    extras = [b[2] for b in batch_items]
    lazy_mm = ("mm_gt" not in extras[0] and "mm_gt_idces" in extras[0]
               and dedup_mm and mm_fetch is not None)
    if "mm_gt" in extras[0] or lazy_mm:
        B = len(batch_items)
        Tp, J, F = pred.shape[1:]
        mask = np.zeros((B, max_mmgt), dtype=bool)
        if dedup_mm and "mm_gt_idces" in extras[0]:
            # map: neighbor segment id → (first item holding it, row in that
            # item's mm_gt).  Ordered by first appearance for determinism.
            uniq: Dict[int, Tuple[int, int]] = {}
            for i, e in enumerate(extras):
                for j, seg in enumerate(e["mm_gt_idces"][:max_mmgt]):
                    uniq.setdefault(int(seg), (i, j))
            pos = {seg: p for p, seg in enumerate(uniq)}
            idx = np.zeros((B, max_mmgt), dtype=np.int32)
            for i, e in enumerate(extras):
                rows = e["mm_gt_idces"][:max_mmgt]
                for j, seg in enumerate(rows):
                    idx[i, j] = pos[int(seg)]
                mask[i, : len(rows)] = True
            u = len(uniq)
            u_pad = max(MM_DEDUP_BUCKET, -(-u // MM_DEDUP_BUCKET) * MM_DEDUP_BUCKET)
            mm = np.zeros((u_pad, Tp, J, F), dtype=pred.dtype)
            if lazy_mm:
                for seg in uniq:
                    mm[pos[seg]] = mm_fetch(seg)
            else:
                for seg, (i, j) in uniq.items():
                    mm[pos[seg]] = extras[i]["mm_gt"][j]
            out["mm_gt"] = mm
            out["mm_idx"] = idx
        else:
            mm = np.zeros((B, max_mmgt, Tp, J, F), dtype=pred.dtype)
            for i, e in enumerate(extras):
                m = min(len(e["mm_gt"]), max_mmgt)
                mm[i, :m] = e["mm_gt"][:m]
                mask[i, :m] = True
            out["mm_gt"] = mm
        out["mm_mask"] = mask
    out["segment_idx"] = np.asarray([e["segment_idx"] for e in extras])
    out["metadata"] = [e["metadata"] for e in extras]
    return out


def prefetch_iterator(iterable, prefetch: int = 2, device=None):
    """Run the host-side batch construction in a background thread so that
    collate overlaps the device's work.

    With ``device``, the producer also moves the ``DEVICE_KEYS`` arrays of
    each dict item there: on a CUDA device through pinned host memory with
    ``non_blocking`` copies (the pinned buffers' allocator keeps them until
    their copies are done), on the CPU as tensors sharing the arrays'
    memory."""
    import queue
    import threading

    device = None if device is None else torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()

    def to_device(value: np.ndarray) -> torch.Tensor:
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            return tensor.pin_memory().to(device, non_blocking=True)
        return tensor

    def ship(item):
        if device is None or not isinstance(item, dict):
            return item
        return {k: to_device(v) if k in DEVICE_KEYS and isinstance(v, np.ndarray) else v
                for k, v in item.items()}

    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(ship(item)):
                    return
        except BaseException as e:  # propagate to the consumer — a swallowed
            # producer error would look like a clean (truncated!) epoch end
            put(("__prefetch_error__", e))
            return
        put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        # consumer stopped early (break / GeneratorExit): halt the producer
        # so it neither draws further dataset-RNG state nor keeps device
        # buffers pinned in the queue
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


def bounded_batches(loader, n: Optional[int]):
    """At most ``n`` batches (``None``: one pass);
    ``skeletondiffusion_tpu/data/batch.py:251``.  A training loop bounds the
    iterable before ``prefetch_iterator`` instead of breaking out of it: a
    break leaves the producer having drawn a timing-dependent number of
    further batches (and dataset RNG values), which breaks a bit-faithful
    resume."""
    return iter(loader) if n is None else itertools.islice(iter(loader), n)


def cycled_batches(loader, n: Optional[int]):
    """Exactly ``n`` batches, restarting the loader when it runs dry (ignite's
    ``epoch_length``, which the reference's trainers pass as
    ``num_iter_perepoch``); ``skeletondiffusion_tpu/data/batch.py:261``.
    Each restart is a fresh ``DataLoader`` pass (re-shuffled from its
    checkpointed RNG), so a resume stays bit-faithful.  ``n=None`` is one
    pass; an empty loader raises ``ValueError``."""
    if n is None:
        yield from loader
        return
    count = 0
    while count < n:
        empty = True
        for b in loader:
            empty = False
            yield b
            count += 1
            if count >= n:
                return
        if empty:
            raise ValueError("cycled_batches: empty loader")


class DataLoader:
    """Minimal epoch iterator: shuffle, batch, collate, optional pad-to-full
    final batch (one shape for the whole split).  With the preprocessing on
    the device the host work is numpy slicing, so it needs no worker
    processes."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = False,
        seed: int = 0,
        dedup_mm: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.dedup_mm = dedup_mm
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def state_dict(self) -> Dict:
        """Checkpointable shuffle-RNG + epoch counter so a resumed run
        reproduces an uninterrupted one bit-for-bit (reference checkpoints
        full RNG state, `src/utils/reproducibility.py:47-79`)."""
        return {"rng": self._rng.bit_generator.state, "epoch": self._epoch}

    def load_state_dict(self, state: Dict):
        self._rng.bit_generator.state = state["rng"]
        self._epoch = int(state["epoch"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        max_m = getattr(self.dataset, "max_mmgt_count", 0)
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            real_count = len(idx)
            if real_count < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    # pad rows come from a dedicated RNG (derived from seed +
                    # epoch, not the shuffle stream) so pad identity cannot
                    # perturb shuffle state across epochs
                    pad_rng = np.random.default_rng((self._seed, self._epoch))
                    pad = pad_rng.choice(order, self.batch_size - real_count)
                    idx = np.concatenate([idx, pad])
            items = [self.dataset[int(i)] for i in idx]
            batch = collate(
                items, max_mmgt=max_m, dedup_mm=self.dedup_mm,
                mm_fetch=(getattr(self.dataset, "future_of_segment", None)
                          if self.dedup_mm else None))
            # number of REAL (non-pad) items: consumers mask accumulator
            # updates on the padded final batch with this
            batch["_count"] = np.asarray(real_count)
            yield batch
