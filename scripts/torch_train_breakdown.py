#!/usr/bin/env python3
"""Where a training step's time goes on the card: a step of each stage split
into its parts, and a profiler trace of one step.

    python3 scripts/torch_train_breakdown.py        # one CUDA device

The model, data and trainers are ``chip_smoke.py``'s train phase's (the
flagship at full width, batch 64, the synthetic AMASS train split with the
flagship's augmentations; stage 2 with the bf16 denoiser, k = 50 in input
space).  After two warm-up steps, ``REPEATS`` steps of each stage are run
part by part with the card synchronised between the parts (host clock, ms):

* stage 1 (at the full horizon, 120 frames): the future's encode, the
  differentiable decode, the loss, the backward, the clip and the AdamW
  step;
* stage 2: the frozen AutoEncoder's embeddings, the diffusion forward
  (q_sample and the denoiser over the 3 200 fanned-out rows), the k-best
  choice (its decode on K1 and the comparison), the backward, the clip, the
  Adam step and the EMA.

Then one whole step of each stage under ``torch.profiler``: the device's
kernel time against the step's wall time (busy share) and the kernels by
device time.  Prints one JSON line with the medians.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from skeletondiffusion_tpu_torch.data import DataLoader  # noqa: E402
from skeletondiffusion_tpu_torch.models import AutoEncoder  # noqa: E402
from skeletondiffusion_tpu_torch.models.autoencoder import autoencoder_loss  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import build  # noqa: E402
from skeletondiffusion_tpu_torch.skeleton import create_skeleton  # noqa: E402
from skeletondiffusion_tpu_torch.train.ema import ema_update  # noqa: E402

REPEATS = 3
DEVICE = "cuda"


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class Clock:
    """Host-clock marks with the card synchronised at each."""

    def __init__(self):
        sync()
        self.last, self.parts = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        sync()
        now = time.perf_counter()
        self.parts[name] = 1e3 * (now - self.last)
        self.last = now


def stage1_parts(tr, batch) -> dict:
    x, y = batch
    clock = Clock()
    z = tr.model.encode(y)
    clock.mark("encode future")
    pred = tr.model.decode_with_grad(x, z, cs.PRED_LEN)
    clock.mark("decode (differentiable)")
    loss = autoencoder_loss(pred, y, loss_type=tr.loss_pose_type)
    clock.mark("loss")
    tr.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    clock.mark("backward")
    torch.nn.utils.clip_grad_norm_(list(tr.model.parameters()), tr.clip_grad_norm)
    tr.optimizer.step()
    clock.mark("clip + AdamW")
    return clock.parts


def stage2_parts(tr, batch, gen) -> dict:
    x, y = batch
    clock = Clock()
    z_past, z = tr.embed(x, y)
    clock.mark("embeddings")
    loss, weights, samples = tr.diffusion.loss(z, x_cond=z_past, n_train_samples=tr.k,
                                               generator=gen)
    clock.mark("diffusion forward")
    sim = tr.similarity(samples.detach(), x, y)
    idx = torch.argmin(sim, dim=-1)
    loss = (loss.reshape(-1, tr.k).gather(1, idx[:, None])[:, 0] * weights).mean()
    clock.mark("k-best choice (K1 decode)")
    tr.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    clock.mark("backward")
    torch.nn.utils.clip_grad_norm_(list(tr.denoiser.parameters()), tr.max_grad_norm)
    tr.optimizer.step()
    ema_update(tr.ema, tr.denoiser, **tr.ema_kwargs)
    clock.mark("clip + Adam + EMA")
    return clock.parts


def profile_step(label: str, step) -> dict:
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{label} profiler: device kernel time {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(busy share {busy_ms / wall_ms:.4f}); {launches} kernel launches")
    print(events.table(sort_by="self_device_time_total", row_limit=12, max_name_column_width=70))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernel_launches": launches}


def medians(runs: list) -> dict:
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def main() -> int:
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    skeleton = create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                               num_joints=22, pose_box_size=1.5, obs_length=cs.OBS_LEN,
                               pred_length=cs.PRED_LEN, if_consider_hip=False)
    result = {"card": card}
    with tempfile.TemporaryDirectory() as root:
        dataset = cs.train_split(skeleton, cs.build_synthetic_tree(root))
        loader = DataLoader(dataset, batch_size=cs.TRAIN_BATCH, shuffle=True, drop_last=True,
                            seed=cs.SEED)
        batches = [b for _, _, b in cs.train_batches(skeleton, loader, 1, 2 + REPEATS)]
    ae = AutoEncoder(skeleton.num_nodes, cs.HIDDEN, cs.HIDDEN, cs.LATENT,
                     torch.Generator().manual_seed(cs.SEED),
                     node_types=skeleton.nodes_type_id).to(DEVICE)
    tr1 = cs.make_ae_trainer(ae)
    for batch in batches[:2]:
        tr1.optimizer_step(tr1.loss(*batch, cs.PRED_LEN))
    result["stage1"] = medians([stage1_parts(tr1, b) for b in batches[2:]])
    print(f"stage 1 step at ph {cs.PRED_LEN}, ms (median of {REPEATS}): {result['stage1']}")
    result["stage1_profile"] = profile_step(
        "stage 1", lambda: tr1.optimizer_step(tr1.loss(*batches[0], cs.PRED_LEN)))

    engine, _ = cs.train_denoiser(skeleton, DEVICE, torch.bfloat16)
    tr2 = cs.make_diffusion_trainer(skeleton, engine, ae)
    gen = torch.Generator(device=DEVICE).manual_seed(cs.SEED)
    for batch in batches[:2]:
        tr2.train_step(batch, gen)
    result["stage2"] = medians([stage2_parts(tr2, b, gen) for b in batches[2:]])
    print(f"stage 2 bf16 step, ms (median of {REPEATS}): {result['stage2']}")
    result["stage2_profile"] = profile_step("stage 2", lambda: tr2.train_step(batches[0], gen))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
