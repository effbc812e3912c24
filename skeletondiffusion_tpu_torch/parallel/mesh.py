"""The data axis over ``torch.distributed``.

Port of ``skeletondiffusion_tpu/parallel/mesh.py``.  The JAX package builds
a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here each rank
is a process (``torchrun --nproc_per_node=<n>``, or ``dryrun.run_ranks``)
that holds the whole model, takes its rows of every batch (``shard_batch``)
and combines what the ranks computed by hand:

* training: the gradients are all-reduced to their mean before clipping
  (``all_reduce_mean``), so every rank takes the step of the whole batch;
* evaluation: each rank draws the whole batch's sampler noise and keeps its
  rows, and the per-item metric values are gathered on the host
  (``all_gather_host``), so that every rank's accumulators see the batch in
  dataset order (APDE reads its ground truth by position; CMD and FID keep
  per-item arrays);
* weights: ``replicate`` broadcasts rank 0's.

The process group is gloo's: it all-reduces and broadcasts CUDA tensors
(through the host), and it runs two ranks on one card, which NCCL refuses.
Only ``all_reduce`` and ``broadcast`` touch CUDA tensors; host values are
gathered as Python objects.  The model axis (the JAX package's
``shard_params_model_axis``, tensor-parallel weight banks) is not ported:
``create_mesh`` raises for ``model_parallel > 1`` (``TENSOR_PARALLEL``).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

TENSOR_PARALLEL = ("the model axis (tensor-parallel weight banks, the JAX package's "
                   "shard_params_model_axis) is not ported: ROADMAP.md Queue A item 9")
BACKEND = "gloo"


def maybe_initialize_distributed(timeout_s: float = 600.0) -> bool:
    """Join the process group that ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    and ``MASTER_PORT`` describe (torchrun sets them) over gloo; a no-op with
    ``WORLD_SIZE`` unset or 1, or once joined.  Returns whether the process
    runs in a group of more than one."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {missing} are not set: launch with torchrun")
    dist.init_process_group(BACKEND, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def coordination_barrier() -> None:
    """Wait for every rank (``dist.barrier``); a no-op in one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@dataclass(frozen=True)
class DataMesh:
    """A data axis of ``size`` ranks: this process is ``rank`` and runs on
    ``device``."""
    size: int
    rank: int
    device: torch.device

    def rows(self, batch: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a batch of ``batch`` rows."""
        if batch % self.size:
            raise ValueError(f"a batch of {batch} rows does not split over the data axis of "
                             f"{self.size}")
        per = batch // self.size
        return self.rank * per, (self.rank + 1) * per


def _rank_device(device) -> torch.device:
    """A rank's device: the CPU, or the card ``LOCAL_RANK`` modulo the cards
    (two ranks on one card share it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA data axis needs a CUDA device; none is available")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
                        % torch.cuda.device_count())


def create_mesh(n_devices: int = None, model_parallel: int = 1,
                device="cuda") -> DataMesh:
    """The data axis over the process group's ranks (``n_devices`` of them:
    the group's size; one process is an axis of one).  ``model_parallel``
    above 1 raises (``TENSOR_PARALLEL``)."""
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: {TENSOR_PARALLEL}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"a data axis of {n} needs {n} processes, this run has {world}: launch "
                         f"with torchrun --nproc_per_node={n}")
    return DataMesh(n, dist.get_rank() if dist.is_initialized() else 0, _rank_device(device))


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: DataMesh, tree: Any) -> Any:
    """Each tensor of ``tree`` (a tensor, dict, list or tuple) cut to this
    rank's rows of its first axis; other leaves as they are."""
    def rows(t: torch.Tensor) -> torch.Tensor:
        lo, hi = mesh.rows(t.shape[0])
        return t[lo:hi]
    return _map(rows, tree)


def replicate(mesh: DataMesh, tree: Any) -> Any:
    """Rank 0's values on every rank: a module's parameters and buffers, or
    the tensors of ``tree``, broadcast in place; returns ``tree``."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            with torch.no_grad():
                dist.broadcast(t.data, src=0)
        return tree
    return _map(lambda t: dist.broadcast(t, src=0) or t, tree)


def all_reduce_mean(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over the ranks: one
    all-reduce of the tensors flattened together a dtype."""
    if mesh.size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= mesh.size
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_host(mesh: DataMesh, obj: Any) -> List[Any]:
    """Every rank's ``obj`` (host values: numpy arrays, numbers), in rank
    order, on every rank."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out
