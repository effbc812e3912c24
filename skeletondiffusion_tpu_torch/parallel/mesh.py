"""The data and model axes over ``torch.distributed``.

Port of ``skeletondiffusion_tpu/parallel/mesh.py``.  The JAX package builds
a ``jax.sharding.Mesh`` of (data × model) devices and lets GSPMD insert the
collectives; here each rank is a process (``torchrun --nproc_per_node=<n>``,
or ``dryrun.run_ranks``) and the collectives are written out.  Ranks form a
(n/m) × m grid as the JAX mesh's ``reshape(n // m, m)``: rank r is data
index r // m and model index r % m, with a process group per axis.

The data axis: each rank takes its rows of every batch (``shard_batch``)
and combines what the ranks computed by hand:

* training: the gradients are all-reduced to their mean over the data axis
  before clipping (``all_reduce_mean``), so every rank takes the step of
  the whole batch;
* evaluation: each rank draws the whole batch's sampler noise and keeps its
  rows, and the per-item metric values are gathered on the host
  (``all_gather_host``), so that every rank's accumulators see the batch in
  dataset order (APDE reads its ground truth by position; CMD and FID keep
  per-item arrays);
* weights: ``replicate`` broadcasts rank 0's.

The model axis (the JAX package's ``shard_params_model_axis``, training
only): ``shard_params_model_axis`` keeps on each rank its slice of the
output features of every large weight (the JAX rule), and the modules that
hold a slice compute the same function as with the whole weight
(``model_columns`` at the graph-linear banks' and dense layers' products:
the output columns gathered over the model axis, the input's partial
gradient summed over it; ``model_whole`` for the biases).  The optimizer and
the EMA act on the slices, and ``clip_grad_norm_`` reads the global norm.
The ranks of a model group see the same rows.  Inference, serving and the
fused kernels stay on the data axis: a model axis there raises
(``MODEL_AXIS_TRAINING_ONLY``).

The process group is gloo's: it all-reduces and broadcasts CUDA tensors
(through the host), and it runs two ranks on one card, which NCCL refuses.
Only ``all_reduce`` and ``broadcast`` touch CUDA tensors (a gather is an
all-reduce of each rank's slice in its own slot, zeros elsewhere: adding
zeros is exact); host values are gathered as Python objects.
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MODEL_AXIS_TRAINING_ONLY = ("the model axis (shard_params_model_axis) is for training, as the "
                            "JAX package's: inference, serving and the fused kernels take whole "
                            "weights over the data axis")
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
    """A data axis of ``size`` ranks (this process is data index ``rank``)
    on ``device``, and a model axis of ``model`` ranks (this process is
    model index ``model_rank``); the axes' process groups (None: the whole
    group, or no model axis)."""
    size: int
    rank: int
    device: torch.device
    model: int = 1
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def first(self) -> bool:
        """Whether this process is the mesh's first rank (data and model
        index 0): the one that writes and prints."""
        return self.rank == 0 and self.model_rank == 0

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
    """The (n/m) data × m model mesh over the process group's ranks
    (``n_devices`` of them: the group's size; one process is a mesh of one),
    m = ``model_parallel``, which must divide n; with m > 1 a process group
    for each data and each model axis (every rank takes part in each
    ``new_group``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide a mesh of {n} devices")
    if n != world:
        raise ValueError(f"a mesh of {n} needs {n} processes, this run has {world}: launch "
                         f"with torchrun --nproc_per_node={n}")
    rank, m = dist.get_rank() if dist.is_initialized() else 0, model_parallel
    if m == 1:
        return DataMesh(n, rank, _rank_device(device))
    data_groups = [dist.new_group([d * m + j for d in range(n // m)]) for j in range(m)]
    model_groups = [dist.new_group([d * m + j for j in range(m)]) for d in range(n // m)]
    return DataMesh(n // m, rank // m, _rank_device(device), m, rank % m,
                    data_groups[rank % m], model_groups[rank // m])


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
    """Each tensor replaced in place by its mean over the data axis: one
    all-reduce of the tensors flattened together a dtype."""
    if mesh.size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.data_group)
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


def refuse_model_axis(mesh: Optional[DataMesh], what: str) -> None:
    """Raise NotImplementedError naming ``what`` when ``mesh`` has a model
    axis (``MODEL_AXIS_TRAINING_ONLY``)."""
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(f"{what} on a mesh with a model axis of {mesh.model}: "
                                  f"{MODEL_AXIS_TRAINING_ONLY}")


# ---- the model axis ------------------------------------------------------------

class ModelShard(NamedTuple):
    """A parameter's slice of its last (output-feature) dimension: this
    rank's ``rank``-th of ``size`` equal slices over the model axis's
    process group ``group``."""
    size: int
    rank: int
    group: Any

    def __deepcopy__(self, memo):
        # immutable, and a process group cannot be copied: a deep copy of a
        # sharded module (the EMA) shares its shards
        return self


def splits_on_model_axis(shape: Sequence[int], model: int, min_size: int = 2**16) -> bool:
    """The JAX package's rule (``shard_params_model_axis``): a weight of
    ndim ≥ 2 with at least ``min_size`` elements whose last dimension
    ``model`` divides is split over the model axis; the rest is replicated."""
    return (model > 1 and len(shape) >= 2 and math.prod(shape) >= min_size
            and shape[-1] % model == 0)


def shard_params_model_axis(mesh: DataMesh, module: torch.nn.Module,
                            min_size: int = 2**16) -> Dict[str, Tuple[int, ...]]:
    """Keep this rank's slice of the output features of every parameter of
    ``module`` that ``splits_on_model_axis`` splits (in place; the modules
    that hold them record it in ``_model_shards``, which ``model_columns``
    and ``model_whole`` read).  Call it after ``replicate`` and before the
    optimizer's first step.  Returns {name: whole shape} of the split ones."""
    split = {}
    if mesh.model == 1:
        return split
    for mod_name, mod in module.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not splits_on_model_axis(tuple(p.shape), mesh.model, min_size):
                continue
            width = p.shape[-1] // mesh.model
            lo = mesh.model_rank * width
            split[f"{mod_name}.{name}" if mod_name else name] = tuple(p.shape)
            with torch.no_grad():
                p.data = p.data[..., lo:lo + width].contiguous()
            # on the module (a deep copy keeps it) and on the parameter (for the norm)
            p.model_shard = ModelShard(mesh.model, mesh.model_rank, mesh.model_group)
            mod.__dict__.setdefault("_model_shards", {})[name] = p.model_shard
    return split


def model_shard(module: torch.nn.Module, name: str) -> Optional[ModelShard]:
    """The slice ``module``'s parameter ``name`` holds, or None."""
    return getattr(module, "_model_shards", {}).get(name)


def gather_columns(local: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The whole last dimension from every rank's slice of it: an all-reduce
    of each slice in its own slot, zeros elsewhere, in fp32 (exact)."""
    width = local.shape[-1]
    full = local.new_zeros((*local.shape[:-1], width * shard.size), dtype=torch.float32)
    full[..., shard.rank * width:(shard.rank + 1) * width] = local
    dist.all_reduce(full, group=shard.group)
    return full.to(local.dtype)


class _GatherColumns(torch.autograd.Function):
    """Forward: the slices gathered; backward: this rank's slice of the
    gradient (every rank of the model group holds the whole one)."""

    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard, ctx.width = shard, local.shape[-1]
        return gather_columns(local, shard)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.shard.rank * ctx.width
        return grad[..., lo:lo + ctx.width], None


class _SumInputGradients(torch.autograd.Function):
    """Forward: the input as it is; backward: its partial gradients (each
    rank's slice of the columns contributes one) summed over the model axis."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().contiguous()
        dist.all_reduce(total, group=ctx.shard.group)
        return total.to(grad.dtype), None


def model_columns(module: torch.nn.Module, name: str, x: torch.Tensor,
                  product: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``product(x)`` (x times ``module``'s weight ``name``, output features
    last) as with the whole weight: with a slice of it, this rank's columns
    of the product gathered over the model axis, and x's gradient summed
    over it."""
    shard = model_shard(module, name)
    if shard is None:
        return product(x)
    return _GatherColumns.apply(product(_SumInputGradients.apply(x, shard)), shard)


def model_whole(module: torch.nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered over the model axis
    when this rank holds a slice (its gradient is this rank's slice)."""
    p = getattr(module, name)
    shard = model_shard(module, name)
    return p if shard is None else _GatherColumns.apply(p, shard)


def clip_grad_norm_(mesh: Optional[DataMesh], params: Sequence[torch.nn.Parameter],
                    max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over the whole model: on a model
    axis the global norm's square sums the replicated gradients once and
    the slices' over the model axis."""
    if mesh is None or mesh.model == 1:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    sq = [torch.zeros((), device=params[0].grad.device) for _ in range(2)]
    for p in params:  # [replicated, sliced]
        i = int(getattr(p, "model_shard", None) is not None)
        sq[i] = sq[i] + p.grad.float().pow(2).sum()
    dist.all_reduce(sq[1], group=mesh.model_group)
    total = (sq[0] + sq[1]).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef.to(p.grad.dtype))
    return total
