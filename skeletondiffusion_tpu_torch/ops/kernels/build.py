"""Builds ``skeletondiffusion_tpu_torch/csrc/*.cu`` with ``nvcc`` into one
shared library per source and skeleton node count, with a plain C interface,
and loads them with ``ctypes``.

The node count is a build parameter of every kernel (``-DSKD_NODES=<n>``,
read by ``csrc/node_mix.cuh``): 16 for H36M, 17 for FreeMan, 21 for AMASS and
3DPW, 51 for AMASS-MANO.  A library takes its own count only.  The libraries go to
``build/torch_kernels/<hash of sources and flags>-n<nodes>/`` beside the
package (``.gitignore`` lists ``build/``).  Missing libraries are built
together at first use of a node count, one ``nvcc`` process per source
started at once (``build_all`` takes several counts in one go); no PyTorch
headers are compiled, so a build takes seconds.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept next to each library as
``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Tuple, Union

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 600

# The skeletons' node counts: the AMASS body (and 3DPW) without its hip, the
# default.  The libraries build for 2 to MAX_NODES (AMASS-MANO's 51: a node
# mix of up to four m16 tiles, up to two query joints a lane); whether a
# launch fits shared memory is its plan's to say, and a plan that does not
# fit raises (at F = 192 the bf16 plans fit every count; the fp32 engine's
# refuse 51, ROADMAP Queue B item 10).  Up to NARROW_NODES the kernels keep
# the tiles of their 21-node designs; past it they take AMASS-MANO's
# (``csrc/node_mix.cuh::kWide``).
DEFAULT_NODES = 21
MAX_NODES = 51
NARROW_NODES = 21
# sources whose kernels are laid out for fewer counts: the bf16 rollout (B8)
# and the feature-major attention core (L1) at 21 only
NODE_RANGE = {"gru_rollout_merged": (21, 21), "attention_core_fm": (21, 21)}
MORE_NODES = "no skeleton of the reference has more than 51 nodes: ROADMAP.md Queue B item 9"

_lock = threading.Lock()
_libraries: Dict[Tuple[str, int], ctypes.CDLL] = {}


def sources() -> List[Path]:
    """The kernel sources, one library each (headers ``*.cuh`` are included)."""
    return sorted(CSRC_DIR.glob("*.cu"))


def wide(nodes: int) -> bool:
    """Whether the kernels take AMASS-MANO's tiles at ``nodes`` nodes (past
    NARROW_NODES)."""
    return nodes > NARROW_NODES


def node_range(name: str) -> Tuple[int, int]:
    """The node counts ``csrc/<name>.cu`` is built for, lowest and highest."""
    return NODE_RANGE.get(name, (2, MAX_NODES))


def check_nodes(kernel: str, name: str, nodes: int) -> None:
    """Raise ValueError unless the kernels of ``csrc/<name>.cu`` take
    ``nodes`` nodes (the message names the ROADMAP item of larger counts)."""
    lo, hi = node_range(name)
    if not lo <= nodes <= hi:
        # B8 and L1 stay at the AMASS count; the others take every skeleton's
        later = "ROADMAP.md Queue B item 9" if lo == hi else MORE_NODES
        counts = f"{lo}" if lo == hi else f"{lo} to {hi}"
        raise ValueError(f"{kernel}: the kernel takes {counts} nodes, got {nodes} ({later})")


def sources_for(nodes: int) -> List[Path]:
    """The sources built at ``nodes`` nodes."""
    return [src for src in sources()
            if node_range(src.stem)[0] <= nodes <= node_range(src.stem)[1]]


def build_dir(nodes: int = DEFAULT_NODES) -> Path:
    """Directory named by a hash of the flags and every source's name and
    bytes, and by the node count."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / f"{digest.hexdigest()[:16]}-n{nodes}"


def library_path(name: str, nodes: int = DEFAULT_NODES) -> Path:
    return build_dir(nodes) / f"lib{name}.so"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def compile_sources(srcs: List[Path], out_dir: Path, nodes: int = DEFAULT_NODES) -> float:
    """nvcc each source into ``out_dir/lib<stem>.so`` at ``nodes`` nodes,
    all at once; returns the seconds taken.  Each source's compiler output
    goes to ``out_dir/<stem>.log``."""
    return compile_jobs([(src, out_dir, nodes) for src in srcs])


def compile_jobs(jobs_in: Iterable[Tuple[Path, Path, int]]) -> float:
    """nvcc every (source, output directory, node count) at once."""
    compiler = nvcc()
    start = time.perf_counter()
    jobs = []
    for src, out_dir, nodes in jobs_in:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{src.stem}.log", "w")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, f"-DSKD_NODES={nodes}", "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, out_dir, nodes, tmp, log, proc))
    failed = []
    for src, out_dir, nodes, tmp, log, proc in jobs:
        try:
            proc.wait(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode == 0:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
        else:
            failed.append(f"{src.name} at {nodes} nodes:\n"
                          f"{(out_dir / f'{src.stem}.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - start


def build_all(node_counts: Iterable[int] = (DEFAULT_NODES,)) -> float:
    """Build every library of each node count that is missing, all at once;
    returns the seconds taken (0.0 when nothing was missing)."""
    missing = [(src, build_dir(n), n) for n in node_counts for src in sources_for(n)
               if not library_path(src.stem, n).is_file()]
    return compile_jobs(missing) if missing else 0.0


def library(name: str, nodes: int = DEFAULT_NODES) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` at ``nodes`` nodes."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} kernel needs a CUDA device; none is available")
    check_nodes(name, name, nodes)
    with _lock:
        if (name, nodes) not in _libraries:
            build_all((nodes,))
            _libraries[(name, nodes)] = ctypes.CDLL(str(library_path(name, nodes)))
        return _libraries[(name, nodes)]


def ptxas_report(name: str, nodes: int = DEFAULT_NODES) -> str:
    """nvcc's -Xptxas -v lines for ``csrc/<name>.cu`` at ``nodes`` nodes
    (empty before a build)."""
    log = build_dir(nodes) / f"{name}.log"
    return log.read_text() if log.is_file() else ""


def kernel_device(**tensors: torch.Tensor) -> str:
    """'cpu' when every tensor lies on the CPU, 'cuda' when every tensor lies
    on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors.values()}
    if devices == {torch.device("cpu")}:
        return "cpu"
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return "cuda"
    raise ValueError(f"kernel inputs must all lie on the CPU or on one CUDA device, got "
                     f"{ {k: str(t.device) for k, t in tensors.items()} }")


def check_kernel_inputs(kernel: str, shapes: Dict[str, tuple],
                        dtypes: Union[torch.dtype, Mapping[str, torch.dtype]],
                        **tensors: torch.Tensor) -> None:
    """Raise unless every tensor has its expected dtype (one for all, or one
    per tensor), is contiguous, of its expected shape and needs no gradient
    (the kernels are forward-only)."""
    for key, t in tensors.items():
        dtype = dtypes if isinstance(dtypes, torch.dtype) else dtypes[key]
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {key} must be {str(dtype).removeprefix('torch.')}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{kernel}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {key} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{kernel}: the kernel is forward-only; {key} requires grad")


def check_aligned(kernel: str, alignment: int, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on an ``alignment``-byte
    boundary (the kernels' vector and tensor-core loads need it)."""
    for key, t in tensors.items():
        if t.data_ptr() % alignment:
            raise ValueError(f"{kernel}: {key} must be {alignment}-byte aligned")


ELEMENT_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def element_suffix(kernel: str, dtype: torch.dtype) -> str:
    """The C entry suffix of the kernels instantiated for both element types."""
    if dtype not in ELEMENT_SUFFIX:
        raise TypeError(f"{kernel}: the kernel is built for bfloat16 and float32, got {dtype}")
    return ELEMENT_SUFFIX[dtype]


@functools.lru_cache(maxsize=None)
def c_entry(name: str, symbol: str, n_pointers: int, n_ints: int, nodes: int = DEFAULT_NODES):
    """The C function ``symbol`` of ``csrc/<name>.cu`` built at ``nodes``
    nodes, taking ``n_pointers`` pointers, ``n_ints`` ints and the stream,
    returning a cudaError."""
    fn = getattr(library(name, nodes), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(kernel: str, status: int) -> None:
    """Raise unless a C entry returned cudaSuccess (0).  The entries return
    cudaErrorInvalidValue (1) for shapes their source does not instantiate,
    so ``kernel`` names the shapes of the call."""
    if status != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {status}")
