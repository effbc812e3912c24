"""Builds ``skeletondiffusion_tpu_torch/csrc/*.cu`` with ``nvcc`` into one
shared library per source and skeleton node count, with a plain C interface,
and loads them with ``ctypes``.

The node count is a build parameter of every kernel (``-DSKD_NODES=<n>``,
read by ``csrc/node_mix.cuh``): 16 for H36M, 17 for FreeMan, 21 for AMASS and
3DPW, 51 for AMASS-MANO.  A library takes its own count only.  The libraries go to
``build/torch_kernels/<hash of sources and flags>-n<nodes>/`` beside the
package (``.gitignore`` lists ``build/``).  The fp32 rollout (HIDDEN_SOURCES)
also takes the decoder's hidden width as one (``-DSKD_HIDDEN=<h>``): at any
width but DEFAULT_HIDDEN it is built alone, into ``…-n<nodes>-h<h>/``.
Missing libraries are built together at first use of a node count, one
``nvcc`` process per source started at once (``build_all`` takes several
counts in one go); no PyTorch headers are compiled, so a build takes
seconds.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept next to each library as
``<name>.log``.

``kernel_op`` registers a kernel entry as a ``torch.library`` custom op in
the ``skd`` namespace, so that ``torch.export`` keeps each launch as one
node of the program it captures (``serving.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Mapping, Tuple, Union

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
MORE_NODES = "no skeleton of the reference has more than 51 nodes: ROADMAP.md Queue B item 9"
# The hidden widths of the sources built for one (HIDDEN_SOURCES): every
# multiple of HIDDEN_STEP up to MAX_HIDDEN; the flagship's DEFAULT_HIDDEN is
# the source's own default, built with every other source.
DEFAULT_HIDDEN = 96
HIDDEN_STEP = 16
MAX_HIDDEN = 128
HIDDEN_SOURCES = ("gru_rollout",)
WIDER = "other widths: ROADMAP.md Queue B item 9"

_lock = threading.Lock()
_libraries: Dict[Tuple[str, int, int], ctypes.CDLL] = {}


def sources() -> List[Path]:
    """The kernel sources, one library each (headers ``*.cuh`` are included)."""
    return sorted(CSRC_DIR.glob("*.cu"))


def wide(nodes: int) -> bool:
    """Whether the kernels take AMASS-MANO's tiles at ``nodes`` nodes (past
    NARROW_NODES)."""
    return nodes > NARROW_NODES


def check_nodes(kernel: str, nodes: int) -> None:
    """Raise ValueError unless the kernels take ``nodes`` nodes (2 to
    MAX_NODES; the message names the ROADMAP item of larger counts)."""
    if not 2 <= nodes <= MAX_NODES:
        raise ValueError(f"{kernel}: the kernel takes 2 to {MAX_NODES} nodes, got {nodes} "
                         f"({MORE_NODES})")


def takes_hidden(hidden: int) -> bool:
    """Whether the sources built for a hidden width take ``hidden``."""
    return hidden % HIDDEN_STEP == 0 and HIDDEN_STEP <= hidden <= MAX_HIDDEN


def check_hidden(kernel: str, hidden: int) -> None:
    """Raise ValueError unless ``kernel`` is built for hidden width
    ``hidden`` (``takes_hidden``; the message names the ROADMAP item of
    other widths)."""
    if not takes_hidden(hidden):
        raise ValueError(f"{kernel}: the kernel takes hidden widths that are multiples of "
                         f"{HIDDEN_STEP} from {HIDDEN_STEP} to {MAX_HIDDEN}, got {hidden} "
                         f"({WIDER})")


def build_dir(nodes: int = DEFAULT_NODES, hidden: int = DEFAULT_HIDDEN) -> Path:
    """Directory named by a hash of the flags and every source's name and
    bytes, and by the node count (and a hidden width other than
    DEFAULT_HIDDEN)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    width = "" if hidden == DEFAULT_HIDDEN else f"-h{hidden}"
    return BUILD_ROOT / f"{digest.hexdigest()[:16]}-n{nodes}{width}"


def library_path(name: str, nodes: int = DEFAULT_NODES, hidden: int = DEFAULT_HIDDEN) -> Path:
    return build_dir(nodes, hidden) / f"lib{name}.so"


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


def compile_jobs(jobs_in: Iterable[Tuple]) -> float:
    """nvcc every (source, output directory, node count[, hidden width]) at
    once."""
    compiler = nvcc()
    start = time.perf_counter()
    jobs = []
    for src, out_dir, nodes, *hidden in jobs_in:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{src.stem}.log", "w")
        width = [f"-DSKD_HIDDEN={hidden[0]}"] if hidden and hidden[0] != DEFAULT_HIDDEN else []
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, f"-DSKD_NODES={nodes}", *width, "-o", str(tmp), str(src)],
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


def build_all(node_counts: Iterable[int] = (DEFAULT_NODES,),
              widths: Iterable[Tuple[int, int]] = ()) -> float:
    """Build every library of each node count that is missing, and the
    HIDDEN_SOURCES at each (node count, hidden width) of ``widths``, all at
    once; returns the seconds taken (0.0 when nothing was missing)."""
    missing = [(src, build_dir(n), n) for n in node_counts for src in sources()
               if not library_path(src.stem, n).is_file()]
    missing += [(src, build_dir(n, h), n, h) for n, h in dict.fromkeys(widths)
                for src in sources() if h != DEFAULT_HIDDEN and src.stem in HIDDEN_SOURCES
                and not library_path(src.stem, n, h).is_file()]
    return compile_jobs(missing) if missing else 0.0


def library(name: str, nodes: int = DEFAULT_NODES,
            hidden: int = DEFAULT_HIDDEN) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` at ``nodes`` nodes
    (and, for HIDDEN_SOURCES, hidden width ``hidden``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} kernel needs a CUDA device; none is available")
    check_nodes(name, nodes)
    if name not in HIDDEN_SOURCES:
        hidden = DEFAULT_HIDDEN
    check_hidden(name, hidden)
    with _lock:
        if (name, nodes, hidden) not in _libraries:
            if hidden == DEFAULT_HIDDEN:
                build_all((nodes,))
            else:
                build_all((), ((nodes, hidden),))
            _libraries[(name, nodes, hidden)] = ctypes.CDLL(str(library_path(name, nodes,
                                                                              hidden)))
        return _libraries[(name, nodes, hidden)]


def ptxas_report(name: str, nodes: int = DEFAULT_NODES, hidden: int = DEFAULT_HIDDEN) -> str:
    """nvcc's -Xptxas -v lines for ``csrc/<name>.cu`` at ``nodes`` nodes
    (and hidden width ``hidden``; empty before a build)."""
    log = build_dir(nodes, hidden) / f"{name}.log"
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
def c_entry(name: str, symbol: str, n_pointers: int, n_ints: int, nodes: int = DEFAULT_NODES,
            hidden: int = DEFAULT_HIDDEN):
    """The C function ``symbol`` of ``csrc/<name>.cu`` built at ``nodes``
    nodes (and hidden width ``hidden``, ``library``), taking ``n_pointers``
    pointers, ``n_ints`` ints and the stream, returning a cudaError."""
    fn = getattr(library(name, nodes, hidden), symbol)
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


OP_NAMESPACE = "skd"


def kernel_op(name: str, schema: str, plain: Callable, launch: Callable, fake: Callable):
    """Register ``skd::<name>`` with ``schema`` (``"(Tensor x, int k) ->
    Tensor"``, every argument positional) and return it: its CPU and CUDA
    implementation runs ``plain`` when every tensor lies on the CPU and
    ``launch`` (the kernel, counted) when they lie on one CUDA device
    (``kernel_device``: mixed devices raise; nothing falls back), and
    ``fake`` gives the output shapes to ``torch.export``'s tracer.  The ops
    have no backward: a backward through one raises."""
    names = re.findall(r"(\w+)\s*(?=[,)])", schema.split("->")[0])

    def impl(*args):
        tensors = {k: a for k, a in zip(names, args) if isinstance(a, torch.Tensor)}
        return plain(*args) if kernel_device(**tensors) == "cpu" else launch(*args)

    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", impl, mutates_args=(),
                                 device_types=("cpu", "cuda"), schema=schema)
    op.register_fake(fake)
    return op


def on_cuda(*args) -> bool:
    """Whether a fake implementation was given tensors on one CUDA device
    (``kernel_device``: mixed devices raise, as the kernel's op does): it
    then runs the launch's shape and plan checks, as the kernel would."""
    tensors = {f"argument {i}": a for i, a in enumerate(args) if isinstance(a, torch.Tensor)}
    return kernel_device(**tensors) == "cuda"


def without_grad(fn: Callable) -> Callable:
    """``fn`` under ``torch.no_grad()`` when gradients are on, as it is when
    they are off (the same result either way).  A prediction that
    ``torch.export`` traces with gradients off (``serving.py``) then holds no
    grad-mode switch, whose removal pass took about a third of an export."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.is_grad_enabled():
            with torch.no_grad():
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper
