"""Builds ``skeletondiffusion_tpu_torch/csrc/*.cu`` with ``nvcc`` into one
shared library per source, with a plain C interface, and loads them with
``ctypes``.

The libraries go to ``build/torch_kernels/<hash of sources and flags>/`` beside
the package (``.gitignore`` lists ``build/``).  Missing libraries are built
together at first use, one ``nvcc`` process per source started at once; no
PyTorch headers are compiled, so a build takes seconds.  ``nvcc``'s ``-Xptxas
-v`` report (registers, shared memory, spills) is kept next to each library
as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """Directory named by a hash of the flags and every source's name and bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def compile_sources(srcs: List[Path], out_dir: Path) -> float:
    """nvcc each source into ``out_dir/lib<stem>.so``, all at once; returns
    the seconds taken.  Each source's compiler output goes to
    ``out_dir/<stem>.log``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    start = time.perf_counter()
    jobs = []
    for src in srcs:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{src.stem}.log", "w")
        proc = subprocess.Popen([compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, tmp, log, proc))
    failed = []
    for src, tmp, log, proc in jobs:
        try:
            proc.wait(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode == 0:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
        else:
            failed.append(f"{src.name}:\n{(out_dir / f'{src.stem}.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - start


def build_all() -> float:
    """Build every library that is missing; returns the seconds taken (0.0
    when nothing was missing)."""
    missing = [src for src in sources() if not library_path(src.stem).is_file()]
    return compile_sources(missing, build_dir()) if missing else 0.0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} kernel needs a CUDA device; none is available")
    with _lock:
        if name not in _libraries:
            build_all()
            _libraries[name] = ctypes.CDLL(str(library_path(name)))
        return _libraries[name]


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v lines for ``csrc/<name>.cu`` (empty before a build)."""
    log = build_dir() / f"{name}.log"
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


def check_kernel_inputs(kernel: str, shapes: Dict[str, tuple], **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32, contiguous, of its expected shape
    and needs no gradient (the kernels are forward-only)."""
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{kernel}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {key} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{kernel}: the kernel is forward-only; {key} requires grad")


def check_status(kernel: str, status: int) -> None:
    """Raise unless a C entry returned cudaSuccess (0).  The entries return
    cudaErrorInvalidValue (1) for shapes their source does not instantiate,
    so ``kernel`` names the shapes of the call."""
    if status != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {status}")
