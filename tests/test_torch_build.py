"""The port's kernel builder without a CUDA toolkit: it finds nvcc through
CUDA_HOME or PATH (and says so when there is none), names its build
directory by the sources' contents, and runs one compiler process per
source with the documented flags, keeping each one's report."""
import os
import pathlib
import stat

import pytest

from skeletondiffusion_tpu_torch.ops.kernels import build

FAKE_NVCC = """#!/bin/sh
# records its arguments, then writes the file named after -o
printf '%s\\n' "$@" > "$(dirname "$0")/args.$$"
while [ "$#" -gt 1 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
echo "ptxas info    : Used 1 registers"
"""


def _fake_cuda_home(tmp_path: pathlib.Path) -> pathlib.Path:
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_compile_sources_runs_one_nvcc_per_source(tmp_path, monkeypatch):
    home = _fake_cuda_home(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(home))
    srcs = []
    for name in ("a", "b"):
        src = tmp_path / f"{name}.cu"
        src.write_text(f"// {name}\n")
        srcs.append(src)
    out = tmp_path / "out"
    build.compile_sources(srcs, out)
    for name in ("a", "b"):
        assert (out / f"lib{name}.so").read_text() == "lib\n"
        assert "Used 1 registers" in (out / f"{name}.log").read_text()
    calls = [p.read_text().split("\n") for p in (home / "bin").glob("args.*")]
    assert len(calls) == 2
    for args in calls:
        assert args[: len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in args
    assert not list(out.glob("*.tmp"))


def test_build_dir_follows_the_sources(tmp_path, monkeypatch):
    for name in ("x.cu", "y.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.build_dir()
    assert first == build.build_dir()
    (tmp_path / "y.cu").write_text("// changed\n")
    assert build.build_dir() != first
    assert [s.name for s in build.sources()] == ["x.cu", "y.cu"]
    assert os.path.dirname(str(first)) == str(build.BUILD_ROOT)
