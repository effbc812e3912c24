"""The port stands alone: ``skeletondiffusion_tpu_torch`` (its training
modules under ``train/``, its entry points under ``cli/``, ``inference.py``,
the ``utils/`` modules and the diffusion variants' modules included),
``chip_smoke.py`` and the port's scripts (``scripts/torch_*.py``) import
neither ``jax`` nor ``skeletondiffusion_tpu``, nor ``flax``, ``optax``,
``orbax``, ``pandas`` or ``yaml``, which the card's machine does not have,
and ``chip_smoke.py`` refuses to report a result without a CUDA device or
without the rest of the repository."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "skeletondiffusion_tpu_torch"

CHECK = """
import importlib, pkgutil, sys
import skeletondiffusion_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
train = {"checkpoint", "ema", "schedulers", "trainer_autoencoder", "trainer_diffusion"}
assert all(f"{pkg.__name__}.train.{m}" in sys.modules for m in train), train
entry = {"cli.common", "cli.eval", "cli.train_autoencoder", "cli.train_diffusion", "inference",
         "utils.config", "utils.yaml_lite", "utils.logging", "utils.store", "utils.debug",
         "utils.torch_port"}
assert all(f"{pkg.__name__}.{m}" in sys.modules for m in entry), entry
variants = {"diffusion.process": "IsotropicProcess", "diffusion.engine": "posterior_update_plain",
            "models.autoencoder": "Decoder", "models.denoiser": "Denoiser"}
assert all(hasattr(sys.modules[f"{pkg.__name__}.{m}"], n) for m, n in variants.items()), variants
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print("clean")
"""
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml", "skeletondiffusion_tpu")
CHECK = f"FORBIDDEN = {FORBIDDEN!r}\n" + CHECK


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_point_modules_are_checked():
    """The statement check below walks the entry points and the YAML reader
    that stands in for PyYAML."""
    assert {"common.py", "eval.py", "train_autoencoder.py", "train_diffusion.py"} <= {
        p.name for p in (PACKAGE / "cli").glob("*.py")}
    assert {"config.py", "yaml_lite.py", "logging.py", "store.py", "debug.py",
            "torch_port.py"} <= {p.name for p in (PACKAGE / "utils").glob("*.py")}
    assert (PACKAGE / "inference.py").exists()


def test_train_modules_are_checked():
    """The statement check below walks the training modules too."""
    names = {p.name for p in (PACKAGE / "train").glob("*.py")}
    assert {"checkpoint.py", "ema.py", "schedulers.py", "trainer_autoencoder.py",
            "trainer_diffusion.py"} <= names
    assert (PACKAGE / "utils" / "reproducibility.py").exists()


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py",
                                                  *(REPO / "scripts").glob("torch_*.py")]))
def test_no_jax_import_statement(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
