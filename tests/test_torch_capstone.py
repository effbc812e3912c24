"""The port's convergence capstone twins against the JAX scripts:

- ``scripts/torch_convergence_capstone.py::analyze`` gives the same checks,
  margins and report as ``scripts/convergence_capstone.py::analyze`` on the
  fabricated good, bad and partial roots of ``tests/test_capstone_analyze.py``
  (the JAX script loaded from its file, as that test loads it);
- the twin's ``--smoke`` run end to end on the CPU, cut to one epoch and one
  iteration a stage, in a process where ``jax`` and ``flax`` cannot be
  imported, writes every key of the JAX report, then the bf16 twin's
  ``--eval-only`` half on its checkpoint, and the report twin renders it;
- ``scripts/torch_bf16_converged_quality.py::delta_table`` equals the JAX
  script's.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
from unittest import mock

import pytest

from test_capstone_analyze import CONFIG, _fabricate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):  # the JAX scripts set environment defaults
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return load("convergence_capstone"), load("torch_convergence_capstone")


def reports(scripts, root, diff_dirs, results, ae_dir):
    return [m.analyze(root, ae_dir, diff_dirs, results, smoke=False, timings={}, config=CONFIG)
            for m in scripts]


def same_evidence(jax_report: dict, torch_report: dict) -> None:
    assert set(torch_report) == set(jax_report)
    for key in jax_report:
        if key != "description":
            assert json.dumps(torch_report[key]) == json.dumps(jax_report[key]), key


@pytest.mark.parametrize("good", [True, False])
def test_analyze_matches_the_jax_script(scripts, tmp_path, good):
    ae_dir, diff_dirs, results = _fabricate(str(tmp_path), good=good)
    jax_report, torch_report = reports(scripts, str(tmp_path), diff_dirs, results, ae_dir)
    same_evidence(jax_report, torch_report)
    assert all(torch_report["checks"].values()) if good else not any(
        torch_report["checks"].values())


def test_analyze_matches_the_jax_script_on_partial_runs(scripts, tmp_path):
    """A variant missing, then nothing after stage 1: the same None checks
    and margins."""
    ae_dir, diff_dirs, results = _fabricate(str(tmp_path), good=True)
    del results["k50_latent"]
    diff_dirs.pop("k50_latent")
    same_evidence(*reports(scripts, str(tmp_path), diff_dirs, results, ae_dir))
    same_evidence(*reports(scripts, str(tmp_path), {}, {}, ae_dir))


def test_kept_checkpoints_reads_the_ports_files(scripts, tmp_path):
    """The port keeps its checkpoints as ``<name>.pt`` files beside an
    index; the JAX layout's directories count too."""
    _, twin = scripts
    for name in ("ckpt_5.pt", "ckpt_10.pt", "latest_10.pt", "index.json"):
        (tmp_path / name).write_text("")
    (tmp_path / "ckpt_3").mkdir()
    assert twin.kept_checkpoints(str(tmp_path)) == ["ckpt_10", "ckpt_3", "ckpt_5", "latest_10"]
    assert twin.kept_checkpoints(str(tmp_path / "missing")) == []


def test_delta_table_matches_the_jax_script():
    jax_mod, twin = load("bf16_converged_quality"), load("torch_bf16_converged_quality")
    a = {"ADE": 0.2917752265930176, "FDE": 0.3836730122566223, "APD": 8.761171340942383,
         "CMD": 0.0, "only_a": 1.0}
    b = {"ADE": 0.2914469540119171, "FDE": 0.3840879499912262, "APD": 8.754274368286133,
         "CMD": 1e-9, "only_b": 2.0}
    assert twin.delta_table(a, b) == jax_mod.delta_table(a, b)
    assert twin.POSITION_METRICS == jax_mod.POSITION_METRICS


BLOCK_JAX = "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; "


def run_blocked(script: str, args: list, cwd) -> subprocess.CompletedProcess:
    """``script`` run as ``__main__`` in a fresh interpreter where importing
    jax or flax raises."""
    code = (BLOCK_JAX + "import runpy; sys.argv = " + repr([script, *args]) +
            f"; runpy.run_path({os.path.join(REPO, 'scripts', script)!r}, run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """The twin's ``--smoke`` run, one epoch and one iteration a stage, in a
    process where jax cannot be imported → (its root, its report's path)."""
    tmp = tmp_path_factory.mktemp("capstone_smoke")
    root, out = tmp / "root", tmp / "torch_convergence.json"
    cut = ["--ae-epochs", "1", "--ae-iters", "1", "--diff-epochs", "1", "--diff-iters", "1",
           "--diff-warmup", "1", "--eval-freq", "1"]
    proc = run_blocked("torch_convergence_capstone.py",
                       ["--smoke", "--root", str(root), "--out-json", str(out), *cut], tmp)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return root, out


def test_smoke_run_writes_the_jax_report_without_jax(scripts, smoke_root, tmp_path):
    root, out = smoke_root
    report = json.loads(out.read_text())
    # every key the JAX script's report has (analyze's, and those bank adds)
    ae_dir, diff_dirs, results = _fabricate(str(tmp_path / "fab"), good=True)
    jax_keys = set(scripts[0].analyze(str(tmp_path), ae_dir, diff_dirs, results, smoke=True,
                                      timings={}, config=CONFIG))
    assert jax_keys | {"last_phase_done", "timings_sec"} <= set(report)
    assert report["last_phase_done"] == "all" and report["smoke"] is True
    assert report["partial_variants_missing"] == [] and report["card"] == "cpu"
    assert set(report["metrics"]) == {"zero_velocity", "k50_motion", "k1", "k50_latent"}
    assert set(report["checks"]) == set(scripts[0].analyze(
        str(tmp_path), ae_dir, diff_dirs, results, smoke=True, timings={},
        config=CONFIG)["checks"])
    assert all(v is not None for v in report["checks"].values())
    assert report["config"]["ae_epochs"] == 1 and report["config"]["diff_sched"] == [
        "model.num_iter_perepoch=1"]
    for phase in ("data", "train_autoencoder", "train_diffusion_k50_motion", "eval_zv", "total"):
        assert report["timings_sec"][phase] >= 0, phase

    bf16_out = tmp_path / "torch_bf16_eval_quality.json"
    proc = run_blocked("torch_bf16_converged_quality.py",
                       ["--smoke", "--eval-only", "--root", str(root), "--out", str(bf16_out)],
                       tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    converged = json.loads(bf16_out.read_text())["converged"]
    assert set(converged["eval_dtype_sensitivity"]) == set(report["metrics"]["k50_motion"])
    assert converged["card"] == "cpu" and "train_dtype_sensitivity" not in converged

    md = tmp_path / "torch_convergence.md"
    proc = run_blocked("torch_convergence_report.py", ["--json", str(out), "--out", str(md)],
                       tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = md.read_text()
    assert "## Timings (cpu)" in text and "flagship/ZV ADE ratio" in text


def test_validation_reading_repeats_the_logged_validation(smoke_root, tmp_path):
    """``scripts/torch_validation_reading.py`` on the smoke run's flagship, on
    the CPU where jax cannot be imported: the training CLI's ``validate``
    on the best checkpoint repeats the ADE the run logged for its epoch bit
    for bit, the plain versions (which the CPU runs anyway) give the same,
    and every path reads a finite ADE on both splits."""
    root, _ = smoke_root
    out = tmp_path / "reading.json"
    proc = run_blocked("torch_validation_reading.py",
                       ["--device", "cpu", "--experiment", str(root / "out_diff_k50_motion"),
                        "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    reading = json.loads(out.read_text())
    valid, test = reading["ade"]["valid"], reading["ade"]["test"]
    assert reading["epoch"] == 1 and reading["card"] == "cpu"
    assert valid["validate"] == valid["logged"] == valid["plain_bf16"]
    assert set(valid) == {"logged", "validate", "plain_bf16", "fp32", "live", "eval_cli",
                          "zero_velocity", "autoencoder"}
    assert set(test) == {"validate", "eval_cli", "zero_velocity", "autoencoder"}
    assert all(math.isfinite(v) and v > 0 for v in [*valid.values(), *test.values()])
    assert reading["valid_datasets"] == ["HumanEva"] and reading["segments"]["valid"] > 0


def test_variants_and_the_merged_report_of_several_runs(scripts, smoke_root, tmp_path):
    """A second run on the smoke run's root with ``--variants k50_motion
    --live-eval`` trains nothing (every phase is done) and adds the eval on
    the flagship's live weights; ``--merge`` of its directory and the smoke
    run's judges the stage files of both as one report: the smoke run's
    checks and metrics, the live eval beside them, which run gave each
    stage."""
    root, out = smoke_root
    single = json.loads(out.read_text())
    second = tmp_path / "second" / "torch_convergence.json"
    proc = run_blocked("torch_convergence_capstone.py",
                       ["--smoke", "--root", str(root), "--out-json", str(second),
                        "--ae-epochs", "1", "--ae-iters", "1", "--diff-epochs", "1",
                        "--diff-iters", "1", "--diff-warmup", "1", "--eval-freq", "1",
                        "--variants", "k50_motion", "--live-eval"], tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "train_diffusion_k50_motion: already done" in proc.stdout
    assert "train_diffusion_k50_latent" not in proc.stdout
    stages = sorted(p.name for p in second.parent.glob("stage_*.json"))
    assert stages == ["stage_autoencoder.json", "stage_k50_motion.json",
                      "stage_zero_velocity.json"]

    merged = tmp_path / "merged.json"
    proc = run_blocked("torch_convergence_capstone.py",
                       ["--merge", str(second.parent), str(out.parent), "--out-json",
                        str(merged)], tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(merged.read_text())
    for key in ("checks", "margins", "metrics", "valid_ade_trajectory_k50_motion",
                "valid_ade_trajectory_autoencoder", "kept_checkpoints_k50_motion",
                "final_lr", "curriculum_ph_max", "config"):
        assert json.dumps(report[key]) == json.dumps(single[key]), key
    live = report["metrics_live"]["k50_motion"]
    assert set(live) == set(report["metrics"]["k50_motion"])
    assert all(math.isfinite(v) for v in live.values())
    assert report["calls"] == {"autoencoder": str(second.parent),
                               "zero_velocity": str(second.parent),
                               "k50_motion": str(second.parent),
                               "k50_latent": str(out.parent), "k1": str(out.parent)}
    assert report["last_phase_done"] == "merged" and report["card"] == "cpu"
    assert report["timings_sec"]["eval_k50_motion_live"] > 0
    # a merge without stage 1 has nothing to judge
    proc = run_blocked("torch_convergence_capstone.py",
                       ["--merge", str(tmp_path / "none"), "--out-json", str(merged)], tmp_path)
    assert proc.returncode != 0


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_stage2_dtype_switch_names_the_variants_and_their_overrides(scripts, dtype):
    """``--stage2-dtype``: bf16 by default, the configs' own dtype and the
    variants' own names; fp32 adds ``model.compute_dtype=null`` to every
    variant's stage-2 overrides and names each ``<variant>_fp32``."""
    cap = scripts[1]
    assert cap.parse_args([]).stage2_dtype == "bf16"
    args = cap.parse_args(["--variants", "k50_motion", "k50_latent", "--stage2-dtype", dtype])
    plan = cap.stage2_variants(args.variants, 50, args.stage2_dtype)
    suffix = "" if dtype == "bf16" else "_fp32"
    assert list(plan) == [f"k50_motion{suffix}", f"k50_latent{suffix}"]
    bf16 = cap.stage2_variants(args.variants, 50, "bf16")
    for name, overrides in plan.items():
        base = bf16[name[:len(name) - len(suffix)]]
        extra = overrides[len(base):]
        assert overrides[:len(base)] == base
        assert extra == ([] if dtype == "bf16" else ["model.compute_dtype=null"])
        assert not any("compute_dtype" in o for o in base)
    with pytest.raises(SystemExit):
        cap.parse_args(["--stage2-dtype", "fp16"])


def test_dtype_reading_reads_check_b_in_each_dtype(scripts):
    """``dtype_reading`` of a merge's stage files: check (b)'s first leg on
    the EMA and live weights for each dtype whose pair is there."""
    cap = scripts[1]

    def stage(ema, live=None):
        s = {"metrics": {"APD": ema, "ADE": 0.5}}
        if live is not None:
            s["metrics_live"] = {"APD": live, "ADE": 0.5}
        return s

    reading = cap.dtype_reading({
        "k50_motion": stage(8.0, 9.0), "k50_latent": stage(10.0, 8.0),
        "k50_motion_fp32": stage(11.0), "k50_latent_fp32": stage(10.0), "k1": stage(1.0)})
    assert reading["bf16"]["ema"] == {"apd_motion": 8.0, "apd_latent": 10.0, "ratio": 0.8,
                                      "passes": False, "ade_motion": 0.5, "ade_latent": 0.5}
    assert reading["bf16"]["live"]["passes"] is True
    assert reading["fp32"] == {"ema": {"apd_motion": 11.0, "apd_latent": 10.0, "ratio": 1.1,
                                       "passes": True, "ade_motion": 0.5, "ade_latent": 0.5}}
    assert cap.dtype_reading({"k50_motion": stage(1.0)}) == {}
