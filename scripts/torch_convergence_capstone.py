"""Convergence capstone of the PyTorch port: train the two-stage flagship to
a good model on synthetic motion data, through the port's own CLIs.

A twin of ``scripts/convergence_capstone.py`` with the same phases, shapes,
schedules, overrides, checks, margins and JSON keys.  It builds the
procedural rigid-skeleton motion tree with the port's
``skeletondiffusion_tpu_torch.data.synthetic.make_synthetic_amass_motion``,
drives ``cli.train_autoencoder``, ``cli.train_diffusion`` and ``cli.eval``
in-process through their ``main(argv)``, and judges:

  (a) the flagship (k=50 motion-argmin) beats the ZeroVelocity baseline's
      min-ADE/FDE by a wide margin (< 0.6×) on the same test split,
  (b) APD(k=50 motion-argmin) > APD(k=50 latent-argmin) > APD(k=1),
  (c) EMA validation ADE improves across epochs, with top-k checkpoint
      rotation on real validation scores,
  (d) the LR scheduler reaches its min-lr floor and the prediction-horizon
      curriculum fully anneals.

Output: ``docs/torch_convergence.json`` (``--out-json``), rewritten after
every phase, with the card's name and power limit beside the timings.
Resumable: each phase writes a completion marker and is skipped when done,
and a phase cut by ``timeout`` resumes from its latest checkpoint.  Each
phase's seconds are summed over the runs that worked on it (files under
``<root>/timings``), so a schedule run across several calls reports its
whole cost.
Exits 1 when a judged check fails (``main`` returns the report; the exit
code is ``verdict``'s).

A schedule too long for one process or one call runs in parts:
``--variants`` picks the stage-2 variants a run trains (none: stage 1 and
the ZeroVelocity eval only), ``--live-eval`` also evaluates each variant on
its live weights beside the EMA weights the checks read, and every finished
stage leaves a small file beside ``--out-json`` (``stage_<name>.json``: its
metrics, validation curve, LR, checkpoints and seconds) that travels back
with its call.  ``--merge DIR …`` judges the stage files of several runs
(the first directory that has a stage gives it) as one report at ``--out-json``.

Run (one CUDA device; raises without one):
    python3 scripts/torch_convergence_capstone.py [--ae-epochs … overrides]
Smoke (CPU, small shapes):
    python3 scripts/torch_convergence_capstone.py --smoke
Two variants at once on one card, then one report:
    python3 scripts/torch_convergence_capstone.py --variants --out-json o/s1/r.json …
    python3 scripts/torch_convergence_capstone.py --variants k50_motion --live-eval \
        --out-json o/k50_motion/r.json … &   (and k50_latent into o/k50_latent)
    python3 scripts/torch_convergence_capstone.py --merge o/s1 o/k50_motion o/k50_latent \
        --out-json o/torch_convergence.json
``--stage2-dtype fp32`` trains the variants of a run with an fp32 stage 2
(``model.compute_dtype=null``), named ``<variant>_fp32``; a merge of both
dtypes' runs reads check (b)'s first leg in each (``stage2_dtype``).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def marker(path: str) -> str:
    return os.path.join(path, "CAPSTONE_DONE")


def done(path: str) -> bool:
    return os.path.exists(marker(path))


def mark(path: str):
    with open(marker(path), "w") as f:
        f.write(time.strftime("%Y-%m-%dT%H:%M:%S"))


def read_jsonl(path: str):
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def resume_flag(out_dir: str) -> list:
    """Within-phase resume: a prior (interrupted) run of this phase that left
    a latest checkpoint restarts the trainer from its epoch.  The trainers'
    resume is bit-faithful (generators, loader order, LR scheduler, step
    counter)."""
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if os.path.isdir(ckpt_dir) and any(d.startswith("latest_") for d in os.listdir(ckpt_dir)):
        return ["model.if_resume_training=True"]
    return []


def kept_checkpoints(ckpt_dir: str) -> list:
    """The checkpoints kept in ``ckpt_dir``: the port's ``<name>.pt`` files
    (a directory each in the JAX package's layout counts too)."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = []
    for d in os.listdir(ckpt_dir):
        if os.path.isdir(os.path.join(ckpt_dir, d)):
            names.append(d)
        elif d.endswith(".pt"):
            names.append(d[:-len(".pt")])
    return sorted(names)


def read_seconds(path: str) -> float:
    if not os.path.exists(path):
        return 0.0
    with open(path) as f:
        return float(f.read())


def spend(root: str, name: str, seconds: float) -> float:
    """Add ``seconds`` to phase ``name``'s total over every run (a file a
    phase, so that processes that run at once never write the same file);
    returns the total."""
    os.makedirs(os.path.join(root, "timings"), exist_ok=True)
    path = os.path.join(root, "timings", name)
    total = seconds + read_seconds(path)
    with open(path, "w") as f:
        f.write(repr(total))
    return total


def spent(root: str) -> dict:
    """Every phase's seconds over all runs, as ``spend`` summed them."""
    directory = os.path.join(root, "timings")
    if not os.path.isdir(directory):
        return {}
    return {name: round(read_seconds(os.path.join(directory, name)), 1)
            for name in sorted(os.listdir(directory))}


def run_phase(root: str, name: str, out_dir: str, fn):
    if done(out_dir):
        print(f"[capstone] {name}: already done, skipping")
        return
    print(f"[capstone] {name}: starting", flush=True)
    t0 = time.time()
    try:
        fn()
    finally:  # a phase cut by `timeout` (SIGTERM, see __main__) counts its seconds too
        total = spend(root, name, time.time() - t0)
    mark(out_dir)
    print(f"[capstone] {name}: done, {total:.1f} s over every run", flush=True)


def card_line(smoke: bool) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for
    the smoke run)."""
    if smoke:
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# the stage-2 variants in training order: the flagship first (checks (a),
# (c) and (d) rest on it alone), then the two legs of check (b)'s first
# comparison, then k1
VARIANTS = ("k50_motion", "k50_latent", "k1")

# the stage-2 training dtypes (``--stage2-dtype``) and their CLI overrides:
# bf16 is the configs' own (model.compute_dtype: bfloat16), fp32 trains the
# networks without a compute dtype; the evals take the eval config's either way
STAGE2_DTYPES = {"bf16": [], "fp32": ["model.compute_dtype=null"]}


def variant_name(name: str, dtype: str) -> str:
    """A variant's name at a stage-2 dtype: its directories, stage file and
    evals carry it (``k50_motion``, ``k50_motion_fp32``)."""
    return name if dtype == "bf16" else f"{name}_{dtype}"


def stage2_variants(names, k_full: int, dtype: str) -> dict:
    """{variant name at ``dtype``: its stage-2 CLI overrides} for the
    variants ``names``, in VARIANTS' order."""
    base = {
        "k50_motion": [f"model.train_pick_best_sample_among_k={k_full}",
                       "model.similarity_space=input_space"],
        "k50_latent": [f"model.train_pick_best_sample_among_k={k_full}",
                       "model.similarity_space=latent_space"],
        "k1": ["model.train_pick_best_sample_among_k=1"],
    }
    return {variant_name(v, dtype): base[v] + STAGE2_DTYPES[dtype]
            for v in VARIANTS if v in names}


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(REPO, "output", "torch_capstone"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and epochs on the CPU to exercise the plumbing")
    ap.add_argument("--only-done-variants", action="store_true",
                    help="do not train stage-2 variants whose phase marker is absent; "
                         "evaluate and report only the completed ones")
    ap.add_argument("--out-json", default=os.path.join(REPO, "docs", "torch_convergence.json"))
    ap.add_argument("--variants", nargs="*", choices=VARIANTS, default=list(VARIANTS),
                    help="the stage-2 variants this run trains, in VARIANTS' order "
                         "(none: stage 1 and the ZeroVelocity eval only)")
    ap.add_argument("--stage2-dtype", choices=sorted(STAGE2_DTYPES), default="bf16",
                    help="the dtype stage 2 trains in (fp32: model.compute_dtype=null); "
                         "a variant trained in fp32 is named <variant>_fp32")
    ap.add_argument("--live-eval", action="store_true",
                    help="also evaluate each variant on its live (non-EMA) weights")
    ap.add_argument("--merge", nargs="+", metavar="DIR", default=None,
                    help="judge the stage files of these runs' --out-json directories "
                         "as one report at --out-json, and exit")
    # schedule overrides: the values land in the report's `config` block
    ap.add_argument("--ae-epochs", type=int, default=None)
    ap.add_argument("--ae-iters", type=int, default=None,
                    help="stage-1 num_iter_perepoch (default: full epochs)")
    ap.add_argument("--ae-gamma", type=float, default=None,
                    help="stage-1 LR gamma_decay (config default 0.98)")
    ap.add_argument("--diff-epochs", type=int, default=None)
    ap.add_argument("--diff-iters", type=int, default=None)
    ap.add_argument("--diff-gamma", type=float, default=None)
    ap.add_argument("--diff-warmup", type=int, default=None)
    ap.add_argument("--eval-freq", type=int, default=None)
    ap.add_argument("--data-only", action="store_true",
                    help="build the synthetic dataset and exit")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.merge:
        return merge(args.merge, args.out_json)
    import torch

    if not args.smoke and not args.data_only and not torch.cuda.is_available():
        raise RuntimeError("torch_convergence_capstone: the full run needs a CUDA device "
                           "(--smoke runs on the CPU)")
    os.chdir(REPO)  # configs/ tree resolution

    root = args.root
    os.makedirs(root, exist_ok=True)
    t_all = time.time()

    # ---- shapes / schedule ---------------------------------------------
    if args.smoke:
        task = ["task.history_sec=0.1", "task.prediction_horizon_sec=0.25"]
        obs_len, pred_len = 6, 15
        clip_len, files_per_ds, stride = 90, 4, 9
        ae_epochs, ae_warm, diff_epochs, diff_warm = 6, 2, 6, 2
        eval_freq, curriculum_it = 2, 2
        arch = ["model.latent_size=16",
                "model.autoenc_arch.encoder_hidden_size=16",
                "model.autoenc_arch.decoder_hidden_size=16"]
        diff_arch = ["model.diffusion_arch.depth=1",
                     "model.diffusion_arch.attn_heads=2",
                     "model.diffusion_arch.attn_dim_head=4",
                     "model.diffusion_timesteps=4"]
        k_full = 4
        num_samples = 4
        diff_sched = ["model.num_iter_perepoch=null"]
    else:
        task = ["task.history_sec=0.5", "task.prediction_horizon_sec=2.0"]
        obs_len, pred_len = 30, 120
        clip_len, files_per_ds, stride = 480, 25, 15
        # LR floors: AE 5e-3 ->(x0.98/epoch after 10 warmup)-> 1e-4 at epoch
        # ~204; diffusion 1e-3 ->(x0.94/epoch after 10 warmup)-> 1e-4 at
        # epoch ~48 < 60
        ae_epochs, ae_warm, diff_epochs, diff_warm = 210, 10, 60, 10
        eval_freq, curriculum_it = 10, 20
        arch = []           # flagship: latent 96, hidden 96
        diff_arch = []      # flagship: depth 4, heads 8, T=10
        k_full = 50
        num_samples = 50
        diff_sched = ["model.num_iter_perepoch=256",
                      "model.lr_scheduler_kwargs.gamma_decay=0.94"]

    # ---- overrides (see the argparse help above) ---------------------------
    if args.ae_epochs is not None:
        ae_epochs = args.ae_epochs
    if args.diff_epochs is not None:
        diff_epochs = args.diff_epochs
    if args.diff_warmup is not None:
        diff_warm = args.diff_warmup
    if args.eval_freq is not None:
        eval_freq = args.eval_freq
    ae_sched = []
    if args.ae_gamma is not None:
        ae_sched.append(f"model.lr_scheduler_kwargs.gamma_decay={args.ae_gamma}")
    ae_iters = "null" if args.ae_iters is None else str(args.ae_iters)
    if args.diff_iters is not None:
        diff_sched = [o for o in diff_sched if not o.startswith("model.num_iter_perepoch")]
        diff_sched.append(f"model.num_iter_perepoch={args.diff_iters}")
    if args.diff_gamma is not None:
        diff_sched = [o for o in diff_sched
                      if not o.startswith("model.lr_scheduler_kwargs.gamma_decay")]
        diff_sched.append(f"model.lr_scheduler_kwargs.gamma_decay={args.diff_gamma}")

    # ---- phase: dataset ---------------------------------------------------
    ds_root = os.path.join(root, "datasets")

    def build_data():
        from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_amass_motion

        make_synthetic_amass_motion(
            root, obs_length=obs_len, pred_length=pred_len,
            files_per_dataset=files_per_ds, clip_len=clip_len,
            test_segment_stride=stride * 2, seed=7,
        )

    os.makedirs(ds_root, exist_ok=True)
    run_phase(root, "data", ds_root, build_data)
    if args.data_only:
        print("[capstone] --data-only: dataset ready, exiting")
        return None

    common = [
        f"dataset_main_path={ds_root}",
        "device_mesh.n_devices=1",
        f"device={'cpu' if args.smoke else 'cuda'}",
        *task,
    ]
    train_data = [
        "dataset.data_loader_train.datasets=[ACCAD, CMU, BMLmovi, KIT]",
        f"dataset.data_loader_train.stride={stride}",
        f"dataset.data_loader_train.augmentation={max(stride // 2 - 1, 0)}",
        "dataset.data_loader_train_eval.datasets=[ACCAD, CMU, BMLmovi, KIT]",
        "dataset.data_loader_valid.datasets=[HumanEva]",
    ]

    # ---- evidence banking: after every completed phase, (re)write an
    # honestly-partial report, so a cut run still leaves the evidence of
    # every phase that finished
    resolved_config = dict(
        obs_len=obs_len, pred_len=pred_len, clip_len=clip_len,
        files_per_dataset=files_per_ds,
        ae_epochs=ae_epochs, ae_warmup=ae_warm,
        ae_iters_per_epoch=None if ae_iters == "null" else int(ae_iters),
        ae_gamma=args.ae_gamma if args.ae_gamma is not None else 0.98,
        ae_sched=ae_sched,
        diff_epochs=diff_epochs, diff_warmup=diff_warm, diff_sched=diff_sched,
        eval_freq=eval_freq, curriculum_it=curriculum_it,
        k=k_full, num_samples=num_samples,
    )
    card = card_line(args.smoke)
    results: dict = {}
    live: dict = {}  # the variants' evals on their live weights (--live-eval)
    diff_dirs: dict = {}
    ae_dir = os.path.join(root, "out_ae")

    stage_dir = os.path.dirname(os.path.abspath(args.out_json))

    def write_stage(name: str, stage: dict, phases):
        """``stage_<name>.json`` beside the report: what ``merge`` needs of
        a finished stage, with its phases' seconds and the card."""
        timings = spent(root)
        stage = dict(stage, config=resolved_config, smoke=args.smoke, card=card,
                     timings={k: v for k, v in timings.items() if k in phases})
        os.makedirs(stage_dir, exist_ok=True)
        with open(os.path.join(stage_dir, f"stage_{name}.json"), "w") as f:
            json.dump(stage, f, indent=2)

    def bank(last_phase: str):
        """Write the partial report now; safe at any point after data prep."""
        timings = spent(root)
        report = analyze(root, ae_dir, diff_dirs, results, smoke=args.smoke,
                         timings=timings, config=resolved_config)
        report["last_phase_done"] = last_phase
        report["timings_sec"] = dict(timings, total=round(sum(timings.values()), 1),
                                     this_run=round(time.time() - t_all, 1))
        report["card"] = card
        if live:
            report["metrics_live"] = live
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[capstone] banked partial report after '{last_phase}' -> {args.out_json}",
              flush=True)
        return report

    # ---- phase: stage-1 autoencoder ---------------------------------------

    def train_ae():
        from skeletondiffusion_tpu_torch.cli.train_autoencoder import main as ae_main

        ae_main(common + train_data + arch + ae_sched + resume_flag(ae_dir) + [
            "dataset=amass",
            f"output_log_path={ae_dir}",
            f"model.num_epochs={ae_epochs}",
            f"model.num_iter_perepoch={ae_iters}",
            "model.batch_size=64",
            f"model.curriculum_it={curriculum_it}",
            "model.if_run_validation=True",
            f"model.eval_frequency={eval_freq}",
            f"model.save_frequency={eval_freq * 5}",
            f"model.lr_scheduler_kwargs.warmup_duration={ae_warm}",
            "model.lr_scheduler_kwargs.update_every=1",
        ])

    run_phase(root, "train_autoencoder", ae_dir, train_ae)
    bank("train_autoencoder")
    write_stage("autoencoder", {"evidence": ae_evidence(ae_dir)}, ("data", "train_autoencoder"))

    # ---- eval helper (used per variant, right after it trains) -------------
    eval_dir = os.path.join(root, "evals")
    os.makedirs(eval_dir, exist_ok=True)

    def run_eval(name: str, extra: list):
        from skeletondiffusion_tpu_torch.cli.eval import main as eval_main
        from skeletondiffusion_tpu_torch.utils import yaml_lite

        res_path = os.path.join(eval_dir, f"results_{name}.yaml")
        if not os.path.exists(res_path):
            t0 = time.time()
            eval_main(common + [
                "dataset=amass",
                "dataset.data_loader_test.datasets=[DFaust, GRAB]",
                "stats_mode=probabilistic",
                f"num_samples={num_samples}",
                "batch_size=256",
                "if_compute_cmd=True",
                "if_compute_apde=True",
                f"results_path={res_path}",
            ] + extra)
            spend(root, f"eval_{name}", time.time() - t0)
        return yaml_lite.read(res_path)

    # the reference's algorithmic baseline; it needs no trained model, so it
    # runs (and is banked) first
    results["zero_velocity"] = run_eval("zv", [
        "method_specs=zerovelocity_alg_baseline",
    ])
    bank("eval_zero_velocity")
    write_stage("zero_velocity", {"metrics": results["zero_velocity"]}, ("eval_zv",))

    # ---- phase: stage-2 diffusion, three objective variants ----------------
    # in VARIANTS' order: if the run is cut, the checks that depend only on
    # the flagship ((a), (c), (d)) survive, then check (b)'s first leg
    flagship = variant_name("k50_motion", args.stage2_dtype)
    for vname, vargs in stage2_variants(args.variants, k_full, args.stage2_dtype).items():
        out = os.path.join(root, f"out_diff_{vname}")
        if args.only_done_variants and not done(out):
            print(f"[capstone] train_diffusion_{vname}: not done, "
                  "skipping (--only-done-variants)")
            continue
        diff_dirs[vname] = out

        def train_diff(vargs=vargs, out=out):
            from skeletondiffusion_tpu_torch.cli.train_diffusion import main as diff_main

            diff_main(common + diff_arch + vargs + diff_sched + resume_flag(out) + [
                f"output_log_path={out}",
                f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
                f"model.num_epochs={diff_epochs}",
                "model.batch_size=64",
                "model.if_run_validation=True",
                f"model.eval_frequency={eval_freq}",
                f"model.lr_scheduler_kwargs.warmup_duration={diff_warm}",
                "model.lr_scheduler_kwargs.update_every=1",
            ])

        run_phase(root, f"train_diffusion_{vname}", out, train_diff)
        results[vname] = run_eval(vname, [f"checkpoint_path={out}"])
        stage = {"metrics": results[vname], "evidence": variant_evidence(out)}
        if args.live_eval:
            live[vname] = stage["metrics_live"] = run_eval(
                f"{vname}_live", [f"checkpoint_path={out}", "if_use_ema=False"])
        bank(f"eval_{vname}")
        write_stage(vname, stage, (f"train_diffusion_{vname}", f"eval_{vname}",
                                   f"eval_{vname}_live"))

    if "k50_motion" in args.variants and flagship not in diff_dirs:
        sys.exit(f"[capstone] flagship ({flagship}) not trained yet — nothing to "
                 "report; run without --only-done-variants first")

    # ---- final report ---------------------------------------------------------
    report = bank("all")
    print(f"[capstone] report written to {args.out_json}")
    print(json.dumps(report.get("checks", {}), indent=2))
    return report


def verdict(report) -> int:
    """The exit code of a finished run: 1 when a judged check failed (not in
    the smoke run, whose schedule is too short to judge)."""
    if report is None:
        return 0
    judged = [v for v in report["checks"].values() if v is not None]
    if not report["smoke"] and not all(judged):
        print("[capstone] SOME CHECKS FAILED", file=sys.stderr)
        return 1
    return 0


def ae_evidence(ae_dir: str) -> dict:
    """What the checks read of stage 1's log: the LR of each epoch row, the
    curriculum's horizons and the validation ADE."""
    rows = read_jsonl(os.path.join(ae_dir, "metrics.jsonl"))
    return {
        # LR from the per-EPOCH rows (prefix "train"): iteration rows are only
        # logged every log_every_iters and can miss the final epochs entirely
        "epoch_lr": [r["lr"] for r in rows if r.get("prefix") == "train" and "lr" in r],
        "ph": [(r["step"], r["ph"]) for r in rows
               if r.get("prefix") in ("train", "train_iter") and "ph" in r],
        "val": [(r["step"], r["ADE"]) for r in rows
                if r.get("prefix") == "valid" and "ADE" in r],
    }


def variant_evidence(out_dir: str) -> dict:
    """What the checks read of a stage-2 variant: its EMA validation ADE,
    its kept checkpoints and the LR of each epoch row."""
    rows = read_jsonl(os.path.join(out_dir, "metrics.jsonl"))
    return {
        "val": [(r["step"], r["ADE"]) for r in rows
                if r.get("prefix") == "valid" and "ADE" in r],
        "kept": kept_checkpoints(os.path.join(out_dir, "checkpoints")),
        "epoch_lr": [r["lr"] for r in rows if r.get("prefix") == "train" and "lr" in r],
    }


def merge(dirs, out_json: str) -> dict:
    """One report from the ``stage_<name>.json`` files of several runs'
    report directories (a stage found in more than one: the first
    directory's, so list the run that finished a stage first), judged as
    ``analyze`` judges one run; written to ``out_json``.  ``calls`` says
    which directory gave each stage."""
    stages, calls = {}, {}
    for d in dirs:
        for name in sorted(os.listdir(d)):
            stage = name[len("stage_"):-len(".json")]
            if name.startswith("stage_") and name.endswith(".json") and stage not in stages:
                with open(os.path.join(d, name)) as f:
                    stages[stage] = json.load(f)
                calls[stage] = d
    if "autoencoder" not in stages:
        sys.exit(f"[capstone] no stage_autoencoder.json in {dirs}: stage 1 did not finish")
    ae = stages["autoencoder"]
    results = {s: stages[s]["metrics"] for s in ("zero_velocity", *VARIANTS) if s in stages}
    flag = stages["k50_motion"]["evidence"] if "k50_motion" in stages else None
    report = judge(ae["evidence"], flag, results, smoke=ae["smoke"], config=ae["config"])
    live = {v: stages[v]["metrics_live"] for v in VARIANTS
            if v in stages and "metrics_live" in stages[v]}
    if live:
        report["metrics_live"] = live
    dtypes = dtype_reading(stages)
    if dtypes:
        report["stage2_dtype"] = dtypes
    timings = {}
    for stage in stages.values():
        timings.update(stage["timings"])
    report["last_phase_done"] = "merged"
    report["timings_sec"] = dict(timings, total=round(sum(timings.values()), 1))
    report["card"] = "; ".join(sorted({stage["card"] for stage in stages.values()}))
    report["calls"] = calls
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"[capstone] merged {sorted(stages)} -> {out_json}")
    print(json.dumps(report["checks"], indent=2))
    return report


def dtype_reading(stages: dict) -> dict:
    """Check (b)'s first leg, APD(k50_motion) > APD(k50_latent), for each
    stage-2 dtype whose pair of stage files is there: {dtype: {weights:
    {apd_motion, apd_latent, ratio, passes, ade_motion, ade_latent}}} on
    the EMA weights the check reads and, where the runs evaluated them, the
    live weights."""
    reading = {}
    for dtype in STAGE2_DTYPES:
        motion = stages.get(variant_name("k50_motion", dtype))
        latent = stages.get(variant_name("k50_latent", dtype))
        if motion is None or latent is None:
            continue
        reading[dtype] = {}
        for weights, key in (("ema", "metrics"), ("live", "metrics_live")):
            if key in motion and key in latent:
                a, b = float(motion[key]["APD"]), float(latent[key]["APD"])
                reading[dtype][weights] = {"apd_motion": a, "apd_latent": b,
                                           "ratio": round(a / b, 4) if b else None,
                                           "passes": bool(a > b),
                                           "ade_motion": motion[key].get("ADE"),
                                           "ade_latent": latent[key].get("ADE")}
    return reading


def analyze(root, ae_dir, diff_dirs, results, *, smoke, timings, config):
    """The evidence trail for checks (a)-(d), as the JAX script's
    ``analyze`` assembles it.

    Tolerates partially-complete runs (missing variants / missing evals):
    every check that cannot be judged yet is reported as ``None``, so this
    can be called after EVERY phase to bank honest partial evidence."""
    flag_dir = diff_dirs.get("k50_motion")
    return judge(ae_evidence(ae_dir), variant_evidence(flag_dir) if flag_dir else None,
                 results, smoke=smoke, config=config)


def judge(ae: dict, flag, results: dict, *, smoke: bool, config: dict) -> dict:
    """``analyze``'s report from stage 1's evidence, the flagship's (None
    before it trained) and the evals' metrics."""
    flagship = results.get("k50_motion")
    zv = results.get("zero_velocity")

    # (c) EMA validation ADE trajectory + top-k rotation evidence
    val_ade = [tuple(v) for v in flag["val"]] if flag else []
    kept = flag["kept"] if flag else []

    # (d) LR floor + curriculum annealing
    ae_lr_final = ae["epoch_lr"][-1] if ae["epoch_lr"] else None
    diff_lr_final = flag["epoch_lr"][-1] if flag and flag["epoch_lr"] else None
    ph_series = ae["ph"]
    # after the cosine cycle the horizon is randomized in [ph_min, ph_train)
    # (reference `trainer.py:66-76`), so "annealed" shows as logged horizons
    # reaching the upper end of that range, not a single deterministic value
    ph_max_reached = max((p for _, p in ph_series), default=0)

    ae_val = [tuple(v) for v in ae["val"]]

    def apd_gt(a, b):
        # None (= not judged) when a variant was skipped by --only-done-variants
        if a not in results or b not in results:
            return None
        return bool(results[a]["APD"] > results[b]["APD"])

    checks = {
        "flagship_beats_zero_velocity_ade": (
            None if flagship is None or zv is None
            else bool(flagship["ADE"] < 0.6 * zv["ADE"])),
        "flagship_beats_zero_velocity_fde": (
            None if flagship is None or zv is None
            else bool(flagship["FDE"] < 0.6 * zv["FDE"])),
        "apd_ordering_motion_gt_latent": apd_gt("k50_motion", "k50_latent"),
        "apd_ordering_latent_gt_k1": apd_gt("k50_latent", "k1"),
        # outer comparison of the same ablation: judgeable as soon as k1
        # finishes, even if the k50_latent leg is cut off
        "apd_ordering_motion_gt_k1": apd_gt("k50_motion", "k1"),
        "ema_val_ade_improved": (None if not val_ade else
                                 (len(val_ade) >= 2 and
                                  min(a for _, a in val_ade[1:]) < val_ade[0][1])),
        "topk_checkpoints_rotated": (None if flag is None else len(kept) >= 2),
        "ae_lr_reached_floor": (None if ae_lr_final is None
                                else ae_lr_final <= 1.0e-4 * 1.001),
        "diff_lr_reached_floor": (None if diff_lr_final is None
                                  else diff_lr_final <= 1.0e-4 * 1.001),
        "curriculum_fully_annealed": (None if not ph_series else
                                      ph_max_reached >= 0.9 * config["pred_len"]),
        "ae_val_ade_improved": (None if not ae_val else
                                (len(ae_val) >= 2 and
                                 min(a for _, a in ae_val[1:]) < ae_val[0][1])),
    }
    # raw margins next to the booleans: a pass by 1% reads differently from
    # a pass by 5x
    margins = {
        "flagship_over_zv_ade_ratio": (
            None if flagship is None or zv is None or not zv["ADE"]
            else round(flagship["ADE"] / zv["ADE"], 4)),
        "flagship_over_zv_fde_ratio": (
            None if flagship is None or zv is None or not zv["FDE"]
            else round(flagship["FDE"] / zv["FDE"], 4)),
        "apd_motion_over_latent_ratio": (
            None if "k50_motion" not in results or "k50_latent" not in results
            or not results["k50_latent"]["APD"]
            else round(results["k50_motion"]["APD"] / results["k50_latent"]["APD"], 4)),
        "apd_latent_over_k1_ratio": (
            None if "k50_latent" not in results or "k1" not in results
            or not results["k1"]["APD"]
            else round(results["k50_latent"]["APD"] / results["k1"]["APD"], 4)),
        "apd_motion_over_k1_ratio": (
            None if "k50_motion" not in results or "k1" not in results
            or not results["k1"]["APD"]
            else round(results["k50_motion"]["APD"] / results["k1"]["APD"], 4)),
        "ema_val_ade_first_to_best_ratio": (
            None if len(val_ade) < 2 or not val_ade[0][1]
            else round(min(a for _, a in val_ade[1:]) / val_ade[0][1], 4)),
        "ae_val_ade_first_to_best_ratio": (
            None if len(ae_val) < 2 or not ae_val[0][1]
            else round(min(a for _, a in ae_val[1:]) / ae_val[0][1], 4)),
        "curriculum_ph_max_over_pred_len": (
            None if not ph_series
            else round(ph_max_reached / config["pred_len"], 4)),
    }
    missing = [v for v in ("k1", "k50_motion", "k50_latent") if v not in results]
    return {
        "description": "Two-stage convergence capstone of the PyTorch port on synthetic "
                       "rigid-skeleton motion (scripts/torch_convergence_capstone.py)",
        "smoke": smoke,
        "partial_variants_missing": missing,
        "config": config,
        "metrics": {k: {m: float(v) for m, v in r.items() if isinstance(v, (int, float))}
                    for k, r in results.items()},
        "valid_ade_trajectory_k50_motion": val_ade,
        "valid_ade_trajectory_autoencoder": ae_val,
        "kept_checkpoints_k50_motion": kept,
        "final_lr": {"autoencoder": ae_lr_final, "diffusion": diff_lr_final},
        "curriculum_ph_max": ph_max_reached,
        # the procedural data's FK is rigid, so ground-truth limb stretch is
        # exactly 0 mm: the flagship's StretchMean/RMSE (mm) are its own
        # limb violation
        "limb_stretch_flagship_mm": (None if flagship is None else {
            "StretchMean": flagship.get("StretchMean"),
            "StretchRMSE": flagship.get("StretchRMSE"),
            "gt_stretch_mm": 0.0,
        }),
        "checks": checks,
        "margins": margins,
    }


if __name__ == "__main__":
    # `timeout` ends a cut run with SIGTERM: exit through the phases'
    # `finally`, so that their seconds so far are kept
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    sys.exit(verdict(main()))
