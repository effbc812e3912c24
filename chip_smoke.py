#!/usr/bin/env python3
"""Drive the PyTorch port's fp32 and bf16 prediction paths, its serving
export, its evaluation path and its two-stage training path (in one process,
over a data axis of two ranks and over a model axis of two) on one NVIDIA GPU
and hold its
hand-written CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each printed with its elapsed seconds:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds skeletondiffusion_tpu_torch/csrc/*.cu at each node
              count of NODE_COUNTS (21 AMASS, 16 H36M, 17 FreeMan, 51
              AMASS-MANO), one nvcc a source and count, all at once (ptxas
              report);
3. kernels  — the AMASS flagship model at full width (21 nodes, latent and
              hidden 96, denoiser depth 4 × 8 heads × 32, 10 diffusion steps,
              observe 30, predict 120) is built from a seed; K1 and K2 run on
              inputs of the main path's shapes (batch 256 × 50 samples =
              12 800 rows; K1 also at 12 795 rows and at an odd number of its
              tiles and clusters; K2 with an fp32 and a bf16 x̂₀, every t of
              the model's tables and of diagonal ones, at 12 795 and 12 790
              rows and at a ragged last column tile, and its CUDA-core design
              beside it) and are compared with their plain versions and timed;
4. main     — the fp32 path: batch 256 × 50 samples through the predictor and
              the metric-space transform: predictions/s, launch counts per
              prediction, and the same prediction with injected noise against
              the predictor with both kernels replaced by their plain versions;
5. denoiser — the same model with a bf16 denoiser and encoder: each kernel of
              the fused denoiser (B1–B5) and K2's bf16-x̂₀ entry on the bench
              shapes in bf16 and in fp32 and at a ragged row count, against
              its plain version, timed beside its bound, its plain version and
              the one PyTorch call that computes its function, where there is
              one (B1, B3a, B3b, B5a and B5b also beside torch.bmm calls of
              their per-node products alone, e.g. [21, 12 800, 192]·[21, 192,
              768] for B3a: the product stage's cuBLAS time, not the
              function; these five, B4 and B2 also at a row count with an odd
              number of their row tiles; B2 also at 32 heads, where its items
              take one row of a group of heads);
6. main_bf16 — the bf16 path: predictions/s and launch counts per prediction,
              and with injected noise the sampler's state after each step and
              the predictions against the same path on the plain versions,
              beside the plain path's deviation from the fp32 path;
7. layer_fused — the per-layer kernels of the layer-fused denoiser (B9a–c),
              checked and timed as in phase 5 (all three also beside their
              products-only torch.bmm calls and at an odd number of row tiles),
              and B4's output against B9a's r bit for bit (bf16 and fp32);
8. main_layer_fused — the bf16 path with SKELDIFF_LAYER_FUSED=1 (set for this
              phase only): predictions/s and launch counts per prediction,
              and with injected noise against the same path on the plain
              versions and against the single-stage kernel path of phase 6,
              each beside the deviation of the run it is held against from
              the fp32 path;
9. decode_bf16 — the merged-gate bf16 rollout (B8) against its plain version
              at 12 800, 12 795 and 12 760 rows (an odd number of its tiles
              and clusters) × 120 steps, its mean deviation also against the
              plain version's own from the fp32 plain rollout, timed beside
              its bound, its plain version and K1; then the slice's
              entry point, scripts/torch_decode_bf16_check.py (a fresh
              AutoEncoder from seed 0, 12 800 rows), with its launch counts,
              and its metric-space deviation (B8 against K1) held within
              1.3× either way of the same deviation of the plain versions;
10. attn_core_fm — the feature-major attention core (L1) against its plain
              version in bf16 and fp32 at 12 800 and 12 795 rows, at an odd
              number of its column tiles and at 32 heads × 1 000 rows, timed
              beside its bound, its plain version, scaled_dot_product_attention
              and B2 on the same data; then the lab's entry point,
              scripts/torch_attn_core_lab.py (its fp32 check and its chains of
              B2 and L1 calls), with its launch counts;
11. eval    — the evaluation path: the port's make_synthetic_amass_motion
              (seed 0, observe 30, predict 120, 60 fps) writes the synthetic
              AMASS tree into a temporary directory, with its mm-GT and mean
              motions from the port's finalize_dataset, and AMASSDataset
              reads its test split (2 datasets × 25 clips × 480 frames:
              550 segments, three batches of 256, the last padded).  Then
              compute_metrics (probabilistic table, CMD, APDE): the bf16
              predictor (B4, B1, B3a, B2, B3b, B5a, B5b, K2 and K1; the
              launches counted, three times a prediction's) prints the
              12-metric table, seconds a batch (median and each), the eval
              loop's preds/s and each batch's device time split by CUDA
              events into predictor, metrics and the rest (host data,
              transfer, preprocess, idle); the fp32 eval with injected noise
              on the kernels against the same eval on the plain versions,
              every metric within 1e-4·max(1, |value|); ZeroVelocity through
              compute_metrics on the card against the CPU, every metric
              within 1e-5·max(1, |value|);
12. train   — the two-stage training path on the same tree's train split
              (4 datasets × 25 clips, a segment every 60 frames jittered by
              ±30): DataLoader → cycled_batches → prefetch_iterator →
              preprocess_batch with mirroring (0.5) and rotation (1.0) on
              the card, batch 64.  Stage 1: 10 AutoEncoder steps (hidden and
              latent 96, the curriculum of epoch 11: random horizons up to
              120, the differentiable decode), ms a step; K1's decode after a
              step against the plain decode of the new weights; a step at the
              full horizon after a restore from a checkpoint against the
              uninterrupted one (1e-6 relative) and on the CPU (loss 1e-4,
              gradient norm 1e-3 relative).  Stage 2: 10 bf16 steps (k = 50,
              input space, the k-best decode on K1: 3 200 rows a step) on
              the trained AutoEncoder, ms a step, the k-best decode's ms and
              the launches a step; the resume check; one fp32 step with K1
              against the same step with the plain decode (losses within
              1e-4·max(1, |v|), argmins equal wherever the plain gap exceeds
              that) and against the CPU; one validation step at 256 × 50 on
              the EMA weights (the bf16 prediction path, its launches);
13. cli     — the entry points on the same tree at the width of configs/**
              (AMASS-22, latent and hidden 96, the denoiser of
              skeleton_diffusion.yaml in bf16, observe 30, predict 120):
              cli.train_autoencoder.main for 2 epochs × 3 iterations with
              validation each epoch; cli.train_diffusion.main on that
              AutoEncoder for 2 epochs × 3 iterations with validation, then
              resumed to a 3rd epoch; cli.eval.main (probabilistic, batch 256)
              on the stage-2 experiment, its results against compute_metrics
              on prepare_model's predictor with the same seed (1e-5·max(1, |v|))
              and against the results YAML it wrote, read back with yaml_lite,
              its launches a batch equal to the eval phase's; and
              InferenceSession.predict on one observation ([50, 120, 21, 3])
              against the session's predictor with the same generator.  Seconds
              an epoch of each stage and the CLI's preds/s beside the eval
              phase's.
14. variants — the diffusion variants at the same width: the isotropic
              process (isotropic_diffusion.yaml's), DDIM at 5 of its 10
              steps and the nonisotropic process with pred_noise, each on
              the fp32 path (preds/s, launches; latents and predictions
              with injected noise against its plain path: the plain
              denoiser, the q_posterior step, the plain decode; 1e-4) and
              the bf16 path (preds/s, launches; against its plain versions
              within BF16_E2E_MAX × the plain versions' fp32 deviation; for
              pred_noise each step's denoiser output, on the same inputs,
              the same way); tanh and the
              unconditioned, self-conditioned and attention-free denoisers
              on the card against the CPU (4 × 50 samples,
              1e-4·max(1, |v|)), one timed call each on both paths with the
              path it took; the plain decode against K1 (12 800 rows), the
              predictor on it, and in bf16 its metric-space deviation beside
              B8's; cli.train_diffusion model=isotropic_diffusion on the cli
              phase's stage 1 (2 epochs × 3 iterations) and its eval CLI
              against compute_metrics (1e-5·max(1, |v|)); the AutoEncoder
              variants (an LSTM encoder and decoder, a two-layer GRU encoder,
              z_activation identity) on the card against the CPU (fp32, 4 ×
              50 samples, 1e-4·max(1, |v|)), each timed on both paths with
              the bf16 chain and K2, K1 launched for the GRU decoders and
              never for the LSTM one.
15. parallel — two ranks on the one card over gloo (parallel/dryrun.py's
              run_ranks): the bf16 eval of phase 11 over a data axis of
              two (each rank its 128 rows of every batch with the whole
              batch's noise, the metric values gathered) against phase 11's
              table at 1e-5·max(1, |v|), with its launches; one fp32 stage-2
              step of the flagship (batch 64 × k 50, injected t and noise)
              against the same step in one process at the train phase's
              bounds; then the same step on a model axis of two (1 data × 2
              model ranks, the banks and dense layers split by
              shard_params_model_axis, each rank the whole batch) against
              the same one-process step at the same bounds, with the split
              shapes and the step's seconds beside the one-process step's;
16. serving — the serving export (serving.py): the bf16 predictor of phase 6
              exported as torch.export programs at buckets 64 and 256, the
              fp32 one of phase 4 at 256 (export seconds, artifact size), by
              a process started after the build that traces on the host
              while phases 3–15 drive the card, then loaded by a fresh
              process started in its place, which waits for this phase;
              a fresh process that imports no model class loads both and
              runs each bucket with a seeded generator: each kernel's
              launches a call equal the live path's, the output equals the
              live predictor's for the same generator state bit for bit
              (else the reason is printed and it is held within the path's
              bounds), served vs live preds/s (median of 3);
17. skeletons — the flagship model at full width on the H36M (16 nodes,
              observe 25, predict 100) and FreeMan (17 nodes, observe 15,
              predict 60) skeletons: K1, K2 and every kernel of phases 5
              and 7 against its plain version as there (bf16, fp32, ragged
              and odd-tile rows), the fp32, bf16 and layer-fused paths as
              phases 4, 6 and 8 run and hold them (the bf16 paths'
              predictions: the max held, the mean printed, ROADMAP Queue C
              item 7); then compute_metrics with the bf16 predictor over the
              first SKELETON_EVAL_CUT segments of the test splits of the
              shipped H36M (of 5 168 segments, its mmapd_GT.csv, FID
              through an h36m_classifier.pth of
              tests/goldens/fid_classifier.npz), FreeMan (of 11 015) and
              3DPW zero-shot (of 3 252, on the AMASS model) annotations with
              random-walk clips, eval preds/s, the batch's device time split
              (predictor, metrics, FID features, the rest) and launches,
              ZeroVelocity card vs CPU on two batches; cli.train_autoencoder and
              cli.train_diffusion with dataset=h36m (2 epochs × 3
              iterations, validation on the shipped S8 segments) and
              cli.eval dataset=h36m with FID against compute_metrics.  The
              kernels' JSON line lists each kernel once per node count
              ("nodes"), with eval_launches of its dataset; the 21-node
              entries also carry eval_3dpw_launches.  Before these, four
              kernels given 52 nodes must raise, naming shapes no skeleton of
              the reference has (ROADMAP Queue B item 9), B8 and L1 too, and
              at 51 nodes the fp32 engine's plans (Queue B item 10).  At
              each of 16 and 17 nodes B8 (the model's decoder's rollout
              inputs, its steps; 12 800, 12 795 and an odd-tile row count)
              and L1 (the lab's 8 heads × 32; 12 800, 12 795, an odd-tile
              count, 32 heads × 1 000) against their plain versions as
              phases 9 and 10 hold them, and their paths: a bf16 decode of
              the model's decoder and the lab's feature-major chain, each
              between a reset and a read of the counters.
18. mano    — the same at AMASS-MANO's 51 nodes (observe 30, predict 120):
              K1, K2 and every kernel of phases 5 and 7 against its plain
              version (bf16; B2 and K1, K2 in fp32 too; the fp32 engine's
              tiles do not fit at 51 nodes), the fp32, bf16 and layer-fused
              paths as phase 17 runs and holds them; compute_metrics with the
              bf16 predictor over the shipped AMASS-MANO test split cut to
              MANO_EVAL_CUT segments (APDE on the tree's mmapd_GT.csv);
              cli.train_autoencoder, cli.train_diffusion and cli.eval with
              dataset=amass-mano as phase 17's H36M CLIs, without FID; B8
              (its design past 21 nodes) and L1 and their paths as phase 17
              runs them.  The
              kernels' JSON line lists the 51-node entries with eval_launches
              of the MANO eval.
19. capstone — scripts/torch_convergence_capstone.py through its main at
              full width on a temporary root (its full-size synthetic motion
              tree, both training CLIs, the three stage-2 variants, the
              ZeroVelocity and variant evals) with CAPSTONE_CUT's minimal
              schedule: every phase done, every key of the JAX script's
              report, and K1, K2 and the single-stage bf16 chain launched
              between the counters' reset and read (``capstone_launches`` in
              the kernels' JSON line, 21-node entries).
20. small   — the JAX quickstart's small models on the card: K1 built at the
              hidden widths of SMALL_WIDTHS (with the others in phase 2)
              against its plain version at 21 nodes (12 800, 12 795 and an
              odd-tile row count; ms, plain ms and bound on a line of their
              own), then examples/torch_quickstart_synthetic.py on the card
              (its synthetic tree, both training CLIs at hidden and latent
              16 and a denoiser of 2 heads × 4, the eval CLI, the serving
              export and a served call): the predictor takes the kernel
              chain padded (F 32 → 64, heads of 4 → 16), K1 at hidden 16, K2
              and every kernel of the chain launched, finite metrics and
              predictions of their shapes (``small_launches`` in the
              kernels' JSON line).  The flagship's and every skeleton's bf16
              predictors take the kernel chain (use_fused_denoiser; held
              where each is built).
21. widths  — the grid WIDTH_GRID of widths the JAX predictor's fused gate
              admits (latent 80 / 96 / 112 / 100 / 128 / 48, heads 8 × 16,
              2 × 64, 1 × 128, 4 × 32, 4 × 64, 32 × 4), each a full-width
              model at 21 nodes from a seed: the bf16 predictor on the
              kernel chain (use_fused_denoiser held), every kernel of phases
              5 and 7 at the chain's padded widths (K2's bf16-x̂₀ entry at
              the true latent width) against its plain version (bf16, a
              ragged and an odd-tile row count; B2 in fp32 too), timed
              beside its plain version and its bound at the true widths
              (the padded widths' bound beside it; at heads of 4, B2 at the
              true width's bytes too), the bf16 and
              layer-fused paths (preds/s, launches) held with injected
              noise against their plain versions as phases 6 and 8 hold
              them, the max taken from the fp32 path and the states'
              kernels-vs-plain max within WIDTHS_STATE_MAX (HOLD_WIDTHS),
              the predictions' mean printed, not held (as phase 17's,
              ROADMAP Queue C item 7), and the plain bf16
              denoiser module, the route those
              widths took before (preds/s); then B2 and B9b alone at 51
              nodes at 4 heads × 64 and 1 × 128 (F 256).  The kernels' JSON
              line lists each width's kernels ("grid", "heads", launches on
              the width's paths, "preds_s").

The fp32 parts run with TF32 off for matmuls and cuDNN.  Each kernel's entry
in the kernels' JSON line also carries ``eval_launches``, its launches in
the bf16 eval, ``train_launches``, its launches in stage 2's steps and
validation step, ``variant_launches``, its launches in one prediction of
each sampler variant on each path, and ``serving_launches``, its launches in
one call of the served bf16 and fp32 programs at batch 256.  Any failure exits
non-zero; so does a machine without a CUDA device.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit, and before that one JSON line lists every kernel.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import pathlib
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch

from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.cli import train_autoencoder as train_ae_cli
from skeletondiffusion_tpu_torch.cli import train_diffusion as train_diff_cli
from skeletondiffusion_tpu_torch.cli.common import build_dataset, build_skeleton
from skeletondiffusion_tpu_torch.data import (
    AMASSDataset,
    DataLoader,
    make_synthetic_amass_motion,
)
from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_skeleton_tree
from skeletondiffusion_tpu_torch.data.batch import (
    cycled_batches,
    prefetch_iterator,
    preprocess_batch,
)
from skeletondiffusion_tpu_torch.diffusion.engine import posterior_update_plain
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.diffusion.process import build_isotropic_process
from skeletondiffusion_tpu_torch.eval_pipeline import (
    SkeletonDiffusionPredictor,
    ZeroVelocityPredictor,
    compute_metrics,
)
from skeletondiffusion_tpu_torch.inference import InferenceSession
from skeletondiffusion_tpu_torch.metrics import suite as suite_mod
from skeletondiffusion_tpu_torch.metrics.multimodal import motion_for_cmd
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.models.autoencoder import Decoder
from skeletondiffusion_tpu_torch.ops.kernels import attention_proj as proj_mod
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import denoiser_fused
from skeletondiffusion_tpu_torch.ops.kernels import graph_linear_fused as stem_mod
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.ops.kernels import joint_attention as attn_mod
from skeletondiffusion_tpu_torch.ops.kernels import layer_fused as layer_mod
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as posterior_mod
from skeletondiffusion_tpu_torch.ops.kernels import resnet_block as block_mod
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm as fm_mod
from skeletondiffusion_tpu_torch.parallel import create_mesh, dryrun
from skeletondiffusion_tpu_torch.serving import export_predictor
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.train.checkpoint import CheckpointManager
from skeletondiffusion_tpu_torch.train.ema import ema_decay
from skeletondiffusion_tpu_torch.train.trainer_autoencoder import AutoEncoderTrainer
from skeletondiffusion_tpu_torch.train.trainer_diffusion import TrainerDiffusion
from skeletondiffusion_tpu_torch.utils import yaml_lite
from skeletondiffusion_tpu_torch.utils.config import flatten_config, load_config
from skeletondiffusion_tpu_torch.utils.logging import AverageTimer
from skeletondiffusion_tpu_torch.utils.reproducibility import iteration_generator

# the entry points of the decode check and the attention lab
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "scripts"))
import torch_attn_core_lab as attn_lab  # noqa: E402
import torch_decode_bf16_check as decode_check  # noqa: E402

BATCH, SAMPLES, OBS_LEN, PRED_LEN = 256, 50, 30, 120
# dataset → (joints with the hip, observed and predicted frames of the hmp
# task: 0.5 s and 2 s at the dataset's fps); the model drops the hip, so
# AMASS runs 21 nodes, H36M 16 and FreeMan 17
SKELETONS = {"amass": (22, OBS_LEN, PRED_LEN), "h36m": (17, 25, 100), "freeman": (18, 15, 60),
             "amass-mano": (52, OBS_LEN, PRED_LEN)}
# the node counts the kernels are built for: AMASS (and 3DPW), H36M, FreeMan,
# AMASS-MANO
NODE_COUNTS = (21, 16, 17, 51)
LATENT, HIDDEN, TIMESTEPS = 96, 96, 10
ARCH = {"depth": 4, "attn_heads": 8, "attn_dim_head": 32, "learn_influence": True}
SEED = 0
TIMED_CALLS = 3

# Tolerances, max |kernel − plain| on the same inputs.  Both sides are fp32 and
# differ only in the order of their sums: K2 sums 63 products of O(1) terms per
# output (~63·2^-24·|terms| ≲ 1e-5; 153 at 51 nodes, on the tensor cores in
# 3×TF32, which truncate as they accumulate: ≲ 2e-5), K1 sums 96- and 21-term dots per step and
# squashes every step through σ/tanh, which keeps the 120-step error at the
# per-step level; the end-to-end comparison adds the denoiser's amplification
# of the K2 differences over 10 steps, then the decode.
K2_TOL = 1e-4
K1_TOL = 1e-4
E2E_TOL = 1e-4

# The fused denoiser's kernels against their plain versions on the same
# inputs: in fp32 they differ only in the order of their sums (≤ 1e-4, as
# K1/K2); in bf16 a sum taken in another order can flip a rounding, so they
# are held, compared in fp32, at max |Δ| ≤ 3e-2·max|ref| and mean
# |Δ| ≤ 2e-3·max|ref| (8 significant bits, 2–4 roundings per kernel).
F32_TOL = 1e-4
BF16_MAX, BF16_MEAN = 3e-2, 2e-3
RAGGED = 5  # rows cut from the bench batch for the ragged-tile call
# B3a's and B9b's clusters take two adjacent row tiles (32 rows in bf16, 8 in
# fp32); at this count both have an odd number of tiles (399 and 1 595), so
# the last cluster's second block has no rows, and the bf16 tile before it
# is ragged (24 rows).  K1's clusters take four 8-row tiles: 1 595 tiles in
# 399 clusters, the last cluster's fourth block without rows; B8's take two:
# 798 clusters, the last one's second block without rows.  B1's, B9c's,
# B9a's, B3b's, B5a's, B5b's and B2's counts come from their plans
# (odd_tile_rows).
ODD_TILE_ROWS = 12_760
# The bf16 kernel paths against their plain paths with injected noise: the
# max |Δ| may reach this multiple of the plain path's max deviation from the
# fp32 path (see hold_bf16).  Measured on an H100 80GB HBM3 at 700 W against
# the kernel path's own deviation: 1.185 and 1.193 (sampler states; the
# single-stage and the layer-fused path) before the plain bf16 encoder
# rounded where XLA rounds, 0.949 and 1.149 after; 0.80–0.87 in the
# predictions.  It was 2.0.
BF16_E2E_MAX = 1.3
# What hold_bf16 holds.  HOLD_ALL (the flagship): of the sampler states and
# of the metric-space predictions, the held run's mean deviation from the run
# it is held against below the latter's from fp32, and its max within
# BF16_E2E_MAX times the latter's max.  HOLD_STATES_MEAN: the predictions'
# mean printed, not held (16, 17 and 51 nodes, the validation step; ROADMAP
# Queue C item 7).  HOLD_WIDTHS (the widths phase): as HOLD_STATES_MEAN, the
# max held being the held run's own from fp32, and the states' held-vs-against
# max held within WIDTHS_STATE_MAX.
HOLD_ALL, HOLD_STATES_MEAN, HOLD_WIDTHS = "all", "states mean", "widths"
# The widths phase's sampler states, kernels against plain: two bf16 steps of
# a value in [1, 2), twice the most that the sound chain reads at any width
# of the grid (one step, at G5, on four noise draws: chip_smoke and
# scripts/torch_widths_hold.py, H100 80GB HBM3, 700 W).
WIDTHS_STATE_MAX = 2 ** -6
# B8's mean deviation from its plain version may reach this share of the
# plain version's own mean deviation from K1's fp32 plain version (as the CPU
# tests hold the plain version to the Pallas kernel): leaving out any one of
# the merged kernel's rounding points reads 0.26–0.59× there.
B8_MEAN_SHARE = 0.1

# The eval phase: the synthetic AMASS test split (2 datasets × 25 clips × 480
# frames, a segment every 30 frames) has 550 segments, three batches of 256,
# the last padded.  The fp32 eval on the kernels against the same eval on the
# plain versions, per metric: |Δ| ≤ EVAL_KERNEL_TOL · max(1, |plain|) (the
# predictions differ by ≤ E2E_TOL; the metrics are means of their distances).
# ZeroVelocity on the card against the CPU: |Δ| ≤ EVAL_DEVICE_TOL ·
# max(1, |CPU|), the same float32 reductions in another order.  Relative for
# values ≥ 1; below, absolute, since some metrics are differences of nearly
# equal float32 values without a relative digit: ZeroVelocity's StretchMean
# on the rigid synthetic skeleton, 100·|mean limb length − the target's| /
# the target's, reads 3.37e-5 on the card and 3.23e-5 on the CPU (H100 80GB
# HBM3, 700 W).
EVAL_SEGMENTS = 550
EVAL_KERNEL_TOL = 1e-4
EVAL_DEVICE_TOL = 1e-5

# The train phase: the flagship's training batch (64 observations, k = 50
# samples each for the k-best choice), a few steps of each stage on the
# synthetic tree's train split (4 datasets × 25 clips × 480 frames), read
# with the flagship loader's augmentations.  The AutoEncoder's curriculum is
# that of AE_ITERS_PER_EPOCH iterations an epoch.  An fp32 step on the card
# against the same step on the CPU: loss within TRAIN_LOSS_TOL and gradient
# norm within TRAIN_GNORM_TOL, relative (the same float32 sums in another
# order, over 3 200 rows); the step after a restore from a checkpoint against
# the uninterrupted one within RESUME_TOL, relative (the backward's
# scatter-adds may sum in another order).
TRAIN_BATCH, TRAIN_K, TRAIN_STEPS = 64, 50, 10
TRAIN_DATASETS = ("ACCAD", "CMU", "BMLmovi", "KIT")
TRAIN_MIRRORING, TRAIN_ROTATIONS = 0.5, 1.0
AE_ITERS_PER_EPOCH = 580
TRAIN_LOSS_TOL = 1e-4
TRAIN_GNORM_TOL = 1e-3
RESUME_TOL = 1e-6

# The skeletons phase: the H36M, FreeMan and 3DPW zero-shot test splits of the
# shipped annotations (datasets/annotations/<folder>/hmp) with random-walk
# clips (data/synthetic.py::make_synthetic_skeleton_tree), each CSV cut to
# its first SKELETON_EVAL_CUT segments (of H36M's 5 168, FreeMan's 11 015,
# 3DPW's 3 252: the whole splits took 68 s, to keep the script within half
# its time limit);
# ZeroVelocity card vs CPU on the first SKELETON_CPU_SEGMENTS segments (two
# batches) at EVAL_DEVICE_TOL, FID left out there (its GRU h0 is drawn on
# each device); the H36M CLIs on a tree of SKELETON_CLI_SEGMENTS segments a
# CSV, CLI_ITERS iterations an epoch.
ANNOTATIONS = pathlib.Path(__file__).resolve().parent / "datasets" / "annotations"
SKELETON_EVALS = {"h36m": "Human36M", "freeman": "FreeMan", "3dpw": "3DPW",
                  "amass-mano": "AMASS-MANO"}
SKELETON_EVAL_CUT = 512
# The mano phase: AMASS-MANO's test split (12 726 segments; the CSV has 12 727
# lines with its header) cut to its first
# MANO_EVAL_CUT segments (2 batches of 256), to keep the script within half
# its time limit: a batch's prediction at 51 nodes takes ~1.7 s.
MANO_EVAL_CUT = 512
SKELETON_CPU_SEGMENTS = 2 * BATCH
SKELETON_CLI_SEGMENTS = 256
FID_GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "goldens" / "fid_classifier.npz"

# H100 SXM published peaks (NVIDIA data sheet, at 700 W): fp32 outside the
# tensor cores, dense bf16 and TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
PEAK_TF32_FLOP_S = 495e12
PEAK_BYTES_S = 3.35e12

# Launches a prediction on each path (10 steps; the denoiser's depth 4: 8
# ResnetBlocks and 7 attention layers before the final block).
EXPECTED_FP32 = {"gru_rollout": 1, "posterior_step": TIMESTEPS}
EXPECTED_BF16 = {"gru_rollout": 1, "posterior_step_x0_bf16": TIMESTEPS,
                 "graph_linear_fused": TIMESTEPS, "resnet_block": 8 * TIMESTEPS,
                 "rms_qkv": 7 * TIMESTEPS, "attention_core": 7 * TIMESTEPS,
                 "outproj_res": 7 * TIMESTEPS, "final_block_in": TIMESTEPS,
                 "final_block_out": TIMESTEPS}
EXPECTED_LAYER_FUSED = {"gru_rollout": 1, "posterior_step_x0_bf16": TIMESTEPS,
                        "stem_block": TIMESTEPS, "rms_qkv_core": 7 * TIMESTEPS,
                        "outproj_block": 7 * TIMESTEPS, "final_block_in": TIMESTEPS,
                        "final_block_out": TIMESTEPS}

# Every kernel's launch counter: name → (wrapper module, attribute).
COUNTERS = {
    "gru_rollout": (rollout_mod, "launches"),
    "gru_rollout_bf16": (rollout_mod, "launches_bf16"),
    "attention_core_fm": (fm_mod, "launches"),
    "posterior_step": (posterior_mod, "launches"),
    "posterior_step_x0_bf16": (posterior_mod, "launches_x0_bf16"),
    "graph_linear_fused": (stem_mod, "launches"),
    "resnet_block": (block_mod, "launches_block"),
    "rms_qkv": (proj_mod, "launches_rms_qkv"),
    "attention_core": (attn_mod, "launches"),
    "outproj_res": (proj_mod, "launches_outproj_res"),
    "final_block_in": (block_mod, "launches_final_in"),
    "final_block_out": (block_mod, "launches_final_out"),
    "stem_block": (layer_mod, "launches_stem_block"),
    "rms_qkv_core": (layer_mod, "launches_rms_qkv_core"),
    "outproj_block": (layer_mod, "launches_outproj_block"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, start: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - start:.3f} s")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, flops: float, tensor_flops: float = 0.0,
             tf32_flops: float = 0.0):
    """The least time for the work: bytes at the HBM rate against fp32 flops
    outside the tensor cores plus bf16 and TF32 flops on them."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = (flops / PEAK_FP32_FLOP_S + tensor_flops / PEAK_BF16_FLOP_S
             + tf32_flops / PEAK_TF32_FLOP_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def perturb_influence(module: torch.nn.Module, gen: torch.Generator) -> None:
    """A fresh model has G = I and ΔG = 0, which would leave every node mix
    trivial; move them off the identity as training does."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.rand(p.shape, generator=gen, device=gen.device).to(p.device)
            if leaf in ("G", "G0"):
                p.add_(0.2 * noise)
            elif leaf == "G_add":
                p.copy_(0.05 * (noise - 0.5))


def spread_weights(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Add N(0, 1/fan_in) to every weight bank and Dense kernel of the
    denoiser: at its init scale its x̂₀ is ~1e-2, a trained model's is O(1),
    and bf16 effects would otherwise sit in the last rounding of the output."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] in ("weight", "kernel"):
                noise = torch.randn(p.shape, generator=gen, device=gen.device).to(p.device)
                p.add_(noise / p.shape[-2] ** 0.5)


def build_model(device: torch.device, compute_dtype=None, use_fused_decode=None,
                dataset: str = "amass", ae_variant: dict | None = None, latent: int = LATENT,
                **variant):
    """(skeleton, predictor) of the flagship from seed ``SEED``, on the
    skeleton of ``dataset`` (SKELETONS: its joints and task lengths); the
    weights do not depend on ``compute_dtype`` (the denoiser's and the
    AutoEncoder's) or on the device.  ``variant`` holds create_diffusion keys
    that replace the flagship's (the process, the objective, DDIM, the
    activation, the conditioning, ``diffusion_arch``); ``ae_variant`` the
    AutoEncoder's model-variant keys (``recurrent_arch_enc``,
    ``recurrent_arch_decoder``, ``enc_num_layers``, ``z_activation``)."""
    joints, obs_len, pred_len = SKELETONS[dataset]
    skeleton = create_skeleton(
        dataset_name=dataset, motion_repr_type="SkeletonRescalePose", num_joints=joints,
        pose_box_size=1.5, obs_length=obs_len, pred_length=pred_len, if_consider_hip=False,
    )
    gen = torch.Generator().manual_seed(SEED)
    ae = AutoEncoder(skeleton.num_nodes, HIDDEN, HIDDEN, latent, gen,
                     node_types=skeleton.nodes_type_id, compute_dtype=compute_dtype,
                     **(ae_variant or {}))
    keys = dict(diffusion_conditioning=True, diffusion_timesteps=TIMESTEPS, diffusion_arch=ARCH)
    keys.update(variant)
    diffusion, denoiser = create_diffusion(
        skeleton, gen, latent_size=latent, device=device, compute_dtype=compute_dtype, **keys)
    perturb_influence(ae, gen)
    perturb_influence(denoiser, gen)
    spread_weights(denoiser, gen)
    predictor = SkeletonDiffusionPredictor(
        skeleton, ae, diffusion, num_samples=SAMPLES, pred_length=pred_len,
        use_fused_decode=use_fused_decode, device=device,
    )
    return skeleton, predictor


def k2_tf32_flops(n: int, cols: int, x0_bf16: bool) -> float:
    """TF32 flops of K2's route on the tensor cores: 3×TF32 takes three
    products a term (hi·lo, lo·hi, hi·hi), two for a bf16 x̂₀'s terms (no
    lo part), over the [N, 3N]·[3N, cols] contraction."""
    return 2.0 * n * n * cols * (3 + 3 + (2 if x0_bf16 else 3))


def check_posterior_step(predictor, gen: torch.Generator) -> dict:
    """K2 at the sampler's shapes [N, 12800, 96] (N = 21 on AMASS), both
    entries (x̂₀ fp32 and bf16), every t of the predictor's tables and of an
    isotropic process's diagonal ones, at 12 800, 12 795 and 12 790 rows and
    at [N, 12 799, 8] (a last 32-column tile 24 columns wide), against the
    plain version; the times of both entries, of the plain version, of
    ``torch.matmul`` on the stacked inputs and of the source's CUDA-core
    design.  Returns the fp32 entry's line (the bf16 entry's comes from
    ``check_denoiser_kernels``)."""
    n, rows = predictor.skeleton.num_nodes, BATCH * SAMPLES
    shape = (n, rows, LATENT)
    x0 = 1.5 * torch.randn(shape, generator=gen, device="cuda")  # some |x̂₀| > 1: clip matters
    xt = torch.randn(shape, generator=gen, device="cuda")
    eps = torch.randn(shape, generator=gen, device="cuda")
    tables = {"tables": predictor.diffusion.step_tables,
              "diagonal tables": build_isotropic_process(n, TIMESTEPS, device="cuda")
              .posterior_step_tables()}
    ragged = [1.5 * torch.randn((n, rows - 1, 8), generator=gen, device="cuda"),
              *(torch.randn((n, rows - 1, 8), generator=gen, device="cuda") for _ in range(2))]
    entries = {}
    for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        a, b = x0.to(dt), ragged[0].to(dt)
        errs = {}
        for cut in (rows, rows - RAGGED, rows - 2 * RAGGED):
            args = [t[:, :cut].contiguous() for t in (a, xt, eps)]
            for kind, table in tables.items():
                for t in range(table.shape[0]):
                    got = posterior_mod.posterior_step(*args, table[t])
                    want = posterior_mod.posterior_step_plain(*args, table[t])
                    torch.cuda.synchronize()
                    key = f"{cut} rows, {kind}"
                    errs[key] = max(errs.get(key, 0.0), (got - want).abs().max().item())
        for kind, table in tables.items():
            got = posterior_mod.posterior_step(b, *ragged[1:], table[TIMESTEPS // 2])
            want = posterior_mod.posterior_step_plain(b, *ragged[1:], table[TIMESTEPS // 2])
            torch.cuda.synchronize()
            errs[f"{rows - 1}×8, {kind}"] = (got - want).abs().max().item()
        err = max(errs.values())
        if not err <= K2_TOL:
            raise AssertionError(f"posterior_step ({label} x̂₀) disagrees with its plain version: "
                                 f"{errs}")
        m_t = tables["tables"][TIMESTEPS // 2]
        ms = cuda_ms(lambda: posterior_mod.posterior_step(a, xt, eps, m_t), reps=20)
        plain_ms = cuda_ms(lambda: posterior_mod.posterior_step_plain(a, xt, eps, m_t), reps=20)
        stacked = torch.cat([a.float().clamp(-1, 1), xt, eps]).reshape(3 * n, -1)
        library_ms = cuda_ms(lambda: torch.matmul(m_t, stacked), reps=20)
        core = posterior_mod.posterior_step_cuda_core(a, xt, eps, m_t)
        core_err = (core - posterior_mod.posterior_step_plain(a, xt, eps, m_t)).abs().max().item()
        if not core_err <= K2_TOL:
            raise AssertionError(f"posterior_step's CUDA-core design ({label} x̂₀) disagrees with "
                                 f"the plain version: {core_err}")
        core_ms = cuda_ms(lambda: posterior_mod.posterior_step_cuda_core(a, xt, eps, m_t),
                          reps=20)
        moved = (a.element_size() + 12) * x0.numel() + 4 * m_t.numel()
        bnd, by = bound_ms(moved, 0.0, tf32_flops=k2_tf32_flops(n, rows * LATENT, label == "bf16"))
        core_bnd, core_by = bound_ms(moved, 2.0 * n * 3 * n * rows * LATENT)
        log(f"posterior_step's CUDA-core design ({label} x̂₀, {n} nodes): {core_ms:.4f} ms, "
            f"max_abs_err {core_err:.3e}, bound {core_bnd:.4f} ms ({core_by}, FP32 FMAs)")
        log(f"posterior_step ({label} x̂₀, {n} nodes): max_abs_err {err:.3e} (tol {K2_TOL:.0e}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"), plan {posterior_mod.posterior_plan(n, dt)._asdict()}; {ms:.4f} ms/step, "
            f"plain {plain_ms:.4f} ms, library matmul {library_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
        entries[label] = {"name": "posterior_step", "route": "cuda", "nodes": n,
                          "source": "skeletondiffusion_tpu_torch/csrc/posterior_step.cu",
                          "replaces": "skeletondiffusion_tpu/ops/pallas/posterior_step.py:93",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": library_ms, "cuda_core_ms": core_ms}
    return entries["fp32"]


def rollout_inputs(predictor, gen: torch.Generator, compute_dtypes=(None,)) -> list:
    """The decoder's own rollout inputs for 12 800 rows (``rollout_args``: its
    hoisted cx, h0, gathered banks and normalized influences), one dict for
    each of ``compute_dtypes``, all from the same poses and latents."""
    dec = predictor.autoencoder.decoder
    n, rows = predictor.skeleton.num_nodes, BATCH * SAMPLES
    x = 0.3 * torch.randn((rows, 2, n, 3), generator=gen, device="cuda")
    z = torch.tanh(torch.randn((rows, n, LATENT), generator=gen, device="cuda"))
    with torch.no_grad():
        return [rollout_mod.rollout_args(dec, x, z, dt) for dt in compute_dtypes]


def odd_cluster_rows(plan) -> int:
    """The largest row count up to the bench's whose ``plan.rows``-row tiles
    fill an odd number of ``plan.cluster``-block clusters, the last one short
    of its last block: ODD_TILE_ROWS for K1's 8-row tiles."""
    clusters = -(-BATCH * SAMPLES // (plan.rows * plan.cluster))
    odd = clusters - 1 if clusters % 2 == 0 else clusters - 2
    return ((odd - 1) * plan.cluster + plan.cluster - 1) * plan.rows


def check_gru_rollout(predictor, gen: torch.Generator) -> dict:
    """K1 at the decode's shapes: cx [N, 12800, 288] (N = 21 on AMASS), the
    predictor's steps (120 on AMASS), against its plain version at 12 800
    rows, a ragged 12 795 and ``odd_cluster_rows`` (an odd number of its
    tiles and of its 4-block clusters: the last cluster's fourth block has
    no rows; 12 760 with the 8-row tiles, 12 790 with AMASS-MANO's 2)."""
    inp, = rollout_inputs(predictor, gen)
    rows, ph = BATCH * SAMPLES, predictor.pred_length
    n, _, h3 = inp["cx"].shape
    h, f = h3 // 3, inp["w_fc"].shape[-1]
    plan = rollout_mod.rollout_plan(n, h)
    resident = rollout_mod.resident_clusters(plan, n)
    rounds = -(-rows // (plan.rows * plan.cluster * resident))
    parts, err = [], 0.0
    with torch.no_grad():
        for cut in (rows, rows - RAGGED, odd_cluster_rows(plan)):
            args = {k: v[:, :cut].contiguous() if k in ("cx", "h0") else v for k, v in inp.items()}
            got = rollout_mod.gru_rollout(**args, ph=ph)
            want = rollout_mod.gru_rollout_plain(**args, ph=ph)
            torch.cuda.synchronize()
            cut_err = (got - want).abs().max().item()
            per_step = (got - want).abs().amax(dim=(1, 2, 3))
            if cut == rows:
                steps = sorted({0, ph // 4, ph // 2, ph - 1})
                parts.append(f"error at steps {[s + 1 for s in steps]}: "
                             f"{[f'{per_step[s].item():.2e}' for s in steps]}")
            parts.append(f"{cut} rows max {cut_err:.3e}")
            if not (got.shape == want.shape and cut_err <= K1_TOL):
                raise AssertionError(f"gru_rollout kernel disagrees with its plain version at "
                                     f"{cut} rows: {cut_err}")
            err = max(err, cut_err)
        ms = cuda_ms(lambda: rollout_mod.gru_rollout(**inp, ph=ph), reps=3)
        plain_ms = cuda_ms(lambda: rollout_mod.gru_rollout_plain(**inp, ph=ph), reps=2)
    # multiply-adds of the kernel's algorithm per row and step: the per-node
    # h·W_hh, one node mix for each of r and z, two for n, the head and its mix
    flops_row_step = 2 * n * h * 3 * h + 2 * n * n * h * 4 + 2 * n * h * f + 2 * n * n * f
    compulsory = sum(t.numel() for t in inp.values()) + ph * n * rows * f
    bnd, by = bound_ms(4.0 * compulsory, float(flops_row_step) * rows * ph)
    log(f"gru_rollout: max_abs_err {err:.3e} (tol {K1_TOL:.0e}); {'; '.join(parts)}; plan "
        f"{plan._asdict()}, {resident} clusters at once, {rounds} rounds at {rows} rows; "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.3f} ms ({by})")
    return {"name": "gru_rollout", "route": "cuda", "nodes": n, "steps": ph,
            "source": "skeletondiffusion_tpu_torch/csrc/gru_rollout.cu",
            "replaces": "skeletondiffusion_tpu/ops/pallas/gru_rollout.py:377",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def run_main_path(skeleton, predictor, obs: torch.Tensor, card_name: str, expected: dict,
                  label: str, rates: list | None = None) -> dict:
    """Timed predictions; every launch counter is set to 0 before each timed
    call and read after it.  Returns the launches of one call (and appends
    the preds/s to ``rates``)."""
    def predict(seed: int) -> torch.Tensor:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pred, _ = predictor(gen, obs)
        return skeleton.transform_to_metric_space(pred)

    out = predict(SEED)  # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for i in range(TIMED_CALLS):
        reset_counts()
        t0 = time.perf_counter()
        out = predict(SEED + 1 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(read_counts())
    expected = {name: expected.get(name, 0) for name in COUNTERS}
    if any(c != expected for c in counts):
        raise AssertionError(f"{label}: launch counts per prediction {counts}, expected {expected}")
    want_shape = (BATCH, SAMPLES, predictor.pred_length, skeleton.num_nodes, 3)
    if tuple(out.shape) != want_shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: prediction of shape {tuple(out.shape)} (want "
                             f"{want_shape}) or not finite")
    p50 = statistics.median(times)
    if rates is not None:
        rates.append(BATCH / p50)
    launched = {k: v for k, v in counts[-1].items() if v}
    log(f"{label}: {BATCH / p50:.2f} preds/s (batch {BATCH} × {SAMPLES} samples, median of "
        f"{TIMED_CALLS} calls {[round(t, 4) for t in times]} s) on {card_name}; "
        f"launches per prediction {launched}")
    return counts[-1]


def plain_kernels():
    """Every kernel wrapper replaced by its plain PyTorch version, as one
    context (an ``ExitStack`` of patches)."""
    stack = contextlib.ExitStack()
    for patch in [
        plain_rollouts(),
        mock.patch.object(posterior_mod, "posterior_step", posterior_mod.posterior_step_plain),
        mock.patch.object(stem_mod, "graph_linear_fused", stem_mod.graph_linear_fused_plain),
        mock.patch.object(block_mod, "resnet_block", block_mod.resnet_block_plain),
        mock.patch.object(block_mod, "final_block_in", block_mod.final_block_in_plain),
        mock.patch.object(block_mod, "final_block_out", block_mod.final_block_out_plain),
        mock.patch.object(proj_mod, "rms_qkv", proj_mod.rms_qkv_plain),
        mock.patch.object(proj_mod, "outproj_res", proj_mod.outproj_res_plain),
        mock.patch.object(attn_mod, "attention_core", attn_mod.attention_core_plain),
        mock.patch.object(layer_mod, "stem_block", layer_mod.stem_block_plain),
        mock.patch.object(layer_mod, "rms_qkv_core", layer_mod.rms_qkv_core_plain),
        mock.patch.object(layer_mod, "outproj_block", layer_mod.outproj_block_plain),
    ]:
        stack.enter_context(patch)
    return stack


def injected_run(skeleton, predictor, obs: torch.Tensor, start: torch.Tensor,
                 steps: torch.Tensor, plain: bool):
    """The metric-space prediction with injected sampler noise, and the
    sampler's state after each step; ``plain`` replaces every kernel wrapper
    with its plain PyTorch version (``plain_kernels``)."""
    states = []

    with plain_kernels() if plain else contextlib.nullcontext():
        step = posterior_mod.posterior_step

        def recording(*args):
            states.append(step(*args))
            return states[-1]

        with mock.patch.object(posterior_mod, "posterior_step", recording):
            pred, _ = predictor(None, obs, start_noise=start, step_noise=steps)
    return skeleton.transform_to_metric_space(pred), torch.stack(states)


def injected_noise(skeleton, gen: torch.Generator, latent: int = LATENT):
    rows, n = BATCH * SAMPLES, skeleton.num_nodes
    return (torch.randn((rows, n, latent), generator=gen, device="cuda"),
            torch.randn((rows, TIMESTEPS - 1, n, latent), generator=gen, device="cuda"))


def compare_with_plain(skeleton, predictor, obs: torch.Tensor, gen: torch.Generator) -> None:
    start, steps = injected_noise(skeleton, gen)
    fast, fast_states = injected_run(skeleton, predictor, obs, start, steps, plain=False)
    plain, plain_states = injected_run(skeleton, predictor, obs, start, steps, plain=True)
    torch.cuda.synchronize()
    # The sampler's states carry the O(1) injected noise, and of the two
    # kernels only K2 acts on them.
    for what, got, want in (("sampler states after each step", fast_states, plain_states),
                            ("prediction, metric space", fast, plain)):
        err = (got - want).abs().max().item()
        log(f"fp32 path with injected noise vs plain kernels: {what}: max_abs_err {err:.3e} "
            f"(tol {E2E_TOL:.0e}, |plain| ≤ {want.abs().max().item():.3f})")
        if not err <= E2E_TOL:
            raise AssertionError(f"end-to-end kernel path disagrees with the plain path in "
                                 f"the {what}: {err}")


def hold_bf16(label: str, runs: dict, pairs,
              states: str = "sampler states after each step", hold: str = HOLD_ALL) -> None:
    """For each (name of the run held, name of the run it is held against)
    in ``pairs``, the sampler's state after each step and the metric-space
    predictions of the two runs with injected noise, beside the deviation of
    the run held against from the ``"fp32"`` run (same weights and noise),
    as ``hold`` says (HOLD_ALL, HOLD_STATES_MEAN, HOLD_WIDTHS).

    The mean deviation must be below that one.  The max may reach
    BF16_E2E_MAX times its max: two bf16 paths that round at the same points
    but sum in another order disagree now and then on which side of a
    rounding point a value lands, and the flip, a whole bf16 step of an O(1)
    x̂₀, is carried through the later layers and steps, where the
    bf16-vs-fp32 deviation of the same value can stay below one step.
    HOLD_STATES_MEAN prints the predictions' mean ratio (the 16- and 17-node
    paths, ROADMAP Queue C item 7: there the decode turns a state ratio of
    0.91–0.99 into 1.02–1.11, whichever single kernel runs;
    scripts/torch_bf16_chain_split.py).  HOLD_WIDTHS holds the held run's
    own max from the fp32 run within BF16_E2E_MAX times the other's, and the
    states' held-vs-against max within WIDTHS_STATE_MAX: at G5 one flip of
    2^-7 in a sampler state (kernels against plain) exceeds 1.3× a
    plain-vs-fp32 max of ~0.0057, with B2 on its plain version too, while
    the kernel path's deviation from fp32 equals the plain path's
    (scripts/torch_widths_hold.py, which also reads the hold on planted
    faults; ROADMAP Queue C item 1)."""
    for held, against in pairs:
        for what, unit, scale, i in ((states, "", 1.0, 1),
                                     ("prediction, metric space", " mm", 1e3, 0)):
            a, b, c = runs[held][i], runs[against][i], runs["fp32"][i]
            kp, bf = (a - b).abs() * scale, (b - c).abs() * scale
            kp_max, kp_mean, bf_max, bf_mean = (kp.max().item(), kp.mean().item(),
                                                bf.max().item(), bf.mean().item())
            mean_held = i == 1 or hold == HOLD_ALL
            from_fp32 = hold == HOLD_WIDTHS
            top = (a - c).abs().max().item() * scale if from_fp32 else kp_max
            kp_limit = WIDTHS_STATE_MAX if from_fp32 and i == 1 else math.inf
            log(f"{label} with injected noise: {what}: {held} vs {against} max "
                f"{kp_max:.4e}{unit} mean {kp_mean:.4e}{unit}; {against} vs fp32 path max "
                f"{bf_max:.4e}{unit} mean {bf_mean:.4e}{unit} (max ratio {kp_max / bf_max:.3f}, "
                + (f"{'held ≤ ' + f'{kp_limit:.4e}' if kp_limit < math.inf else 'not held'}; "
                   f"{held} vs fp32 path max {top:.4e}{unit}, ratio {top / bf_max:.3f}, "
                   if from_fp32 else "")
                + f"bound {BF16_E2E_MAX}; mean ratio {kp_mean / bf_mean:.3f}, "
                f"{'bound < 1' if mean_held else 'not held: ROADMAP Queue C item 7'}; "
                f"|fp32| ≤ {c.abs().max().item() * scale:.4f}{unit})")
            if not ((kp_mean < bf_mean or not mean_held) and top <= BF16_E2E_MAX * bf_max
                    and kp_max <= kp_limit):
                raise AssertionError(f"{label}: {held} vs {against} in the {what}: max {kp_max}, "
                                     f"mean {kp_mean}, against the {against}-vs-fp32 deviation "
                                     f"(max {bf_max}, mean {bf_mean})"
                                     + (f"; {held} vs fp32 max {top}" if from_fp32 else ""))


def compare_bf16(skeleton, predictor, predictor_f32, obs: torch.Tensor,
                 gen: torch.Generator, hold: str = HOLD_ALL) -> None:
    """The bf16 path with injected noise: kernels against plain versions
    (``hold_bf16``, as ``hold`` says)."""
    start, steps = injected_noise(skeleton, gen, predictor.diffusion.seq_length)
    runs = {"kernels": injected_run(skeleton, predictor, obs, start, steps, plain=False),
            "plain": injected_run(skeleton, predictor, obs, start, steps, plain=True),
            "fp32": injected_run(skeleton, predictor_f32, obs, start, steps, plain=False)}
    torch.cuda.synchronize()
    hold_bf16("bf16 path", runs, [("kernels", "plain")], hold=hold)


@contextlib.contextmanager
def layer_fused_path():
    """SKELDIFF_LAYER_FUSED=1 inside the block, restored after it."""
    old = os.environ.get("SKELDIFF_LAYER_FUSED")
    os.environ["SKELDIFF_LAYER_FUSED"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SKELDIFF_LAYER_FUSED"]
        else:
            os.environ["SKELDIFF_LAYER_FUSED"] = old


def compare_layer_fused(skeleton, predictor, predictor_f32, obs: torch.Tensor,
                        gen: torch.Generator, hold: str = HOLD_ALL) -> None:
    """The layer-fused bf16 path with injected noise against the same path
    on plain versions and against the single-stage kernel path
    (``hold_bf16``, as ``hold`` says)."""
    start, steps = injected_noise(skeleton, gen, predictor.diffusion.seq_length)
    with layer_fused_path():
        runs = {"layer-fused kernels": injected_run(skeleton, predictor, obs, start, steps,
                                                    plain=False),
                "layer-fused plain": injected_run(skeleton, predictor, obs, start, steps,
                                                  plain=True)}
    runs["single-stage kernels"] = injected_run(skeleton, predictor, obs, start, steps,
                                                plain=False)
    runs["fp32"] = injected_run(skeleton, predictor_f32, obs, start, steps, plain=False)
    torch.cuda.synchronize()
    hold_bf16("layer-fused bf16 path", runs,
              [("layer-fused kernels", "layer-fused plain"),
               ("layer-fused kernels", "single-stage kernels")],
              hold=hold)


def bf16_errors(got: torch.Tensor, want: torch.Tensor):
    """(max |Δ|, mean |Δ|, max |want|) in fp32."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item(), want.float().abs().max().item()


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def cut_rows(args: list, rows: int, cut: int) -> list:
    """``args`` with every [·, rows, ·] tensor cut to its first ``cut`` rows."""
    return [a[:, :cut].contiguous() if torch.is_tensor(a) and a.dim() == 3 and
            a.shape[1] == rows else a for a in args]


def hold_at_rows(name: str, kernel, plain, args: list, cut: int) -> float:
    """The kernel against its plain version on ``args`` cut to ``cut`` rows,
    fp32 outputs at ≤ F32_TOL, bf16 at the bf16 criteria; the max |Δ|."""
    err = 0.0
    for g, w in zip(as_tuple(kernel(*args)), as_tuple(plain(*args))):
        mx, mean, ref = bf16_errors(g, w)
        err = max(err, mx)
        tol_ok = (mx <= F32_TOL) if g.dtype == torch.float32 else (
            mx <= BF16_MAX * ref and mean <= BF16_MEAN * ref)
        if g.shape[1] != cut or not tol_ok:
            raise AssertionError(f"{name} ({g.dtype}) at {cut} rows disagrees with its plain "
                                 f"version: {mx}")
    return err


def odd_tile_rows(tile_rows: int) -> int:
    """The largest row count up to the bench's that is a whole number of
    ``tile_rows`` tiles, an odd one: the walk's last cluster of two blocks
    then has one tile, and its second block none."""
    tiles = BATCH * SAMPLES // tile_rows
    return (tiles - 1 + tiles % 2) * tile_rows


def moved_bytes(tensors, roles=None, widths=None, which: int = 1) -> int:
    """The bytes of ``tensors`` (each input read once, each output written
    once).  ``roles``, a string a tensor, names its trailing axes that the
    chain pads ("." an axis kept): each named axis counts at
    ``widths[role][which]`` (0 the padded width, 1 the true one) and must be
    the padded width."""
    total = 0
    for t, r in zip(tensors, roles or [""] * len(tensors)):
        if not torch.is_tensor(t):
            continue
        shape = list(t.shape)
        for axis, role in enumerate(reversed(r), 1):
            if role != ".":
                if shape[-axis] != widths[role][0]:
                    raise AssertionError(f"axis -{axis} of a {tuple(t.shape)} tensor is not the "
                                         f"padded width of {role!r}, {widths[role][0]}")
                shape[-axis] = widths[role][which]
        total += math.prod(shape) * t.element_size()
    return total


def check_fused_kernel(name: str, kernel, plain, args: list, *, replaces: str, source: str,
                       tensor_flops=0.0, flops: float = 0.0, tf32_flops: float = 0.0,
                       library=None, products=None, f32: bool = True, odd_rows: tuple = (),
                       roles=None, widths=None, ragged: int = RAGGED) -> dict:
    """One kernel at the bench shapes: bf16 against its plain version, its
    fp32 instantiation, a ragged row count, with ``odd_rows`` (bf16, fp32)
    also those row counts (an odd number of the kernel's row tiles; the
    ragged one ``ragged`` rows short of the bench's), and its
    times (``products``: a call of the kernel's per-node products alone,
    timed as a yardstick).  Its bound counts the function at its true
    widths: ``widths`` maps a role to (the chain's padded width, the true
    one), ``roles`` names the padded axes of each of ``args`` and then of
    the outputs (``moved_bytes``), and ``tensor_flops`` is a number or a
    function of {role: width}; where the padded widths' bound differs it is
    ``padded_bound_ms``, the padding's cost beside the bound."""
    rows = BATCH * SAMPLES
    got, want = as_tuple(kernel(*args)), as_tuple(plain(*args))
    torch.cuda.synchronize()
    err, parts = 0.0, []
    for g, w in zip(got, want):
        mx, mean, ref = bf16_errors(g, w)
        err = max(err, mx)
        parts.append(f"max {mx:.3e} mean {mean:.3e} |ref| {ref:.3f}")
        if g.dtype == torch.float32:  # K2's output: fp32 sums of the same inputs
            ok = mx <= F32_TOL
        else:
            ok = mx <= BF16_MAX * ref and mean <= BF16_MEAN * ref
        if not ok:
            raise AssertionError(f"{name} (bf16) disagrees with its plain version: {parts[-1]}")
    f32_err = None
    a32 = [a.float() if torch.is_tensor(a) else a for a in args]
    if f32:
        f32_err = max((g - w).abs().max().item()
                      for g, w in zip(as_tuple(kernel(*a32)), as_tuple(plain(*a32))))
        if not f32_err <= F32_TOL:
            raise AssertionError(f"{name} (fp32) disagrees with its plain version: {f32_err}")
    cut = rows - ragged
    r_err = hold_at_rows(name, kernel, plain, cut_rows(args, rows, cut), cut)
    odd = "".join(f"; {dt} {n} rows {hold_at_rows(name, kernel, plain, cut_rows(a, rows, n), n):.3e}"
                  for dt, a, n in zip(("bf16", "fp32"), (args, a32), odd_rows))
    ms = cuda_ms(lambda: kernel(*args), reps=20)
    plain_ms = cuda_ms(lambda: plain(*args), reps=3)
    library_ms = cuda_ms(library, reps=20) if library is not None else None
    products_ms = cuda_ms(products, reps=20) if products is not None else None
    widths = widths or {}

    def bound_at(which: int):
        sizes = {role: w[which] for role, w in widths.items()}
        tensor = tensor_flops(sizes) if callable(tensor_flops) else tensor_flops
        return bound_ms(moved_bytes((*args, *got), roles, widths, which), flops, tensor,
                        tf32_flops)

    (bnd, by), (padded_bnd, _) = bound_at(1), bound_at(0)
    log(f"{name}: bf16 vs plain {'; '.join(parts)}; fp32 vs plain "
        f"{'—' if f32_err is None else f'{f32_err:.3e}'} (tol {F32_TOL:.0e}); {cut} rows "
        f"{r_err:.3e}{odd}; {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound {bnd:.4f} ms ({by})"
        + ("" if padded_bnd == bnd else f", at the padded widths {padded_bnd:.4f} ms")
        + ("" if products_ms is None else f", products-only bmm {products_ms:.4f} ms"))
    entry = {"name": name, "route": "cuda", "nodes": args[0].shape[0],
             "source": f"skeletondiffusion_tpu_torch/csrc/{source}",
             "replaces": f"skeletondiffusion_tpu/ops/pallas/{replaces}", "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
             "library_ms": library_ms}
    if padded_bnd != bnd:
        entry["padded_bound_ms"] = padded_bnd
    if products_ms is not None:
        entry["products_only_bmm_ms"] = products_ms
    return entry


def check_attention_head_groups(gen: torch.Generator, n: int, heads: int = 32,
                                rows: int = 1000) -> None:
    """B2 at ``n`` joints and ``heads`` heads, where a stage holds one row of
    a group of heads (three bulk copies a node, q, k and v of the group)
    rather than whole rows where one row of all heads does not fit two stages
    (at 21 joints; at 16 and 17 it fits, and an item is one whole row): bf16
    at the bf16 criteria and fp32 at F32_TOL against the plain version."""
    dh = ARCH["attn_dim_head"]
    qkv = torch.randn((n, rows, 3 * heads * dh), generator=gen, device="cuda")
    parts = []
    for dt in (torch.bfloat16, torch.float32):
        plan = attn_mod.attention_plan(dt, heads, dh, n)
        elem = torch.empty((), dtype=dt).element_size()
        whole_row_fits = attn_mod.plan_bytes(elem, 1, heads, dh, 2, n) <= attn_mod.MAX_SMEM
        if plan.rows != 1 or (plan.group_heads == heads) != whole_row_fits:
            raise AssertionError(f"attention_core: {heads} heads in {dt} at {n} joints take "
                                 f"the plan {plan}")
        x = qkv.to(dt)
        got = attn_mod.attention_core(x, heads=heads, dim_head=dh)
        want = attn_mod.attention_core_plain(x, heads, dh)
        mx, mean, ref = bf16_errors(got, want)
        ok = mx <= F32_TOL if dt == torch.float32 else (mx <= BF16_MAX * ref and
                                                         mean <= BF16_MEAN * ref)
        if not ok:
            raise AssertionError(f"attention_core at {heads} heads ({dt}) disagrees with its "
                                 f"plain version: max {mx}, mean {mean}, |ref| {ref}")
        parts.append(f"{str(dt).removeprefix('torch.')} (groups of {plan.group_heads}) max "
                     f"{mx:.3e}")
    log(f"attention_core at {n} joints, {heads} heads × {rows} rows: " + "; ".join(parts))


def products_only(*pairs):
    """One torch.bmm for each (x, w) of ``pairs``, the per-node products
    [N, B, K]·[N, K, F] in bf16 of a kernel alone (B3a and B9b: h·W_qkv; B1:
    x·W1, h·W2; B9c: a·W_out, o·W1, h·W2; B9a: x·W_s, r·W1, h·W2; B5a: x‖r·W1,
    x‖r·Wr; B5b: h·W2, o·Wh): the cuBLAS time of its product stage, a
    yardstick the port never calls."""
    return lambda: [torch.bmm(x, w) for x, w in pairs]


def engine_dtypes(n: int) -> tuple:
    """The element types the engine's kernels (B4, B1, B3a, B3b, B5a, B5b,
    B9a–c) take at ``n`` nodes: bf16 and fp32, or bf16 alone past
    build.NARROW_NODES, where the fp32 tiles do not fit (their plans refuse,
    ROADMAP Queue B item 10; ``check_refusals``)."""
    return (torch.bfloat16,) if build.wide(n) else (torch.bfloat16, torch.float32)


def odd_qkv_rows(plan_of, n: int, dtypes: tuple | None = None) -> tuple:
    """B3a's and B9b's odd-tile row counts at ``n`` nodes for each of
    ``dtypes`` (``engine_dtypes``): ODD_TILE_ROWS with the 21-node tiles of
    32 rows (bf16) and 8 (fp32), else from the plan's rows
    (``plan_of(dtype)``)."""
    dtypes = engine_dtypes(n) if dtypes is None else dtypes
    return tuple(ODD_TILE_ROWS if not build.wide(n) and plan_of(dt).rows in (32, 8)
                 else odd_tile_rows(plan_of(dt).rows) for dt in dtypes)


def engine_check_widths(predictor, flagship: bool):
    """(the chain's widths, the element types its engine kernels are
    checked in, whether in fp32 too) of a bf16 predictor: fp32 where its
    plans fit for the flagship's widths (``engine_dtypes``); bf16 alone at
    the widths phase's (the route takes the chain in bf16 only)."""
    n = predictor.skeleton.num_nodes
    dts = engine_dtypes(n) if flagship else (torch.bfloat16,)
    return predictor.diffusion.fused["widths"], dts, flagship and not build.wide(n)


def padding_roles(w) -> dict:
    """role → (the chain's padded width, the true one) for ``moved_bytes``:
    F ("f"), a FiLM row's or the final block's x‖skip two halves ("e"), D
    ("d"), the head's output ("o"), heads × dh ("h") and q‖k‖v ("q") of
    the chain's widths ``w``."""
    hd, hd_pad = w.heads * w.dim_head, w.heads * w.width
    return {"f": (w.f_pad, w.f), "e": (2 * w.f_pad, 2 * w.f), "d": (w.d_pad, w.d),
            "o": (w.out_pad, w.out), "h": (hd_pad, hd), "q": (3 * hd_pad, 3 * hd)}


def check_denoiser_kernels(predictor, gen: torch.Generator, flagship: bool = True) -> list:
    """The fused denoiser's kernels and K2's bf16-x̂₀ entry on the bench
    shapes, on the bf16 model's own operands (padded to the chain's widths)
    and activations drawn from ``gen`` (each kernel's input is what the one
    before it produced; K2 at the true latent width, as the sampler gives
    it); the engine's kernels in fp32 too where ``engine_check_widths``
    says, B2 in fp32 at every width; B2's head groups at the flagship's
    (``flagship``).  Bounds at the true widths (``padding_roles``)."""
    bf16 = torch.bfloat16
    diff, den = predictor.diffusion, predictor.diffusion.denoiser
    pre, n, rows = diff.fused, predictor.skeleton.num_nodes, BATCH * SAMPLES
    w, dts, f32 = engine_check_widths(predictor, flagship)
    f, d, fo = w.f_pad, w.d_pad, w.out_pad
    heads, dh, width = w.heads, w.dim_head, w.width
    hd, pads = heads * width, padding_roles(w)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(bf16)

    with torch.no_grad():
        if flagship:
            check_attention_head_groups(torch.Generator(device="cuda").manual_seed(SEED), n)
        tt = torch.tanh(den.time_embedding(TIMESTEPS // 2, torch.device("cuda")))
        u = denoiser_fused.pad_condition(pre, den.cond_embedding(torch.tanh(torch.randn(
            (rows, n, w.d), generator=gen, device="cuda"))))
        stem, blk, att, fin, head = (pre["stem"], pre["blocks"][0], pre["attns"][0],
                                     pre["final"], pre["head"])
        film = denoiser_fused._film(blk["film"], tt, bf16, f)
        film_f = denoiser_fused._film(fin["film"], tt, bf16, f)
        x_lat, r = rnd(n, rows, d), rnd(n, rows, f, scale=0.5)
        x = stem_mod.graph_linear_fused(x_lat, stem["w"], stem["b"], stem["g"], u)
        qkv = proj_mod.rms_qkv(x, att["g_rms"], att["w_qkv"], att["g_qkv"])
        core = attn_mod.attention_core(qkv, heads=heads, dim_head=dh)
        h, res = block_mod.final_block_in(x, r, film_f, fin["w1"], fin["b1"], fin["g1"],
                                          fin["wr"], fin["gr"])
        xr = torch.cat([x, r], dim=-1)  # B5a's contraction input, for its products-only bmm
        o = (torch.tanh(stem_mod.mix_plain(fin["g2"], stem_mod.product_plain(
            h, fin["w2"], fin["b2"]).to(bf16))) + res.float()).to(bf16)  # B5b's head input
        x0 = rnd(n, rows, w.d, scale=1.5)
        xt, eps = (torch.randn((n, rows, w.d), generator=gen, device="cuda") for _ in range(2))
        m_t = diff.step_tables[TIMESTEPS // 2]
        # SDPA on the true head width: [rows·heads, n, dh] from the padded bank
        q, k, v = (t.reshape(n, rows, heads, width)[..., :dh].permute(1, 2, 0, 3)
                   .reshape(rows * heads, n, dh).contiguous() for t in qkv.split(hd, dim=-1))
        stacked = torch.cat([x0.float().clamp(-1, 1), xt, eps]).reshape(3 * n, -1)
        mix = lambda width: 2.0 * n * n * rows * width  # noqa: E731
        prod = lambda k_, o: 2.0 * n * rows * k_ * o  # noqa: E731
        core_flops = lambda s: 4.0 * rows * n * n * s["h"]  # noqa: E731
        chain = functools.partial(check_fused_kernel, widths=pads)
        entries = [
            chain(
                "graph_linear_fused", stem_mod.graph_linear_fused,
                stem_mod.graph_linear_fused_plain, [x_lat, stem["w"], stem["b"], stem["g"], u],
                replaces="graph_linear_fused.py:70", source="graph_linear_fused.cu",
                tensor_flops=lambda s: prod(s["d"], s["f"]) + mix(s["f"]),
                roles=("d", "df", "f", "", "f", "f"),
                odd_rows=tuple(odd_tile_rows(stem_mod.graph_linear_fused_plan(dt, d, f, n).rows)
                               for dt in dts), f32=f32),
            chain(
                "resnet_block", block_mod.resnet_block, block_mod.resnet_block_plain,
                [x, film, blk["w1"], blk["b1"], blk["g1"], blk["w2"], blk["b2"], blk["g2"]],
                replaces="resnet_block.py:134", source="resnet_block.cu",
                tensor_flops=lambda s: 2 * (prod(s["f"], s["f"]) + mix(s["f"])),
                roles=("f", "e", "ff", "f", "", "ff", "f", "", "f"),
                products=products_only((x, blk["w1"]), (x, blk["w2"])),
                odd_rows=tuple(odd_tile_rows(block_mod.resnet_block_plan(dt, f, n).rows)
                               for dt in dts), f32=f32),
            chain(
                "rms_qkv", proj_mod.rms_qkv, proj_mod.rms_qkv_plain,
                [x, att["g_rms"], att["w_qkv"], att["g_qkv"]], replaces="attention_proj.py:114",
                source="attention_proj.cu",
                tensor_flops=lambda s: prod(s["f"], s["q"]) + mix(s["q"]),
                roles=("f", "f", "fq", "", "q"),
                products=products_only((x, att["w_qkv"])), f32=f32,
                odd_rows=odd_qkv_rows(lambda dt: proj_mod.rms_qkv_plan(dt, f, 3 * hd, n), n,
                                      dts)),
            chain(
                "attention_core", functools.partial(attn_mod.attention_core, heads=heads,
                                                    dim_head=dh),
                functools.partial(attn_mod.attention_core_plain, heads=heads, dim_head=dh),
                [qkv], replaces="joint_attention.py:124", source="joint_attention.cu",
                tensor_flops=core_flops, roles=("q", "h"),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                odd_rows=tuple(odd_tile_rows(attn_mod.attention_plan(dt, heads, width, n).rows)
                               for dt in (bf16, torch.float32))),
            chain(
                "outproj_res", proj_mod.outproj_res, proj_mod.outproj_res_plain,
                [core, x, att["w_out"], att["g_out"]], replaces="attention_proj.py:143",
                source="attention_proj.cu",
                tensor_flops=lambda s: prod(s["h"], s["f"]) + mix(s["f"]),
                roles=("h", "f", "hf", "", "f"),
                products=products_only((core, att["w_out"])),
                odd_rows=tuple(odd_tile_rows(proj_mod.outproj_res_plan(dt, hd, f, n).rows)
                               for dt in dts), f32=f32),
            chain(
                "final_block_in", block_mod.final_block_in, block_mod.final_block_in_plain,
                [x, r, film_f, fin["w1"], fin["b1"], fin["g1"], fin["wr"], fin["gr"]],
                replaces="resnet_block.py:351", source="resnet_block.cu",
                tensor_flops=lambda s: 2 * (prod(s["e"], s["f"]) + mix(s["f"])),
                roles=("f", "f", "e", "ef", "f", "", "ef", "", "f", "f"),
                products=products_only((xr, fin["w1"]), (xr, fin["wr"])),
                odd_rows=tuple(odd_tile_rows(block_mod.final_block_in_plan(dt, f, n).rows)
                               for dt in dts), f32=f32),
            chain(
                "final_block_out", block_mod.final_block_out, block_mod.final_block_out_plain,
                [h, res, fin["w2"], fin["b2"], fin["g2"], head["w"], head["b"], head["g"]],
                replaces="resnet_block.py:372", source="resnet_block.cu",
                tensor_flops=lambda s: (prod(s["f"], s["f"]) + mix(s["f"]) + prod(s["f"], s["o"])
                                        + mix(s["o"])),
                roles=("f", "f", "ff", "f", "", "fo", "o", "", "o"),
                products=products_only((h, fin["w2"]), (o, head["w"])),
                odd_rows=tuple(odd_tile_rows(block_mod.final_block_out_plan(dt, f, fo, n).rows)
                               for dt in dts), f32=f32),
            check_fused_kernel(
                "posterior_step_x0_bf16", posterior_mod.posterior_step,
                posterior_mod.posterior_step_plain, [x0, xt, eps, m_t],
                replaces="posterior_step.py:93", source="posterior_step.cu",
                tf32_flops=k2_tf32_flops(n, rows * w.d, True), f32=False,
                library=lambda: torch.matmul(m_t, stacked),
                # a row count whose B·D the bf16 entry takes (a multiple of 8)
                ragged=next(r for r in range(RAGGED, rows) if (rows - r) * w.d % 8 == 0)),
        ]
        return entries


def check_stem_bits(x, u, film, ws, bs, gs, block: tuple) -> None:
    """B4's output against B9a's r on the same inputs, bit for bit, in bf16
    and fp32 at 12 800 and a ragged 12 795 rows: B4 runs B9a's stem pass
    alone (the same k-slices, products and mix), so the single-stage and the
    layer-fused bf16 paths compute the same block 0 (bf16 alone where the
    fp32 plans do not fit, ``engine_dtypes``)."""
    rows, parts = BATCH * SAMPLES, []
    for dt in engine_dtypes(x.shape[0]):
        args = [t.to(dt) for t in (x, u, film, ws, bs, gs, *block)]
        for cut in (rows, rows - RAGGED):
            xc, uc, *rest = cut_rows(args, rows, cut)
            r, _ = layer_mod.stem_block(xc, uc, *rest)
            got = stem_mod.graph_linear_fused(xc, rest[1], rest[2], rest[3], uc)
            torch.cuda.synchronize()
            if not (got.shape == r.shape and torch.equal(got, r)):
                raise AssertionError(f"graph_linear_fused ({dt}, {cut} rows) differs from "
                                     f"stem_block's r: max {(got.float() - r.float()).abs().max()}")
            parts.append(f"{str(dt).removeprefix('torch.')} {cut} rows")
    log("graph_linear_fused equals stem_block's r bit for bit: " + ", ".join(parts))


def check_layer_fused_kernels(predictor, gen: torch.Generator, flagship: bool = True) -> list:
    """The layer-fused denoiser's kernels (B9a–c) on the bench shapes, on the
    bf16 model's own operands (padded to the chain's widths) and activations
    drawn from ``gen`` (each kernel's input is what the one before it
    produced); B4's output against B9a's r bit for bit (``flagship``).
    Bounds at the true widths (``padding_roles``)."""
    bf16 = torch.bfloat16
    diff, den = predictor.diffusion, predictor.diffusion.denoiser
    pre, n, rows = diff.fused, predictor.skeleton.num_nodes, BATCH * SAMPLES
    w, dts, f32 = engine_check_widths(predictor, flagship)
    f, d = w.f_pad, w.d_pad
    heads, dh, width = w.heads, w.dim_head, w.width
    hd, pads = heads * width, padding_roles(w)
    banks = denoiser_fused._block_banks

    with torch.no_grad():
        tt = torch.tanh(den.time_embedding(TIMESTEPS // 2, torch.device("cuda")))
        u = denoiser_fused.pad_condition(pre, den.cond_embedding(torch.tanh(torch.randn(
            (rows, n, w.d), generator=gen, device="cuda"))))
        stem, att, blk0, blk1 = pre["stem"], pre["attns"][0], pre["blocks"][0], pre["blocks"][1]
        film0 = denoiser_fused._film(blk0["film"], tt, bf16, f)
        film1 = denoiser_fused._film(blk1["film"], tt, bf16, f)
        x_lat = torch.randn((n, rows, d), generator=gen, device="cuda").to(bf16)
        r, x = layer_mod.stem_block(x_lat, u, film0, stem["w"], stem["b"], stem["g"],
                                    *banks(blk0))
        if flagship:
            check_stem_bits(x_lat, u, film0, stem["w"], stem["b"], stem["g"], banks(blk0))
        core = layer_mod.rms_qkv_core(x, att["g_rms"], att["w_qkv"], att["g_qkv"], heads=heads,
                                      dim_head=dh)
        mix = lambda width: 2.0 * n * n * rows * width  # noqa: E731
        prod = lambda k_, o: 2.0 * n * rows * k_ * o  # noqa: E731
        block = lambda s: 2 * (prod(s["f"], s["f"]) + mix(s["f"]))  # noqa: E731
        banks_roles = ("ff", "f", "", "ff", "f", "")
        chain = functools.partial(check_fused_kernel, widths=pads)
        return [
            chain(
                "stem_block", layer_mod.stem_block, layer_mod.stem_block_plain,
                [x_lat, u, film0, stem["w"], stem["b"], stem["g"], *banks(blk0)],
                replaces="layer_fused.py:233", source="layer_fused.cu",
                tensor_flops=lambda s: prod(s["d"], s["f"]) + mix(s["f"]) + block(s),
                roles=("d", "f", "e", "df", "f", "", *banks_roles, "f", "f"),
                products=products_only((x_lat, stem["w"]), (r, blk0["w1"]), (r, blk0["w2"])),
                odd_rows=tuple(odd_tile_rows(layer_mod.stem_block_plan(dt, d, f, n).rows)
                               for dt in dts), f32=f32),
            chain(
                "rms_qkv_core",
                functools.partial(layer_mod.rms_qkv_core, heads=heads, dim_head=dh),
                functools.partial(layer_mod.rms_qkv_core_plain, heads=heads, dim_head=dh),
                [x, att["g_rms"], att["w_qkv"], att["g_qkv"]], replaces="layer_fused.py:285",
                source="layer_fused.cu",
                tensor_flops=lambda s: (prod(s["f"], s["q"]) + mix(s["q"])
                                        + 4.0 * rows * n * n * s["h"]),
                roles=("f", "f", "fq", "", "h"),
                products=products_only((x, att["w_qkv"])), f32=f32,
                odd_rows=odd_qkv_rows(
                    lambda dt: layer_mod.rms_qkv_core_plan(dt, f, heads, width, n), n, dts)),
            chain(
                "outproj_block", layer_mod.outproj_block, layer_mod.outproj_block_plain,
                [core, x, film1, att["w_out"], att["g_out"], *banks(blk1)],
                replaces="layer_fused.py:325", source="layer_fused.cu",
                tensor_flops=lambda s: prod(s["h"], s["f"]) + mix(s["f"]) + block(s),
                roles=("h", "f", "e", "hf", "", *banks_roles, "f"),
                products=products_only((core, att["w_out"]), (x, blk1["w1"]), (x, blk1["w2"])),
                odd_rows=tuple(odd_tile_rows(layer_mod.outproj_block_plan(dt, hd, f, n).rows)
                               for dt in dts), f32=f32),
        ]


def check_bf16_errors(name: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """Raise unless ``got`` meets the bf16 criteria against ``want``."""
    mx, mean, ref = bf16_errors(got, want)
    if tuple(got.shape) != tuple(want.shape) or not (mx <= BF16_MAX * ref
                                                      and mean <= BF16_MEAN * ref):
        raise AssertionError(f"{name} disagrees with its plain version: shape "
                             f"{tuple(got.shape)}, max {mx}, mean {mean}, |ref| {ref}")
    return f"max {mx:.3e} mean {mean:.3e} |ref| {ref:.3f}"


def check_gru_rollout_bf16(predictor, gen: torch.Generator, k1_ms: float) -> dict:
    """B8 at the decode's shapes on the predictor's decoder's own rollout
    inputs (cx, W_hh and W_fc in bf16), at 12 800, 12 795 and an odd-tile
    count (up to 21 nodes ODD_TILE_ROWS: 1 595 of its 8-row tiles, the last
    two-block cluster's second block without rows; past 21 ``odd_cluster_rows``
    of its 4-row tiles), the predictor's steps: the bf16 criteria against its
    plain version, and a mean deviation of at most B8_MEAN_SHARE× the plain
    version's own from K1's plain version on the same inputs in fp32; timed
    beside K1's ``k1_ms`` from the same call."""
    inp32, inp = rollout_inputs(predictor, gen, (None, torch.bfloat16))
    rows, ph = BATCH * SAMPLES, predictor.pred_length
    n, _, h3 = inp["cx"].shape
    h, f = h3 // 3, inp["w_fc"].shape[-1]
    plan = rollout_mod.rollout_bf16_plan(n, h, f)
    odd = ODD_TILE_ROWS if not build.wide(n) else odd_cluster_rows(plan)
    parts, err = [], 0.0
    with torch.no_grad():
        for cut in (rows, rows - RAGGED, odd):
            args, args32 = ({k: v[:, :cut].contiguous() if k in ("cx", "h0") else v
                             for k, v in a.items()} for a in (inp, inp32))
            got = rollout_mod.gru_rollout(**args, ph=ph, compute_dtype=torch.bfloat16)
            want = rollout_mod.gru_rollout_merged_plain(**args, ph=ph)
            own = (want - rollout_mod.gru_rollout_plain(**args32, ph=ph)).abs().mean()
            torch.cuda.synchronize()
            mean, own = (got - want).abs().mean().item(), own.item()
            parts.append(f"{cut} rows {check_bf16_errors('gru_rollout_bf16', got, want)}, "
                         f"{mean / own:.4f}× the plain version's mean {own:.3e} from fp32 "
                         f"(bound {B8_MEAN_SHARE})")
            if not mean <= B8_MEAN_SHARE * own:
                raise AssertionError(f"gru_rollout_bf16 at {n} nodes, {cut} rows: mean {mean} "
                                     f"from its plain version, its plain version's from fp32 "
                                     f"{own}")
            err = max(err, (got - want).abs().max().item())
        ms = cuda_ms(lambda: rollout_mod.gru_rollout(**inp, ph=ph,
                                                     compute_dtype=torch.bfloat16), reps=3)
        plain_ms = cuda_ms(lambda: rollout_mod.gru_rollout_merged_plain(**inp, ph=ph), reps=2)
    # the kernel's algorithm per row and step, as check_gru_rollout counts it:
    # the bf16 products and node mixes (tensor-core operands), the fp32 head mix
    tensor_row_step = 2 * n * h * 3 * h + 2 * n * n * h * 4 + 2 * n * h * f
    compulsory = (sum(t.numel() * t.element_size() for t in inp.values())
                  + 4 * ph * n * rows * f)
    bnd, by = bound_ms(compulsory, 2.0 * n * n * f * rows * ph,
                       float(tensor_row_step) * rows * ph)
    log(f"gru_rollout_bf16 ({n} nodes, {ph} steps, plan {tuple(plan)}): {'; '.join(parts)}; "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library none, bound {bnd:.3f} ms ({by}); K1 "
        f"{k1_ms:.3f} ms in this call (B8 / K1 {ms / k1_ms:.3f})")
    return {"name": "gru_rollout_bf16", "route": "cuda", "nodes": n, "steps": ph,
            "source": "skeletondiffusion_tpu_torch/csrc/gru_rollout_merged.cu",
            "replaces": "skeletondiffusion_tpu/ops/pallas/gru_rollout.py:377",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def plain_rollouts():
    """Patch the rollout wrapper to its plain versions (both dtypes)."""
    def plain(*, ph, compute_dtype=None, **tensors):
        if compute_dtype == torch.bfloat16:
            return rollout_mod.gru_rollout_merged_plain(**tensors, ph=ph)
        return rollout_mod.gru_rollout_plain(**tensors, ph=ph)
    return mock.patch.object(rollout_mod, "gru_rollout", plain)


def run_decode_check(card_name: str) -> dict:
    """The decode check's entry point with every launch counter set to 0
    before it and read after it; its B8-vs-K1 metric-space deviation held
    against the plain versions' (merged plain against fp32 plain) on the same
    model and inputs.  Returns the launches of the run."""
    reset_counts()
    result = decode_check.run()
    torch.cuda.synchronize()
    counts = read_counts()
    calls = 1 + decode_check.TIMED_CALLS
    expected = {name: 0 for name in COUNTERS}
    expected.update(gru_rollout=calls, gru_rollout_bf16=calls)
    if counts != expected:
        raise AssertionError(f"decode check: launch counts {counts}, expected {expected}")
    log(f"decode check on {card_name}: {json.dumps(result)}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    skeleton, dec, x_last2, z = decode_check.setup()
    with plain_rollouts():
        plain = decode_check.decode_deviation(skeleton, dec, x_last2, z, decode_check.PH)
    kernel_mean, plain_mean = result["mm_mean"], plain.mean().item()
    log(f"decode check, metric space: B8 vs K1 mean {kernel_mean:.4f} mm max "
        f"{result['mm_max']:.4f} mm; merged plain vs fp32 plain mean {plain_mean:.4f} mm max "
        f"{plain.max().item():.4f} mm (ratio {kernel_mean / plain_mean:.3f}, bounds "
        f"1/{BF16_E2E_MAX} and {BF16_E2E_MAX})")
    finite = all(math.isfinite(v) for v in result.values() if isinstance(v, float))
    if not (finite and plain_mean <= BF16_E2E_MAX * kernel_mean
            and kernel_mean <= BF16_E2E_MAX * plain_mean):
        raise AssertionError(f"decode check: B8 vs K1 mean {kernel_mean} mm against the plain "
                             f"pair's {plain_mean} mm")
    return counts


def peak_extra_bytes(fn) -> int:
    """Device memory allocated by ``fn`` at its peak, above what was allocated
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# L1's items take 16 batch columns (fp32: 8) of one head: at this count, a
# multiple of 8 (so its TMA copies address it), both have an odd number of
# column tiles (799 and 1 597), the last bf16 tile half past the batch.  Past
# 21 nodes an item takes 8 (fp32: 4): 1 597 tiles in bf16, and in fp32 4 rows
# fewer (3 193 tiles; ``fm_odd_rows``).
FM_ODD_TILE_ROWS = 12_776


def fm_odd_rows(dtype: torch.dtype, n: int) -> int:
    """FM_ODD_TILE_ROWS, or 4 rows fewer where its column tiles of L1's plan
    at ``n`` nodes are even in number."""
    cols = fm_mod.cols(dtype, n)
    return FM_ODD_TILE_ROWS if -(-FM_ODD_TILE_ROWS // cols) % 2 else FM_ODD_TILE_ROWS - 4


def check_attention_core_fm(gen: torch.Generator, n: int = 21) -> dict:
    """L1 at the lab's shapes (8 heads × 32) at ``n`` joints in bf16 and fp32,
    at 12 800 rows, a ragged 12 795 (no TMA copies: the producer's own
    loads) and ``fm_odd_rows``, and at 32 heads × 1 000 rows; timed in bf16
    beside its bound, its plain version, scaled_dot_product_attention on [B,
    heads, n, dh] views of the feature-major tensor, and B2 on the same data
    in batch-major."""
    heads, dh, rows = attn_lab.H, attn_lab.DH, BATCH * SAMPLES
    hd = heads * dh
    core = functools.partial(fm_mod.attention_core_fm, heads=heads, dim_head=dh)
    parts, err = [], 0.0
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for h, cut in ((heads, rows), (heads, rows - RAGGED), (heads, fm_odd_rows(dtype, n)),
                           (32, 1000)):
                qkv = (0.5 * torch.randn((n, 3 * h * dh, cut), generator=gen,
                                         device="cuda")).to(dtype)
                got = fm_mod.attention_core_fm(qkv, heads=h, dim_head=dh)
                want = fm_mod.attention_core_fm_plain(qkv, h, dh)
                torch.cuda.synchronize()
                what = f"{h} heads × {cut} rows"
                if dtype == torch.float32:
                    mx = (got - want).abs().max().item()
                    if not (got.shape == want.shape and mx <= F32_TOL):
                        raise AssertionError(f"attention_core_fm (fp32, {n} nodes, {what}) "
                                             f"disagrees with its plain version: {mx}")
                    parts.append(f"fp32 {what} max {mx:.3e}")
                else:
                    parts.append(f"bf16 {what} "
                                 + check_bf16_errors("attention_core_fm", got, want))
                    err = max(err, (got.float() - want.float()).abs().max().item())
        qkv = (0.5 * torch.randn((n, 3 * hd, rows), generator=gen, device="cuda")).to(torch.bfloat16)
        qkv_bm = qkv.transpose(1, 2).contiguous()
        q, k, v = (t.view(n, heads, dh, rows).permute(3, 1, 0, 2) for t in qkv.split(hd, dim=1))
        out = core(qkv)
        ms = cuda_ms(lambda: core(qkv), reps=20)
        plain_ms = cuda_ms(lambda: fm_mod.attention_core_fm_plain(qkv, heads, dh), reps=3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(q, k, v), reps=20)
        # whether the call copies the strided views: its peak memory beside
        # the same call's on contiguous copies
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        contiguous_ms = cuda_ms(lambda: sdpa(qc, kc, vc), reps=20)
        extra_mb = [peak_extra_bytes(lambda a=a: sdpa(*a)) / 1e6 for a in ((q, k, v), (qc, kc, vc))]
        b2_ms = cuda_ms(lambda: attn_mod.attention_core(qkv_bm, heads=heads, dim_head=dh), reps=20)
    moved = qkv.numel() * qkv.element_size() + out.numel() * out.element_size()
    bnd, by = bound_ms(moved, 0.0, 4.0 * rows * heads * n * n * dh)
    log(f"attention_core_fm ({n} nodes, plan {tuple(fm_mod.fm_plan(torch.bfloat16, heads, dh, n))}"
        f"): {'; '.join(parts)}; {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms (scaled_dot_product_attention on views with a last-dim stride of "
        f"{q.stride(-1)}; {contiguous_ms:.4f} ms on contiguous copies; peak memory of one call "
        f"{extra_mb[0]:.1f} MB on the views, {extra_mb[1]:.1f} MB on the copies, q, k and v "
        f"{qc.numel() * qc.element_size() / 1e6:.1f} MB each), B2 batch-major {b2_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by})")
    return {"name": "attention_core_fm", "route": "cuda", "nodes": n,
            "source": "skeletondiffusion_tpu_torch/csrc/attention_core_fm.cu",
            "replaces": "scripts/attn_core_lab.py:66", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


def run_count_paths(predictor, gen: torch.Generator, card_name: str) -> dict:
    """The paths of B8 and L1 at the predictor's node count: a bf16 decode
    of its decoder (``decode_rollout``, the decode check's call) on 12 800
    rows over its steps, then the attention lab's feature-major chain
    (``chain_fm``, DEPTH calls) on the lab's shapes at that count; every
    launch counter set to 0 before each and read after it.  Returns
    {kernel: launches}."""
    n, rows, ph = predictor.skeleton.num_nodes, BATCH * SAMPLES, predictor.pred_length
    x_last2 = 0.2 * torch.randn((rows, 2, n, 3), generator=gen, device="cuda")
    z = torch.randn((rows, n, LATENT), generator=gen, device="cuda")
    qkv = (0.5 * torch.randn((n, 3 * attn_lab.HD, rows), generator=gen, device="cuda")
           ).to(torch.bfloat16)
    launches = {}
    for name, run, want in (
            ("gru_rollout_bf16", lambda: rollout_mod.decode_rollout(
                predictor.autoencoder.decoder, x_last2, z, ph, compute_dtype=torch.bfloat16), 1),
            ("attention_core_fm", lambda: attn_lab.chain_fm(qkv), attn_lab.DEPTH)):
        reset_counts()
        with torch.no_grad():
            out = run()
        torch.cuda.synchronize()
        counts = read_counts()
        expected = {k: 0 for k in COUNTERS}
        expected[name] = want
        if counts != expected or not torch.isfinite(out).all():
            raise AssertionError(f"{name}'s path at {n} nodes: launch counts {counts}, expected "
                                 f"{expected}, finite {bool(torch.isfinite(out).all())}")
        launches[name] = counts[name]
    log(f"B8 and L1 paths at {n} nodes on {card_name}: a bf16 decode of {rows} rows × {ph} "
        f"steps and the lab's chain of {attn_lab.DEPTH} calls; launches {launches}")
    return launches


def run_attention_lab(card_name: str) -> dict:
    """The attention lab's entry point: its fp32 check, then its timed chains
    with every launch counter set to 0 before them and read after them.
    Returns the launches of the chains."""
    attn_lab.check("cuda")
    reset_counts()
    result = attn_lab.timing()
    torch.cuda.synchronize()
    counts = read_counts()
    calls = attn_lab.DEPTH * (1 + attn_lab.TIMED_CHAINS)
    expected = {name: 0 for name in COUNTERS}
    expected.update(attention_core=calls, attention_core_fm=calls)
    if counts != expected:
        raise AssertionError(f"attention lab: launch counts {counts}, expected {expected}")
    log(f"attention lab on {card_name}: {json.dumps(result)}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def build_synthetic_tree(root: str) -> str:
    """The synthetic AMASS tree written by the port's generator under
    ``root`` (mm-GT and mean motions by its ``finalize_dataset``); returns
    its data root."""
    return make_synthetic_amass_motion(root, obs_length=OBS_LEN, pred_length=PRED_LEN,
                                       seed=SEED)


def build_eval_split(skeleton, data_root: str):
    """The synthetic tree's test split; returns (dataset, path of the APDE
    ground-truth CSV)."""
    pre = os.path.join(data_root, "processed", "AMASS", "hmp")
    ann = os.path.join(data_root, "annotations", "AMASS", "hmp")
    dataset = AMASSDataset(
        datasets=["DFaust", "GRAB"], split="test", precomputed_folder=pre, skeleton=skeleton,
        obs_length=OBS_LEN, pred_length=PRED_LEN,
        segments_path=os.path.join(ann, "segments_test.csv"), if_consider_hip=False,
        if_load_mmgt=True, if_compute_cmd=True, silent=True,
    )
    return dataset, os.path.join(ann, "mmapd_GT.csv")


class EvalClock:
    """The predictor with CUDA events before and after each call, and (inside
    ``metrics()``) before and after each batch's metric suite and each call
    of ``fid``'s feature extractor, where given."""

    def __init__(self, predictor, fid=None):
        self.predictor = predictor
        self.device = predictor.device
        self.pred_length = predictor.pred_length
        self.fid = fid
        self.marks = []
        self.last_batch = None  # the last (suite, args, kwargs) of compute_batch

    @staticmethod
    def _event():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def __call__(self, *args, **kwargs):
        start = self._event()
        out = self.predictor(*args, **kwargs)
        self.marks.append([start, self._event()])
        return out

    def _timed(self, fn, keep=None):
        def timed(*args, **kwargs):
            if keep is not None:
                keep(args, kwargs)
            start = self._event()
            out = fn(*args, **kwargs)
            self.marks[-1] += [start, self._event()]
            return out
        return timed

    @contextlib.contextmanager
    def metrics(self):
        def keep(args, kwargs):
            self.last_batch = (args[0], args[1:], kwargs)

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                suite_mod.MetricSuite, "compute_batch",
                self._timed(suite_mod.MetricSuite.compute_batch, keep)))
            if self.fid is not None:
                stack.enter_context(mock.patch.object(
                    self.fid, "get_fid_features", self._timed(self.fid.get_fid_features)))
            yield

    def split(self) -> list:
        """Per batch (ms): its period on the device, from its predictor call
        to the next batch's (the last one's: to its last event), the
        predictor, the metrics, the FID features (0 without ``fid``) and the
        rest (host data, the transfer, the preprocess and the device's idle
        time)."""
        torch.cuda.synchronize()
        out = []
        for i, (p0, p1, m0, m1, *fid) in enumerate(self.marks):
            end = self.marks[i + 1][0] if i + 1 < len(self.marks) else (fid or [m1])[-1]
            period, pred, met = p0.elapsed_time(end), p0.elapsed_time(p1), m0.elapsed_time(m1)
            feats = sum(a.elapsed_time(b) for a, b in zip(fid[::2], fid[1::2]))
            out.append({"period": period, "predictor": pred, "metrics": met, "fid": feats,
                        "rest": period - pred - met - feats})
        return out


class InjectedNoise:
    """The predictor with injected sampler noise, drawn per batch from a
    generator seeded with the batch's index: two runs over a split see the
    same noise."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.device = predictor.device
        self.pred_length = predictor.pred_length
        self.calls = 0

    def __call__(self, generator, obs, num_samples=None, pred_length=None):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 + self.calls)
        self.calls += 1
        start, steps = injected_noise(self.predictor.skeleton, gen)
        return self.predictor(None, obs, num_samples=num_samples, pred_length=pred_length,
                              start_noise=start, step_noise=steps)


def check_counts(label: str, counts: dict, expected: dict) -> None:
    expected = {name: expected.get(name, 0) for name in COUNTERS}
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts}, expected {expected}")


def hold_metrics(label: str, got: dict, want: dict, tol) -> None:
    """Every metric of ``want`` in ``got``, finite, |Δ| ≤ ``tol(want)``."""
    worst = []
    for name, w in want.items():
        g = got[name]
        err = abs(g - w)
        worst.append((err / tol(w), name, err))
        if not (math.isfinite(g) and math.isfinite(w) and err <= tol(w)):
            raise AssertionError(f"{label}: {name} {g!r} against {w!r} (|Δ| {err:.3e}, "
                                 f"tol {tol(w):.3e})")
    share, name, err = max(worst)
    log(f"{label}: {len(want)} metrics agree; largest |Δ| {err:.3e} ({name}, "
        f"{share:.3f} of its tolerance)")


def run_eval(skeleton, predictor_bf16, predictor, card_name: str, expected_bf16: dict,
             data_root: str) -> dict:
    """The evaluation path over the synthetic AMASS test split: the bf16 eval
    with kernels (metric table, seconds per batch, preds/s, its time split),
    the fp32 eval on kernels against plain versions with injected noise, and
    ZeroVelocity on the card against the CPU.  Returns the bf16 eval's
    launches, its preds/s and its metric table."""
    t0 = time.perf_counter()
    dataset, apde_csv = build_eval_split(skeleton, data_root)
    n = len(dataset)
    batches = -(-n // BATCH)
    log(f"eval split: {n} segments, {batches} batches of {BATCH} (the last padded), mm-GT "
        f"up to {dataset.max_mmgt_count} futures a segment; read in "
        f"{time.perf_counter() - t0:.1f} s")
    if n != EVAL_SEGMENTS:
        raise AssertionError(f"eval split has {n} segments, expected {EVAL_SEGMENTS}")
    args = dict(batch_size=BATCH, num_samples=SAMPLES, stats_mode="probabilistic", seed=SEED,
                if_compute_cmd=True, if_compute_apde=True, mmapd_gt_path=apde_csv,
                silent=True)

    compute_metrics(predictor_bf16, dataset, skeleton, ndebug=True, **args)  # warm-up
    clock, timer = EvalClock(predictor_bf16), AverageTimer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with clock.metrics():
        results = compute_metrics(clock, dataset, skeleton, timer=timer, **args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts("eval bf16", counts, {k: v * batches for k, v in expected_bf16.items()})
    if not all(math.isfinite(v) for v in results.values()) or len(results) != 12:
        raise AssertionError(f"eval bf16: metric table {results}")
    log("eval bf16 metric table:\n" + suite_mod.draw_table(results))
    split = clock.split()
    log(f"eval bf16: {n / wall:.2f} preds/s ({n} segments × {SAMPLES} samples in "
        f"{wall:.3f} s) on {card_name}; seconds a batch median "
        f"{statistics.median(timer.times):.4f}, each "
        f"{[round(x, 4) for x in timer.times]} (the last: the trailing drain); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log("eval bf16 split per batch, ms (CUDA events): " + "; ".join(
        f"period {b['period']:.2f} = predictor {b['predictor']:.2f} + metrics "
        f"{b['metrics']:.2f} + host data, transfer, preprocess and idle {b['rest']:.2f}"
        for b in split))
    suite, batch_args, batch_kwargs = clock.last_batch
    parts = {name: cuda_ms(lambda name=name: suite.metric(name, *batch_args, **batch_kwargs),
                           reps=3) for name in suite.stats_funcs}
    parts["CMD curve"] = cuda_ms(lambda: motion_for_cmd(batch_args[0]), reps=3)
    clock.last_batch = None
    log(f"eval bf16 metric suite at batch {BATCH} × {SAMPLES}, ms a call (CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f}")

    reset_counts()
    kernel = compute_metrics(InjectedNoise(predictor), dataset, skeleton, **args)
    check_counts("eval fp32", read_counts(),
                 {"gru_rollout": batches, "posterior_step": batches * TIMESTEPS})
    with plain_kernels():
        plain = compute_metrics(InjectedNoise(predictor), dataset, skeleton, **args)
    hold_metrics("eval fp32 with injected noise, kernels vs plain versions", kernel, plain,
                 lambda w: EVAL_KERNEL_TOL * max(1.0, abs(w)))

    zero, seconds = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        zero[d] = compute_metrics(ZeroVelocityPredictor(skeleton, SAMPLES, PRED_LEN, device=d),
                                  dataset, skeleton, **args)
        seconds[d] = time.perf_counter() - t0
    log(f"eval ZeroVelocity: {seconds['cuda']:.2f} s on the card, {seconds['cpu']:.2f} s on "
        f"the CPU ({os.cpu_count()} cores)")
    hold_metrics("eval ZeroVelocity, card vs CPU", zero["cuda"], zero["cpu"],
                 lambda w: EVAL_DEVICE_TOL * max(1.0, abs(w)))
    return counts, n / wall, results


# ---- the train phase ---------------------------------------------------------------


def train_split(skeleton, data_root: str):
    """The synthetic tree's train split as the flagship's loader config reads
    AMASS (`configs/config_train_autoencoder/dataset/amass.yaml`: a segment
    every 60 frames, jittered by up to ±30)."""
    return AMASSDataset(
        datasets=list(TRAIN_DATASETS), split="train", skeleton=skeleton,
        precomputed_folder=os.path.join(data_root, "processed", "AMASS", "hmp"),
        obs_length=OBS_LEN, pred_length=PRED_LEN, if_consider_hip=False, stride=60,
        augmentation=30, rng_seed=SEED, silent=True)


def train_batches(skeleton, loader, epoch: int, steps: int):
    """An epoch of ``steps`` batches as the training loops read them:
    ``cycled_batches`` (the loader restarts when a pass runs dry) →
    ``prefetch_iterator`` (pinned, non-blocking copies to the card) →
    ``preprocess_batch`` with the flagship's augmentations on the card.
    Yields (iteration, the train step's generator, (x, y))."""
    batches = prefetch_iterator(cycled_batches(loader, steps), device="cuda")
    for it, batch in enumerate(batches):
        aug = iteration_generator(SEED, epoch, it, 0, "cuda")
        x, y, _ = preprocess_batch(skeleton, aug, batch["obs"], batch["pred"], train=True,
                                   da_mirroring=TRAIN_MIRRORING, da_rotations=TRAIN_ROTATIONS)
        yield it, iteration_generator(SEED, epoch, it, 1, "cuda"), (x, y)


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def params_relative(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """The largest |Δ| over the two modules' parameters, each tensor's over
    its own max |value|."""
    return max(((p - q).abs().max() / q.abs().max().clamp_min(1e-30)).item()
               for p, q in zip(a.parameters(), b.parameters()))


def make_ae_trainer(ae: AutoEncoder) -> AutoEncoderTrainer:
    """Stage 1 with the flagship's optimizer and curriculum
    (`configs/config_train_autoencoder/model/autoencoder.yaml`)."""
    return AutoEncoderTrainer(ae, lr=5e-3, iter_per_epoch=AE_ITERS_PER_EPOCH,
                              prediction_horizon_train=PRED_LEN,
                              prediction_horizon_eval=PRED_LEN, curriculum_it=10,
                              prediction_horizon_train_min=10,
                              prediction_horizon_train_min_from_epoch=200,
                              random_prediction_horizon=True, seed=SEED)


# The stage-2 EMA of the train phase: updates every second call, hard copies
# through call 3, so that TRAIN_STEPS steps take it into decaying updates
# (the flagship's every 10 after 100 would still be its first copy)
TRAIN_EMA = dict(ema_update_every=2, step_start_ema=3)


def make_diffusion_trainer(skeleton, engine, ae: AutoEncoder, if_use_ema: bool = True
                           ) -> TrainerDiffusion:
    """Stage 2 with the flagship's objective and optimizer
    (`configs/config_train_diffusion/model/skeleton_diffusion.yaml`) and the
    EMA of ``TRAIN_EMA``."""
    return TrainerDiffusion(engine, ae, lr=1e-3, weight_decay=0.0,
                            train_pick_best_sample_among_k=TRAIN_K,
                            similarity_space="input_space", if_use_ema=if_use_ema,
                            prediction_horizon_eval=PRED_LEN, num_prob_samples=SAMPLES,
                            skeleton=skeleton, **TRAIN_EMA)


def timed(fn):
    """(fn(), its ms on the host clock, the card synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def check_decode_after_step(ae: AutoEncoder, x: torch.Tensor, y: torch.Tensor,
                            label: str) -> float:
    """K1's decode with the AutoEncoder's current weights against the plain
    decode of the same weights: a packed W_hh left from before the step would
    show here."""
    with torch.no_grad():
        z = ae.encode(y)
        got = ae.decode(x, z, PRED_LEN)
        args = rollout_mod.rollout_args(ae.decoder, x[:, -2:], z)
        want = rollout_mod.gru_rollout_plain(**args, ph=PRED_LEN).permute(2, 0, 1, 3)
    err = (got - want).abs().max().item()
    log(f"train, decode after {label}: K1 vs the plain decode of the new weights max_abs_err "
        f"{err:.3e} (tol {K1_TOL:.0e})")
    if not err <= K1_TOL:
        raise AssertionError(f"K1 after {label} disagrees with the plain decode: {err}")
    return err


def hold_resume(label: str, loss_a: float, loss_b: float, a: torch.nn.Module,
                b: torch.nn.Module) -> None:
    loss_err, param_err = relative(loss_b, loss_a), params_relative(b, a)
    log(f"train, {label}: restored run's next step against the uninterrupted one: loss "
        f"{loss_b!r} vs {loss_a!r} (relative {loss_err:.3e}), parameters after it relative "
        f"{param_err:.3e} (tol {RESUME_TOL:.0e})")
    if not (loss_err <= RESUME_TOL and param_err <= RESUME_TOL):
        raise AssertionError(f"{label}: the resumed step is not the uninterrupted one: loss "
                             f"{loss_err}, parameters {param_err}")


def hold_card_vs_cpu(label: str, card: tuple, cpu: tuple) -> None:
    """(loss, gradient norm) of one fp32 step on the card against the CPU."""
    loss_err, gnorm_err = relative(card[0], cpu[0]), relative(card[1], cpu[1])
    log(f"train, {label}, card vs CPU: loss {card[0]!r} vs {cpu[0]!r} (relative "
        f"{loss_err:.3e}, tol {TRAIN_LOSS_TOL:.0e}), grad norm {card[1]!r} vs {cpu[1]!r} "
        f"(relative {gnorm_err:.3e}, tol {TRAIN_GNORM_TOL:.0e})")
    if not (loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL):
        raise AssertionError(f"{label}: the card's step disagrees with the CPU's: loss "
                             f"{loss_err}, grad norm {gnorm_err}")


def run_stage1(skeleton, loader, ckpt_dir: str) -> AutoEncoder:
    """TRAIN_STEPS AutoEncoder steps at the curriculum of epoch 11 (after
    its cosine cycle: a random horizon up to 120), timed, K1 after the
    first and the last; then the resume and card-vs-CPU checks of one step at
    the full horizon.  Returns the trained AutoEncoder."""
    gen = torch.Generator().manual_seed(SEED)
    ae = AutoEncoder(skeleton.num_nodes, HIDDEN, HIDDEN, LATENT, gen,
                     node_types=skeleton.nodes_type_id).cuda()
    tr = make_ae_trainer(ae)
    epoch, first = 11, 10 * AE_ITERS_PER_EPOCH
    tr.epoch_started(epoch)
    ms, phs, losses = [], [], []
    reset_counts()
    for it, _, batch in train_batches(skeleton, loader, epoch, TRAIN_STEPS):
        (loss, ph), t = timed(lambda: tr.train_step(batch, epoch, first + it))
        ms.append(t)
        phs.append(ph)
        losses.append(loss.item())
        if it in (0, TRAIN_STEPS - 1):
            launched = {k: v for k, v in read_counts().items() if v}
            if launched:
                raise AssertionError(f"train stage 1: the training steps launched {launched}")
            check_decode_after_step(ae, *batch, f"AE step {it + 1}")
            reset_counts()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train stage 1: losses {losses}")
    log(f"train stage 1 (AutoEncoder, batch {TRAIN_BATCH}, hidden and latent {HIDDEN}, "
        f"differentiable decode; 0 kernel launches a step): horizons {phs}, ms a step "
        f"{[round(t, 1) for t in ms]} (median {statistics.median(ms):.1f} ms, "
        f"{statistics.median([t / p for t, p in zip(ms, phs)]):.3f} ms per horizon frame); "
        f"losses {[round(v, 5) for v in losses]}")

    # one more step at the full horizon: uninterrupted, after a restore, on the CPU
    ckpt = CheckpointManager(ckpt_dir, n_saved=1)
    ckpt.save_latest({"trainer": tr.state_dict()}, step=TRAIN_STEPS)
    x, y = batch

    def full_step(trainer):
        device = next(trainer.model.parameters()).device
        loss = trainer.loss(x.to(device), y.to(device), PRED_LEN)
        return loss.item(), trainer.optimizer_step(loss).item()

    def restored(device: str) -> AutoEncoderTrainer:
        fresh = AutoEncoder(skeleton.num_nodes, HIDDEN, HIDDEN, LATENT,
                            torch.Generator().manual_seed(SEED + 5),
                            node_types=skeleton.nodes_type_id).to(device)
        trainer = make_ae_trainer(fresh)
        trainer.load_state_dict(ckpt.restore(map_location=device)["trainer"])
        return trainer

    (loss_a, gnorm_a), t_full = timed(lambda: full_step(tr))
    log(f"train stage 1: a step at the full horizon {PRED_LEN}: {t_full:.1f} ms")
    again = restored("cuda")
    loss_b, _ = full_step(again)
    hold_resume("stage 1 resume", loss_a, loss_b, tr.model, again.model)
    cpu = restored("cpu")
    cpu_step, t_cpu = timed(lambda: full_step(cpu))
    log(f"train stage 1: the same step on the CPU ({os.cpu_count()} cores): {t_cpu:.0f} ms")
    hold_card_vs_cpu("stage 1 fp32 step", (loss_a, gnorm_a), cpu_step)
    check_decode_after_step(ae, x, y, f"AE step {TRAIN_STEPS + 1}")
    return ae


def train_denoiser(skeleton, device, compute_dtype=None, seed: int = SEED + 7):
    """(engine, denoiser) of the flagship on ``device``, its weights drawn
    from ``seed``, the influences moved off their init and the weights
    spread as ``build_model`` does: at its init scale x̂₀ is ~1e-2, the 50
    samples of an item decode to nearly the same motion and the k-best
    choice is a near-tie everywhere."""
    gen = torch.Generator().manual_seed(seed)
    engine, den = create_diffusion(skeleton, gen, latent_size=LATENT,
                                   diffusion_timesteps=TIMESTEPS, diffusion_arch=ARCH,
                                   device=device, compute_dtype=compute_dtype)
    perturb_influence(den, gen)
    spread_weights(den, gen)
    return engine, den


def kbest_gaps(sim: torch.Tensor) -> torch.Tensor:
    """Per item, the second-smallest similarity minus the smallest."""
    two = sim.topk(2, dim=-1, largest=False).values
    return two[:, 1] - two[:, 0]


def check_kbest_against_plain(tr: TrainerDiffusion, batch, t, noise) -> None:
    """One fp32 stage-2 step with K1 against the same step (same state, t and
    noise) with the plain decode: the losses within 1e-4·max(1, |v|), the
    argmins equal wherever the plain similarities' gap between the best and
    the second-best sample exceeds that bound (a near-tie may go either way:
    the step is then compared at the kernel's choice)."""
    start = copy.deepcopy(tr.state_dict())
    loss_k = tr.train_step(batch, t=t, noise=noise).item()
    kernel = tr.last_choice
    tr.load_state_dict(start)
    with plain_rollouts():
        loss_p = tr.train_step(batch, t=t, noise=noise).item()
    plain = tr.last_choice
    gaps = kbest_gaps(plain["similarity"])
    bound = TRAIN_LOSS_TOL
    differ = kernel["index"] != plain["index"]
    sim_err = (kernel["similarity"] - plain["similarity"]).abs().max().item()
    if bool((differ & (gaps > bound)).any()):
        raise AssertionError(f"k-best: K1 and the plain decode choose different samples "
                             f"beyond a near-tie: items {differ.nonzero().flatten().tolist()}")
    # the per-sample losses do not depend on the decode: at the kernel's
    # choice the plain step's loss is the kernel step's
    weights = tr.diffusion.process.loss_weight[t]
    at_kernel = (plain["losses"].gather(1, kernel["index"][:, None])[:, 0] * weights).mean()
    err = abs(loss_k - loss_p)
    log(f"train, k-best with K1 vs the plain decode (fp32 step, {TRAIN_BATCH} × {TRAIN_K} "
        f"samples decoded over {PRED_LEN} steps): similarities max |Δ| {sim_err:.3e}; argmins "
        f"differ for {int(differ.sum())} items (gaps there "
        f"{[f'{g:.2e}' for g in gaps[differ].tolist()]}); smallest gap "
        f"{gaps.min().item():.3e}, "
        f"median {gaps.median().item():.3e}; loss {loss_k!r} vs {loss_p!r} (|Δ| {err:.3e}, "
        f"at the kernel's choice {abs(loss_k - at_kernel.item()):.3e}; tol "
        f"{bound:.0e}·max(1, |v|))")
    if not abs(loss_k - at_kernel.item()) <= bound * max(1.0, abs(loss_p)):
        raise AssertionError(f"k-best: the K1 step's loss {loss_k} against {at_kernel.item()}")
    if not (bool(differ.any()) or err <= bound * max(1.0, abs(loss_p))):
        raise AssertionError(f"k-best: the K1 step's loss {loss_k} against the plain {loss_p}")


def run_stage2(skeleton, loader, ae: AutoEncoder, ckpt_dir: str, card_name: str,
               expected_bf16: dict) -> dict:
    """TRAIN_STEPS bf16 stage-2 steps on the trained AutoEncoder, timed with
    their launches; the k-best decode's time; the fp32 checks (K1 against
    the plain decode, the card against the CPU); the resume check; one
    validation step at BATCH × SAMPLES on the EMA weights.  Returns the
    launches of the steps and the validation step together."""
    engine, _ = train_denoiser(skeleton, "cuda", torch.bfloat16)
    tr = make_diffusion_trainer(skeleton, engine, ae)
    epoch = 1
    tr.epoch_started(epoch)
    ms, losses = [], []
    reset_counts()
    for it, gen, batch in train_batches(skeleton, loader, epoch, TRAIN_STEPS):
        loss, t = timed(lambda: tr.train_step(batch, gen))
        ms.append(t)
        losses.append(loss.item())
    counts = read_counts()
    check_counts("train stage 2 steps", counts, {"gru_rollout": TRAIN_STEPS})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train stage 2: losses {losses}")
    x, y = batch
    with torch.no_grad():
        z_past, z = tr.embed(x, y)
        _, _, samples = tr.diffusion.loss(z, x_cond=z_past, n_train_samples=TRAIN_K,
                                          generator=gen)
    decode_ms = cuda_ms(lambda: tr.similarity(samples, x, y), reps=3)
    log(f"train stage 2 (bf16 denoiser, batch {TRAIN_BATCH} × k {TRAIN_K}, input space): ms a "
        f"step {[round(v, 1) for v in ms]} (median {statistics.median(ms):.1f} ms); the k-best "
        f"decode and comparison {decode_ms:.2f} ms a step ({TRAIN_BATCH * TRAIN_K} rows); "
        f"launches a step {({k: v // TRAIN_STEPS for k, v in counts.items() if v})}; "
        f"losses {[round(v, 5) for v in losses]}; on {card_name}")

    # resume: save, restore into fresh objects, the next step on both
    ckpt = CheckpointManager(ckpt_dir, n_saved=1)
    ckpt.save_latest({"trainer": tr.state_dict()}, step=TRAIN_STEPS)
    step_gen = lambda: iteration_generator(SEED, epoch, TRAIN_STEPS, 1, "cuda")  # noqa: E731
    loss_a = tr.train_step(batch, step_gen()).item()
    engine_b, _ = train_denoiser(skeleton, "cuda", torch.bfloat16, seed=SEED + 8)
    again = make_diffusion_trainer(skeleton, engine_b, ae)
    again.load_state_dict(ckpt.restore(map_location="cuda")["trainer"])
    loss_b = again.train_step(batch, step_gen()).item()
    hold_resume("stage 2 (bf16) resume", loss_a, loss_b, tr.denoiser, again.denoiser)

    # fp32 steps: the same weights, optimizer state and injected t and noise
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    t = torch.randint(0, TIMESTEPS, (TRAIN_BATCH,), generator=gen, device="cuda")
    noise = torch.randn((TRAIN_BATCH * TRAIN_K, skeleton.num_nodes, LATENT), generator=gen,
                        device="cuda")
    state = copy.deepcopy({k: v for k, v in tr.state_dict().items() if k != "ema"})
    engine32, _ = train_denoiser(skeleton, "cuda")
    tr32 = make_diffusion_trainer(skeleton, engine32, ae, if_use_ema=False)
    tr32.load_state_dict({**state, "ema": None})
    check_kbest_against_plain(tr32, batch, t, noise)
    tr32.load_state_dict({**state, "ema": None})
    card_step = (tr32.train_step(batch, t=t, noise=noise).item(), tr32.last_grad_norm.item())
    card_sim = tr32.last_choice["similarity"].cpu()
    engine_cpu, _ = train_denoiser(skeleton, "cpu")
    cpu = make_diffusion_trainer(skeleton, engine_cpu, copy.deepcopy(ae).cpu(),
                                 if_use_ema=False)
    cpu.load_state_dict({**state, "ema": None})
    # the CPU step takes the card's k-best choice (K1's against the plain
    # decode is held above): it compares the denoiser's forward and backward
    with mock.patch.object(cpu, "similarity", lambda *args: card_sim):
        cpu_step, t_cpu = timed(lambda: (cpu.train_step(tuple(v.cpu() for v in batch),
                                                        t=t.cpu(), noise=noise.cpu()).item(),
                                         cpu.last_grad_norm.item()))
    log(f"train stage 2: an fp32 step on the CPU ({os.cpu_count()} cores): {t_cpu:.0f} ms")
    hold_card_vs_cpu("stage 2 fp32 step", card_step, cpu_step)

    # validation on the EMA weights, through the prediction path
    val_loader = DataLoader(loader.dataset, batch_size=BATCH, shuffle=False, seed=SEED)
    val = next(iter(val_loader))
    obs, fut, _ = preprocess_batch(skeleton, None, torch.from_numpy(val["obs"]).cuda(),
                                   torch.from_numpy(val["pred"]).cuda(), train=False)
    val_gen = torch.Generator(device="cuda").manual_seed(SEED)
    tr.validation_step((obs, fut), val_gen)  # warm-up
    reset_counts()
    (out, _, _, _), val_ms = timed(lambda: tr.validation_step((obs, fut), val_gen))
    val_counts = read_counts()
    check_counts("train validation step", val_counts, expected_bf16)
    want = (BATCH, SAMPLES, PRED_LEN, skeleton.num_nodes, 3)
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"validation step: output {tuple(out.shape)} (want {want}) or "
                             f"not finite")
    log(f"train validation step on the EMA weights (EMA step {tr.ema.step}; batch {BATCH} × "
        f"{SAMPLES} samples, fused operands prepared at the call): {val_ms:.1f} ms; launches "
        f"{ {k: v for k, v in val_counts.items() if v} }")
    hold_validation(skeleton, tr, ae, obs, fut, batch, step_gen)
    return {k: counts[k] + val_counts[k] for k in counts}


def validation_runs(skeleton, tr: TrainerDiffusion, ae: AutoEncoder, obs: torch.Tensor,
                    fut: torch.Tensor, start: torch.Tensor, steps: torch.Tensor) -> dict:
    """The validation step's prediction on the EMA weights with injected
    noise (``injected_run``: metric space, sampler states) on the kernel
    chain, on the plain versions, and on an fp32 denoiser of the same EMA
    weights."""
    def validation_path(gen, obs, **noise):
        out, _, samples, _ = tr.validation_step((obs, fut), gen, **noise)
        return out, samples

    engine32, den32 = train_denoiser(skeleton, "cuda")
    den32.load_state_dict(tr.ema.module.state_dict())
    fp32 = SkeletonDiffusionPredictor(skeleton, ae, engine32, num_samples=SAMPLES,
                                      pred_length=PRED_LEN, device="cuda")
    runs = {"kernels": injected_run(skeleton, validation_path, obs, start, steps, plain=False),
            "plain": injected_run(skeleton, validation_path, obs, start, steps, plain=True),
            "fp32": injected_run(skeleton, fp32, obs, start, steps, plain=False)}
    torch.cuda.synchronize()
    return runs


def hold_validation(skeleton, tr: TrainerDiffusion, ae: AutoEncoder, obs: torch.Tensor,
                    fut: torch.Tensor, batch, step_gen) -> None:
    """The validation step on EMA weights past their hard copies, with
    injected noise, held against the plain path on the same weights
    (``hold_bf16``); then, after one more EMA update that moves them, the
    same hold on the new weights and the kernel chain's move beside its
    deviation from the plain path: packed operands left from before the
    update would keep the chain's output where it was.  After the update
    the predictions' mean ratio is printed, not held, as for the 16- and
    17-node paths (ROADMAP Queue C item 7): on these weights it read 1.015
    with the sampler states' at 0.825 (H100 80GB HBM3, 700 W), where the
    same hold before the update read 0.818 and 0.815."""
    if tr.ema.step <= tr.ema_kwargs["update_after_step"] + tr.ema_kwargs["update_every"]:
        raise AssertionError(f"validation hold: the EMA (step {tr.ema.step}) has not left its "
                             f"hard copies ({tr.ema_kwargs})")
    start, steps = injected_noise(skeleton, torch.Generator(device="cuda").manual_seed(SEED + 11))
    before = validation_runs(skeleton, tr, ae, obs, fut, start, steps)
    hold_bf16(f"train validation step (EMA step {tr.ema.step})", before, [("kernels", "plain")])
    decays = []
    while not decays or decays[-1] == 1.0:  # steps up to one EMA update that decays
        decays.append(ema_decay(tr.ema.step, **tr.ema_kwargs))
        tr.train_step(batch, step_gen())
    if not 0.0 < decays[-1] < 1.0:
        raise AssertionError(f"validation hold: the EMA update applied decay {decays[-1]}")
    after = validation_runs(skeleton, tr, ae, obs, fut, start, steps)
    hold_bf16(f"train validation step after an EMA update of decay {decays[-1]:.4f} (EMA step "
              f"{tr.ema.step})", after, [("kernels", "plain")], hold=HOLD_STATES_MEAN)
    moved = {name: (after[name][0] - before[name][0]).abs() * 1e3 for name in after}
    gap = (after["kernels"][0] - after["plain"][0]).abs() * 1e3
    log(f"train validation step, the EMA update's move of the prediction (metric space): "
        f"kernels mean {moved['kernels'].mean().item():.4e} mm, plain mean "
        f"{moved['plain'].mean().item():.4e} mm, fp32 mean {moved['fp32'].mean().item():.4e} "
        f"mm; kernels vs plain after it mean {gap.mean().item():.4e} mm")
    if not moved["kernels"].mean().item() > gap.mean().item():
        raise AssertionError("validation hold: the kernel chain's prediction did not move with "
                             "the EMA weights beyond its deviation from the plain path")


def run_train(skeleton, data_root: str, card_name: str, expected_bf16: dict) -> dict:
    """The two-stage training path on the synthetic train split; returns the
    launches of stage 2 and its validation step."""
    dataset = train_split(skeleton, data_root)
    loader = DataLoader(dataset, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                        seed=SEED)
    log(f"train split: {len(dataset)} samples of {len(dataset.segments)} segments "
        f"({', '.join(TRAIN_DATASETS)}), {len(loader)} batches of {TRAIN_BATCH} a pass: "
        f"{TRAIN_STEPS} steps restart the loader once")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ae = run_stage1(skeleton, loader, os.path.join(ckpt_dir, "ae"))
        return run_stage2(skeleton, loader, ae, os.path.join(ckpt_dir, "diffusion"), card_name,
                          expected_bf16)


# ---- the cli phase -------------------------------------------------------------------

# The entry points' overrides: the synthetic tree's datasets, small epochs, and
# validation every epoch (one batch of the capped train-split pass).  Nothing
# in configs/** is edited.
CLI_EPOCHS, CLI_ITERS = 2, 3
CLI_DATA = [f"dataset.data_loader_train.datasets=[{', '.join(TRAIN_DATASETS)}]",
            f"dataset.data_loader_train_eval.datasets=[{', '.join(TRAIN_DATASETS)}]",
            "dataset.data_loader_valid.datasets=[HumanEva]"]
CLI_TRAIN = [f"model.num_iter_perepoch={CLI_ITERS}", "model.if_run_validation=True",
             "model.eval_frequency=1", "model.num_iteration_eval=1"]
CLI_EVAL_TOL = 1e-5


def run_main(main, tree: str, args: list):
    """An entry point's ``main(args)`` with its config tree → (its result,
    ms)."""
    with mock.patch.dict(os.environ, {"SKELDIFF_CONFIG_DIR": os.path.join("configs", tree)}):
        return timed(lambda: main(args))


def epoch_seconds(exp: str) -> list:
    """The seconds between the per-epoch records of an experiment's
    metrics.jsonl (an epoch's steps, its validation and its checkpoints)."""
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        stamps = [r["time"] for r in map(json.loads, f) if r["prefix"] == "train"]
    return [round(b - a, 3) for a, b in zip(stamps, stamps[1:])]


def validation_seconds(exp: str) -> list:
    """Each epoch's validation (its valid and train-split passes): from the
    epoch's per-parameter norms record to its train_eval record."""
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    starts = [r["time"] for r in records if r["prefix"] == "hist"]
    ends = [r["time"] for r in records if r["prefix"] == "train_eval"]
    return [round(b - a, 3) for a, b in zip(starts, ends)]


@contextlib.contextmanager
def checkpoint_writes():
    """Every checkpoint file written in the block: (name, MB, s)."""
    writes, write = [], CheckpointManager._write

    def timed_write(self, state, name):
        t0 = time.perf_counter()
        write(self, state, name)
        writes.append((name, os.path.getsize(self.path(name)) / 1e6, time.perf_counter() - t0))

    with mock.patch.object(CheckpointManager, "_write", timed_write):
        yield writes


def log_writes(label: str, writes: list) -> None:
    log(f"{label}: {len(writes)} checkpoint files of "
        f"{sorted({round(mb, 1) for _, mb, _ in writes})} MB, "
        f"{sum(s for _, _, s in writes):.3f} s in all")


def check_experiment(label: str, exp: str, epochs: int) -> None:
    """The experiment folder after ``epochs`` epochs: the host state, a
    scored checkpoint for each epoch, finite epoch losses, validation."""
    with open(os.path.join(exp, "host_state.json")) as f:
        host = json.load(f)
    with open(os.path.join(exp, "checkpoints", "index.json")) as f:
        scored = sorted(e["step"] for e in json.load(f) if e["score"] is not None)
    if (host["epoch"], host["global_step"], scored) != (epochs, epochs * CLI_ITERS,
                                                        list(range(1, epochs + 1))):
        raise AssertionError(f"{label}: host state {host['epoch'], host['global_step']}, "
                             f"scored checkpoints {scored}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["prefix"] == "train"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: epoch losses {losses}")
    if not any(r["prefix"] == "valid" for r in records):
        raise AssertionError(f"{label}: no validation record")


def run_cli_training(data_root: str, out: str, card_name: str) -> str:
    """Stage 1, stage 2 and its resume through the training CLIs; returns
    the stage-2 experiment folder."""
    common = [f"dataset_main_path={data_root}", *CLI_DATA, *CLI_TRAIN]
    with checkpoint_writes() as ae_writes:
        ae_dir, ae_ms = run_main(train_ae_cli.main, "config_train_autoencoder", common + [
            f"output_log_path={out}/ae", f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("cli stage 1", ae_dir, CLI_EPOCHS)
    args = common + [f"output_log_path={out}/diffusion",
                     f"model.pretrained_autoencoder_path={ae_dir}/checkpoints"]
    with checkpoint_writes() as diff_writes:
        diff_dir, diff_ms = run_main(train_diff_cli.main, "config_train_diffusion",
                                     args + [f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("cli stage 2", diff_dir, CLI_EPOCHS)
    with checkpoint_writes() as resume_writes:
        _, resume_ms = run_main(train_diff_cli.main, "config_train_diffusion",
                                args + [f"model.num_epochs={CLI_EPOCHS + 1}",
                                        "if_resume_training=True"])
    check_experiment("cli stage 2 resumed", diff_dir, CLI_EPOCHS + 1)
    cfg = yaml_lite.read(os.path.join(diff_dir, "config.yaml"))
    got = (cfg["latent_size"], cfg["autoenc_arch"]["encoder_hidden_size"], cfg["compute_dtype"],
           cfg["diffusion_arch"]["depth"], cfg["train_pick_best_sample_among_k"])
    if got != (LATENT, HIDDEN, "bfloat16", ARCH["depth"], TRAIN_K):
        raise AssertionError(f"cli stage 2 config: {got}")
    log(f"cli training on {card_name}: stage 1 {CLI_EPOCHS} epochs × {CLI_ITERS} iterations in "
        f"{ae_ms / 1e3:.2f} s ({ae_ms / 1e3 / CLI_EPOCHS:.2f} s an epoch; between epoch records "
        f"{epoch_seconds(ae_dir)} s); stage 2 (bf16, k {TRAIN_K}) {CLI_EPOCHS} epochs in "
        f"{diff_ms / 1e3:.2f} s ({diff_ms / 1e3 / CLI_EPOCHS:.2f} s an epoch), resumed to epoch "
        f"{CLI_EPOCHS + 1} in {resume_ms / 1e3:.2f} s; between stage-2 epoch records "
        f"{epoch_seconds(diff_dir)} s (the resume's included)")
    log(f"cli training, validation an epoch: stage 1 {validation_seconds(ae_dir)} s, stage 2 "
        f"{validation_seconds(diff_dir)} s (the resume's included)")
    log_writes("cli stage 1", ae_writes)
    log_writes("cli stage 2", diff_writes)
    log_writes("cli stage 2 resumed", resume_writes)
    return ae_dir, diff_dir


def run_cli(data_root: str, out: str, card_name: str, expected_bf16: dict,
            eval_preds_s: float) -> str:
    """Both training CLIs (stage 2 resumed), the eval CLI held against
    compute_metrics and its results YAML, and InferenceSession.  Returns the
    stage-1 experiment folder."""
    ae_dir, diff_dir = run_cli_training(data_root, out, card_name)

    eval_args = [f"dataset_main_path={data_root}", "dataset=amass", f"checkpoint_path={diff_dir}",
                 "stats_mode=probabilistic", f"batch_size={BATCH}"]
    reset_counts()
    results, cli_ms = run_main(eval_cli.main, "config_eval", eval_args)
    counts = read_counts()
    batches = -(-EVAL_SEGMENTS // BATCH)
    check_counts("cli eval", counts, {k: v * batches for k, v in expected_bf16.items()})
    if len(results) != 12 or not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"cli eval: metric table {results}")
    path = os.path.join(diff_dir, f"eval_amass_{BATCH}", "test",
                        f"{eval_cli.device_label(torch.device('cuda'))}_seed0",
                        "results_probabilistic.yaml")
    written = yaml_lite.read(path)
    if written != {k: float(v) for k, v in results.items()}:
        raise AssertionError(f"cli eval: {path} reads {written}, the CLI returned {results}")

    cfg = eval_cli.merge_experiment_cfg(flatten_config(load_config(
        os.path.join("configs", "config_eval"), eval_args)))
    skeleton = build_skeleton(cfg)
    predictor, prepare_ms = timed(lambda: eval_cli.prepare_model(cfg, skeleton,
                                                                 torch.device("cuda")))
    dataset, dataset_ms = timed(lambda: build_dataset(cfg, skeleton, "test", "data_loader_test",
                                                      if_compute_cmd=True))
    direct, direct_ms = timed(lambda: compute_metrics(
        predictor, dataset, skeleton, batch_size=BATCH, num_samples=SAMPLES,
        stats_mode="probabilistic", seed=0, if_compute_cmd=True, if_compute_apde=True,
        mmapd_gt_path=os.path.join(cfg["annotations_folder"], "mmapd_GT.csv")))
    hold_metrics("cli eval vs compute_metrics on prepare_model's predictor", results, direct,
                 lambda w: CLI_EVAL_TOL * max(1.0, abs(w)))
    n = len(dataset)
    log(f"cli eval on {card_name}: {n} segments × {SAMPLES} samples; the CLI's whole call "
        f"{cli_ms / 1e3:.3f} s ({n / cli_ms * 1e3:.2f} preds/s, reading the split and the "
        f"checkpoints included), compute_metrics on its prepare_model {direct_ms / 1e3:.3f} s "
        f"({n / direct_ms * 1e3:.2f} preds/s), the eval phase {eval_preds_s:.2f} preds/s; "
        f"prepare_model {prepare_ms / 1e3:.3f} s, reading the test split "
        f"{dataset_ms / 1e3:.3f} s; "
        f"launches a batch { {k: v // batches for k, v in counts.items() if v} } (the eval "
        f"phase's); {path} read back equal")

    session, session_ms = timed(lambda: InferenceSession(
        diff_dir, "amass", overrides=[f"dataset_main_path={data_root}"]))
    obs_raw = dataset[0][0]
    seeded = lambda: torch.Generator(device="cuda").manual_seed(SEED + 11)  # noqa: E731
    got = session.predict(obs_raw, generator=seeded())
    with torch.no_grad():
        obs = session.skeleton.tranform_to_input_space(torch.as_tensor(obs_raw).cuda()[None])
        pred, _ = session.predictor(seeded(), obs)
        want = session.skeleton.transform_to_metric_space(pred)[0].cpu().numpy()
    shape = (SAMPLES, PRED_LEN, skeleton.num_nodes, 3)
    err = float(abs(got - want).max())
    if got.shape != shape or not math.isfinite(float(abs(got).max())) or \
            not err <= CLI_EVAL_TOL * max(1.0, float(abs(want).max())):
        raise AssertionError(f"InferenceSession.predict: shape {got.shape} (want {shape}), "
                             f"max |Δ| from its predictor {err}")
    log(f"cli InferenceSession on {card_name}: built in {session_ms / 1e3:.2f} s; predict on one "
        f"observation {got.shape}, max |Δ| from the predictor's own output {err:.3e}")
    return ae_dir


# ---- the variants phase ---------------------------------------------------------------

# The diffusion variants at the flagship's width: the isotropic process
# (configs/config_train_diffusion/model/isotropic_diffusion.yaml's process and
# loss), DDIM at DDIM_STEPS of its 10 steps, and the nonisotropic process with
# pred_noise, each on the fp32 and bf16 paths.  The fp32 predictor against its
# plain path (the plain denoiser, the q_posterior step of the JAX engine's
# form, the plain decode) within E2E_TOL; the bf16 kernel path against its
# plain versions within BF16_E2E_MAX × the plain versions' fp32 deviation
# (``hold_bf16``); for pred_noise also each step's denoiser output against
# its plain version on the same inputs, held the same way
# (``denoiser_steps_held``): the sampler's later arithmetic (it divides by
# √ᾱ_t, then clips) can magnify a small output deviation into a large latent
# one.
# The module variants (tanh, no conditioning, self-conditioning, no attention)
# on the card against the same module on the CPU, fp32, on VARIANT_CUT
# observations × 50 samples: |Δ| ≤ VARIANT_TOL·max(1, |CPU|).
ISOTROPIC = {"diffusion_type": "IsotropicGaussianDiffusion", "diffusion_loss_type": "l1"}
DDIM_STEPS = 5
VARIANT_CUT = 1
VARIANT_TOL = 1e-4
MODULE_VARIANTS = {
    "tanh": {"diffusion_activation": "tanh"},
    "unconditioned": {"diffusion_conditioning": False},
    "self-conditioned": {"diffusion_arch": {**ARCH, "self_condition": True}},
    "attention-free": {"diffusion_arch": {**ARCH, "use_attention": False}},
}


def fused_launches(steps: int, x0_entry: str) -> dict:
    """A bf16 prediction's launches with the single-stage kernel chain over
    ``steps`` denoiser calls, K2's ``x0_entry`` after each (none for DDIM)
    and K1."""
    out = {"gru_rollout": 1, "graph_linear_fused": steps, "resnet_block": 8 * steps,
           "rms_qkv": 7 * steps, "attention_core": 7 * steps, "outproj_res": 7 * steps,
           "final_block_in": steps, "final_block_out": steps}
    if x0_entry:
        out[x0_entry] = steps
    return out


def variant_run(skeleton, predictor, obs, start, steps, plain: bool):
    """(metric-space prediction, latents) with injected sampler noise;
    ``plain`` replaces every kernel wrapper by its plain version and, on the
    fp32 path, takes the plain path: the posterior step as ``q_posterior`` +
    ``combine_mean_var_noise`` and the plain decode."""
    engine = predictor.diffusion
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_kernels())
            if engine.fused is None:
                step = lambda x0, img, eps, t: posterior_update_plain(  # noqa: E731
                    engine.process, x0, img, eps, t)
                stack.enter_context(mock.patch.object(engine, "posterior_step", step))
                stack.enter_context(mock.patch.object(predictor, "use_fused_decode", False))
        pred, latents = predictor(None, obs, start_noise=start, step_noise=steps)
    return skeleton.transform_to_metric_space(pred), latents


@contextlib.contextmanager
def denoiser_steps_held(label: str, p16, p32):
    """Inside the block, each step's denoiser output of the bf16 kernel
    path (the noise prediction for pred_noise) is held against its plain
    versions on the same inputs, beside the plain versions' deviation from
    the fp32 denoiser on them: the mean below it, the max within
    BF16_E2E_MAX × its max."""
    e16, e32 = p16.diffusion, p32.diffusion
    model_output, embed = e16.model_output, e16.embed_condition
    u32, worst = [], []

    def embedding(x_cond):
        u32.append(e32.embed_condition(x_cond.float()))
        return embed(x_cond)

    def recording(img, t, u_cond, fused=True):
        out = model_output(img, t, u_cond, fused)
        with plain_kernels():
            plain = model_output(img, t, u_cond, fused).float()
        ref = e32.model_output(img.float(), t, u32[0])
        kp, bf = (out.float() - plain).abs(), (plain - ref).abs()
        row = (t, kp.max().item(), kp.mean().item(), bf.max().item(), bf.mean().item())
        if not (row[2] < row[4] and row[1] <= BF16_E2E_MAX * row[3]):
            raise AssertionError(f"{label}: denoiser output at t={t}: kernels vs plain max "
                                 f"{row[1]}, mean {row[2]}, against the plain path's fp32 "
                                 f"deviation (max {row[3]}, mean {row[4]})")
        worst.append(row)
        return out

    with mock.patch.object(e16, "model_output", recording), \
            mock.patch.object(e16, "embed_condition", embedding):
        yield
    t, kp_max, kp_mean, bf_max, bf_mean = max(worst, key=lambda r: r[1] / r[3])
    log(f"{label} bf16 path, denoiser output at each of {len(worst)} steps on the kernel "
        f"path's inputs: kernels vs plain against plain vs fp32; largest max ratio at t={t}: "
        f"max {kp_max:.4e} mean {kp_mean:.4e} against max {bf_max:.4e} mean {bf_mean:.4e} "
        f"(max ratio {kp_max / bf_max:.3f}, bound {BF16_E2E_MAX})")


def variant_noise(skeleton, predictor, gen: torch.Generator, rows: int):
    """Start noise [rows, N, D] and step noise for the predictor's sampler."""
    engine = predictor.diffusion
    steps = engine.sampling_timesteps if engine.is_ddim_sampling else engine.num_timesteps
    n = skeleton.num_nodes
    return (torch.randn((rows, n, LATENT), generator=gen, device="cuda"),
            torch.randn((rows, steps - 1, n, LATENT), generator=gen, device="cuda"))


def check_variant(label: str, skeleton, p32, p16, obs, gen, card_name: str,
                  expected32: dict, expected16: dict) -> dict:
    """A sampler variant on both paths: preds/s and launches (``run_main_path``),
    the fp32 predictor against its plain path, the bf16 kernel path against
    its plain versions (end to end; pred_noise a step at a time too).
    Returns the launches of one prediction per path."""
    launches = {"fp32": run_main_path(skeleton, p32, obs, card_name, expected32,
                                      f"{label} fp32"),
                "bf16": run_main_path(skeleton, p16, obs, card_name, expected16,
                                      f"{label} bf16")}
    start, steps = variant_noise(skeleton, p32, gen, BATCH * SAMPLES)
    runs = {"fp32": variant_run(skeleton, p32, obs, start, steps, plain=False),
            "fp32 plain": variant_run(skeleton, p32, obs, start, steps, plain=True)}
    # without K2 (DDIM) the fp32 sampler runs the same code on both paths:
    # its latents agree by construction and only the decode is held
    ddim = p32.diffusion.is_ddim_sampling
    same = "; the sampler runs no kernel: 0 by construction" if ddim else ""
    for i, what in ((1, "latents"), (0, "prediction, metric space")):
        got, want = runs["fp32"][i], runs["fp32 plain"][i]
        err = (got - want).abs().max().item()
        log(f"{label} fp32 with injected noise vs its plain path: {what}: max_abs_err "
            f"{err:.3e} (tol {E2E_TOL:.0e}, |plain| ≤ {want.abs().max().item():.3f}"
            f"{same if i else ''})")
        if not err <= E2E_TOL:
            raise AssertionError(f"{label}: fp32 path disagrees with its plain path in the "
                                 f"{what}: {err}")
    # where x̂₀ is derived from the output (pred_noise divides by √ᾱ_t, then
    # clips), the output is held a step at a time as well
    x0_out = p16.diffusion.objective == "pred_x0"
    with contextlib.nullcontext() if x0_out else denoiser_steps_held(label, p16, p32):
        runs["kernels"] = variant_run(skeleton, p16, obs, start, steps, plain=False)
    runs["plain"] = variant_run(skeleton, p16, obs, start, steps, plain=True)
    torch.cuda.synchronize()
    hold_bf16(f"{label} bf16 path", runs, [("kernels", "plain")], states="latents")
    log(f"{label}: denoiser path fp32 {'kernel chain' if p32.use_fused_denoiser else 'plain'}, "
        f"bf16 {'kernel chain' if p16.use_fused_denoiser else 'plain'}")
    return launches


def check_module_variant(label: str, variant: dict, obs, gen, card_name: str) -> None:
    """A module variant: the fp32 predictor on the card against the same
    model on the CPU on a cut batch; one full-width prediction with injected
    noise on each path, timed, with the path it took."""
    t = time.perf_counter()
    skeleton, p32 = build_model(torch.device("cuda"), **variant)
    _, cpu = build_model(torch.device("cpu"), **variant)
    seconds = {"builds": time.perf_counter() - t}
    rows = VARIANT_CUT * SAMPLES
    start, steps = variant_noise(skeleton, p32, gen, rows)
    with torch.no_grad():
        card_pred, _ = p32(None, obs[:VARIANT_CUT], start_noise=start, step_noise=steps)
        t = time.perf_counter()
        cpu_pred, _ = cpu(None, obs[:VARIANT_CUT].cpu(), start_noise=start.cpu(),
                          step_noise=steps.cpu())
        seconds["CPU run"] = time.perf_counter() - t
    card_m = skeleton.transform_to_metric_space(card_pred).cpu()
    cpu_m = skeleton.transform_to_metric_space(cpu_pred)
    err = (card_m - cpu_m).abs().max().item()
    tol = VARIANT_TOL * max(1.0, cpu_m.abs().max().item())
    if not (bool(torch.isfinite(card_m).all()) and err <= tol):
        raise AssertionError(f"{label}: card vs CPU max |Δ| {err} (tol {tol})")
    parts = []
    for dtype in (None, torch.bfloat16):
        t = time.perf_counter()
        _, pred = (skeleton, p32) if dtype is None else build_model(torch.device("cuda"), dtype,
                                                                    **variant)
        seconds["builds"] += time.perf_counter() - t
        start, steps = variant_noise(skeleton, pred, gen, BATCH * SAMPLES)
        pred(None, obs, start_noise=start, step_noise=steps)  # warm-up
        reset_counts()
        (out, _), ms = timed(lambda: pred(None, obs, start_noise=start, step_noise=steps))
        counts = {k: v for k, v in read_counts().items() if v}
        # the JAX predictor's conditions: of these, only tanh keeps the chain in bf16
        chain = dtype is not None and label == "tanh"
        if pred.use_fused_denoiser != chain or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: kernel chain {pred.use_fused_denoiser} (want "
                                 f"{chain}) or prediction not finite")
        path = "kernel chain" if chain else "plain denoiser"
        parts.append(f"{'bf16' if dtype else 'fp32'} ({path}) {BATCH / ms * 1e3:.2f} preds/s, "
                     f"launches {counts}")
    log(f"{label} on {card_name}: card vs CPU on {VARIANT_CUT} × {SAMPLES} max |Δ| {err:.3e} "
        f"(tol {tol:.1e}); one injected-noise prediction of {BATCH} × {SAMPLES}: "
        + "; ".join(parts) + "; seconds " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))


# The AutoEncoder's model variants (ROADMAP Queue A item 4b) at full width:
# the bf16 chain and K2 on every one, K1 on the GRU decoders only (an LSTM
# decoder decodes with its plain step loop, as the JAX predictor does).
AE_VARIANTS = {
    "LSTM encoder and decoder": {"recurrent_arch_enc": "StaticGraphLSTM",
                                 "recurrent_arch_decoder": "StaticGraphLSTM"},
    "two-layer GRU encoder": {"enc_num_layers": 2},
    "z_activation identity": {"z_activation": "identity"},
}


def check_ae_variant(label: str, ae_variant: dict, obs, gen, card_name: str) -> dict:
    """An AutoEncoder variant: the fp32 predictor on the card against the
    same model on the CPU on a cut batch (VARIANT_TOL·max(1, |v|)); one
    timed full-width prediction on each path, its launches held: the bf16
    chain and K2, K1 once for a GRU decoder and never for an LSTM one.
    Returns the bf16 prediction's launches."""
    lstm = ae_variant.get("recurrent_arch_decoder") == "StaticGraphLSTM"
    k1 = {"gru_rollout": 0 if lstm else 1}
    skeleton, p32 = build_model(torch.device("cuda"), ae_variant=ae_variant)
    _, cpu = build_model(torch.device("cpu"), ae_variant=ae_variant)
    rows = VARIANT_CUT * SAMPLES
    start, steps = variant_noise(skeleton, p32, gen, rows)
    with torch.no_grad():
        card_pred, _ = p32(None, obs[:VARIANT_CUT], start_noise=start, step_noise=steps)
        cpu_pred, _ = cpu(None, obs[:VARIANT_CUT].cpu(), start_noise=start.cpu(),
                          step_noise=steps.cpu())
    card_m = skeleton.transform_to_metric_space(card_pred).cpu()
    cpu_m = skeleton.transform_to_metric_space(cpu_pred)
    err = (card_m - cpu_m).abs().max().item()
    tol = VARIANT_TOL * max(1.0, cpu_m.abs().max().item())
    if not (bool(torch.isfinite(card_m).all()) and err <= tol):
        raise AssertionError(f"{label}: card vs CPU max |Δ| {err} (tol {tol})")
    del cpu
    _, p16 = build_model(torch.device("cuda"), torch.bfloat16, ae_variant=ae_variant)
    if p16.use_fused_decode == lstm or not p16.use_fused_denoiser:
        raise AssertionError(f"{label}: K1 decode {p16.use_fused_decode}, kernel chain "
                             f"{p16.use_fused_denoiser}")
    run_main_path(skeleton, p32, obs, card_name, {**k1, "posterior_step": TIMESTEPS},
                  f"{label} fp32")
    launches = run_main_path(skeleton, p16, obs, card_name,
                             {**fused_launches(TIMESTEPS, "posterior_step_x0_bf16"), **k1},
                             f"{label} bf16")
    log(f"{label} on {card_name}: card vs CPU on {VARIANT_CUT} × {SAMPLES} max |Δ| {err:.3e} "
        f"(tol {tol:.1e}); decode {'plain step loop' if lstm else 'K1'}")
    return launches


def check_plain_decode(skeleton, predictor, obs, gen, card_name: str) -> None:
    """``use_fused_decode=False``: the plain decode in fp32 against K1 at
    12 800 rows (≤ K1_TOL); the predictor on it, timed; in bf16 (the
    Decoder's compute_dtype) on the decode check's model and inputs, its
    metric-space deviation from the fp32 decode beside B8's."""
    ae = predictor.autoencoder
    rows, n = BATCH * SAMPLES, skeleton.num_nodes
    x = 0.3 * torch.randn((rows, 2, n, 3), generator=gen, device="cuda")
    z = torch.tanh(torch.randn((rows, n, LATENT), generator=gen, device="cuda"))
    with torch.no_grad():
        k1, k1_ms = timed(lambda: ae.decode(x, z, PRED_LEN))
        plain, plain_ms = timed(lambda: ae.decode_plain(x, z, PRED_LEN))
    err = (k1 - plain).abs().max().item()
    if not err <= K1_TOL:
        raise AssertionError(f"plain decode vs K1: {err}")
    p_plain = SkeletonDiffusionPredictor(skeleton, ae, predictor.diffusion, num_samples=SAMPLES,
                                         pred_length=PRED_LEN, use_fused_decode=False,
                                         device=predictor.device)
    launches = run_main_path(skeleton, p_plain, obs, card_name, {"posterior_step": TIMESTEPS},
                             "main path fp32, plain decode")
    sk, dec32, x_last2, zc = decode_check.setup()
    dec16 = Decoder(sk.num_nodes, 3, decode_check.LAT, decode_check.HIDDEN, 3, torch.Generator(),
                    node_types=sk.nodes_type_id, compute_dtype=torch.bfloat16)
    dec16.load_state_dict(dec32.state_dict())
    dec16.cuda()
    with torch.no_grad():
        fp32 = decode_check.decode(dec32, x_last2, zc, decode_check.PH)
        plain16 = dec16.forward_plain(x_last2, zc, decode_check.PH)
    d_plain = decode_check.deviation_mm(sk, fp32, plain16)
    d_b8 = decode_check.decode_deviation(sk, dec32, x_last2, zc, decode_check.PH)
    log(f"plain decode (use_fused_decode=False) on {card_name}: fp32 vs K1 at {rows} rows max "
        f"{err:.3e} (tol {K1_TOL:.0e}); {plain_ms:.1f} ms against K1's {k1_ms:.1f} ms; "
        f"launches { {k: v for k, v in launches.items() if v} }; bf16 plain decode "
        f"vs the fp32 decode (the decode check's model and inputs, {x_last2.shape[0]} rows) mean "
        f"{d_plain.mean().item():.4f} mm max {d_plain.max().item():.4f} mm, B8 vs K1 mean "
        f"{d_b8.mean().item():.4f} mm max {d_b8.max().item():.4f} mm")
    if not bool(torch.isfinite(d_plain).all()):
        raise AssertionError("bf16 plain decode not finite")


def run_cli_isotropic(data_root: str, out: str, ae_dir: str, card_name: str,
                      expected_bf16: dict) -> None:
    """``cli.train_diffusion model=isotropic_diffusion`` on the cli phase's
    stage-1 experiment, then the eval CLI on it held against compute_metrics
    on its prepare_model (CLI_EVAL_TOL)."""
    args = [f"dataset_main_path={data_root}", *CLI_DATA, *CLI_TRAIN, "model=isotropic_diffusion",
            f"output_log_path={out}/isotropic",
            f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
            f"model.num_epochs={CLI_EPOCHS}"]
    exp, train_ms = run_main(train_diff_cli.main, "config_train_diffusion", args)
    check_experiment("cli isotropic stage 2", exp, CLI_EPOCHS)
    cfg = yaml_lite.read(os.path.join(exp, "config.yaml"))
    if (cfg["diffusion_type"], cfg["diffusion_loss_type"], cfg["latent_size"]) != (
            "IsotropicGaussianDiffusion", "l1", LATENT):
        raise AssertionError(f"cli isotropic config: {cfg['diffusion_type']}")
    eval_args = [f"dataset_main_path={data_root}", "dataset=amass", f"checkpoint_path={exp}",
                 "stats_mode=probabilistic", f"batch_size={BATCH}"]
    reset_counts()
    results, eval_ms = run_main(eval_cli.main, "config_eval", eval_args)
    counts = read_counts()
    batches = -(-EVAL_SEGMENTS // BATCH)
    check_counts("cli isotropic eval", counts, {k: v * batches for k, v in expected_bf16.items()})
    ecfg = eval_cli.merge_experiment_cfg(flatten_config(load_config(
        os.path.join("configs", "config_eval"), eval_args)))
    skeleton = build_skeleton(ecfg)
    predictor = eval_cli.prepare_model(ecfg, skeleton, torch.device("cuda"))
    dataset = build_dataset(ecfg, skeleton, "test", "data_loader_test", if_compute_cmd=True)
    direct = compute_metrics(
        predictor, dataset, skeleton, batch_size=BATCH, num_samples=SAMPLES,
        stats_mode="probabilistic", seed=0, if_compute_cmd=True, if_compute_apde=True,
        mmapd_gt_path=os.path.join(ecfg["annotations_folder"], "mmapd_GT.csv"))
    hold_metrics("cli isotropic eval vs compute_metrics", results, direct,
                 lambda w: CLI_EVAL_TOL * max(1.0, abs(w)))
    log(f"cli isotropic on {card_name}: cli.train_diffusion model=isotropic_diffusion "
        f"(compute_dtype {cfg.get('compute_dtype')}, k {cfg['train_pick_best_sample_among_k']}) "
        f"{CLI_EPOCHS} epochs × {CLI_ITERS} iterations in {train_ms / 1e3:.2f} s "
        f"(between epoch records {epoch_seconds(exp)} s, validation {validation_seconds(exp)} s); "
        f"cli.eval (bf16 kernel chain on the isotropic tables) {eval_ms / 1e3:.3f} s "
        f"({len(dataset) / eval_ms * 1e3:.2f} preds/s); ADE {results['ADE']:.4f}, APD "
        f"{results['APD']:.4f}; launches a batch "
        f"{ {k: v // batches for k, v in counts.items() if v} }")


def run_variants(skeleton, predictor, obs, gen, card_name: str, data_root: str, out: str,
                 ae_dir: str, expected_bf16: dict) -> dict:
    """The variants phase (``predictor``: the flagship's fp32 one); returns
    the launches of one prediction of each sampler variant on each path."""
    cuda = torch.device("cuda")
    k2_32, k2_16 = {"gru_rollout": 1, "posterior_step": TIMESTEPS}, "posterior_step_x0_bf16"
    launches = {}
    t = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t
        log(f"[variants part] {name}: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()

    for label, variant, exp32, exp16 in (
            ("isotropic", ISOTROPIC, k2_32, fused_launches(TIMESTEPS, k2_16)),
            (f"ddim{DDIM_STEPS}", {**ISOTROPIC, "sampling_timesteps": DDIM_STEPS},
             {"gru_rollout": 1}, fused_launches(DDIM_STEPS, "")),
            ("pred_noise", {"diffusion_objective": "pred_noise"}, k2_32,
             fused_launches(TIMESTEPS, "posterior_step"))):
        _, p32 = build_model(cuda, **variant)
        _, p16 = build_model(cuda, torch.bfloat16, **variant)
        part(f"{label} builds")
        for path, counts in check_variant(label, skeleton, p32, p16, obs, gen, card_name,
                                          exp32, exp16).items():
            launches[f"{label}_{path}"] = counts
        part(f"{label} checks")
        del p32, p16
    for label, variant in MODULE_VARIANTS.items():
        check_module_variant(label, variant, obs, gen, card_name)
        part(label)
    for label, ae_variant in AE_VARIANTS.items():
        launches[label] = check_ae_variant(label, ae_variant, obs, gen, card_name)
        part(label)
    check_plain_decode(skeleton, predictor, obs, gen, card_name)
    part("plain decode")
    run_cli_isotropic(data_root, out, ae_dir, card_name, expected_bf16)
    part("cli isotropic")
    return launches


def run_skeleton_paths(dataset: str, device: torch.device, card_name: str):
    """The flagship model at full width on the skeleton of ``dataset`` (H36M:
    16 nodes, observe 25, predict 100; FreeMan: 17, 15, 60): K1 and K2, the
    fp32 path, every kernel of the fused denoiser (B4, B1, B3a, B2, B3b, B5a,
    B5b, K2's bf16-x̂₀ entry) and of the layer-fused one (B9a–c) against its
    plain version as phases 3, 5 and 7 hold them, and the three paths
    (preds/s, launches, injected noise against their plain paths) as phases
    4, 6 and 8 do; B8 and L1 as phases 9 and 10 hold them, and their paths
    (``run_count_paths``).  Returns (the kernels' entries, each with its node count
    and its launches on the path that runs it, the fp32 and bf16
    predictors)."""
    skeleton, predictor = build_model(device, dataset=dataset)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, obs_len = skeleton.num_nodes, SKELETONS[dataset][1]
    label = f"{dataset} ({n} nodes, observe {obs_len}, predict {predictor.pred_length})"
    kernels = [check_gru_rollout(predictor, gen), check_posterior_step(predictor, gen)]
    obs = 0.3 * torch.randn((BATCH, obs_len, n, 3), generator=gen, device="cuda")
    launches = run_main_path(skeleton, predictor, obs, card_name, EXPECTED_FP32,
                             f"{label} path fp32")
    compare_with_plain(skeleton, predictor, obs, gen)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    _, predictor_bf16 = build_model(device, torch.bfloat16, dataset=dataset)
    hold_chain_route(label, predictor_bf16)
    fused = check_denoiser_kernels(predictor_bf16, gen)
    launches = run_main_path(skeleton, predictor_bf16, obs, card_name, EXPECTED_BF16,
                             f"{label} path bf16")
    # the predictions' mean is printed, not held (ROADMAP Queue C item 7)
    compare_bf16(skeleton, predictor_bf16, predictor, obs, gen, hold=HOLD_STATES_MEAN)
    for k in fused:
        k["launches"] = launches[k["name"]]
    log_kernel_time(f"{label} bf16 path", fused, launches)

    layer = check_layer_fused_kernels(predictor_bf16, gen)
    with layer_fused_path():
        launches = run_main_path(skeleton, predictor_bf16, obs, card_name,
                                 EXPECTED_LAYER_FUSED, f"{label} path bf16, layer-fused")
    compare_layer_fused(skeleton, predictor_bf16, predictor, obs, gen,
                        hold=HOLD_STATES_MEAN)
    for k in layer:
        k["launches"] = launches[k["name"]]
    log_kernel_time(f"{label} layer-fused bf16 path", fused + layer, launches)

    # B8 and L1 at this count against their plain versions, then their paths
    counted = [check_gru_rollout_bf16(predictor, gen, kernels[0]["ms"]),
               check_attention_core_fm(gen, n)]
    launches = run_count_paths(predictor, gen, card_name)
    for k in counted:
        k["launches"] = launches[k["name"]]
    return kernels + fused + layer + counted, predictor, predictor_bf16


def eval_config(dataset: str, data_root: str, extra=()) -> dict:
    """The eval CLI's flattened config of ``dataset`` on ``data_root``
    (configs/config_eval: its loader, lengths, CMD and APDE switches)."""
    return flatten_config(load_config(os.path.join("configs", "config_eval"), [
        f"dataset={dataset}", f"dataset_main_path={data_root}", "stats_mode=probabilistic",
        *extra]))


def zero_shot_segments(dataset: str, data_root: str) -> list:
    """3DPW's zero-shot test segments (``segments_test_zero_shot.csv``, all
    splits' sequences) in place of the config's ``segments_test.csv``."""
    if dataset != "3dpw":
        return []
    path = os.path.join(data_root, "annotations", "3DPW", "hmp", "segments_test_zero_shot.csv")
    return [f"dataset.data_loader_test.segments_path={path}"]


def write_fid_classifier(folder: str) -> None:
    """``h36m_classifier.pth`` in ``folder`` as the reference ships it
    (``{"model": state_dict}``, 48 inputs) with the weights of
    tests/goldens/fid_classifier.npz (the classifier the CPU tests hold
    against the JAX package; the real pretrained one is not in the
    repository)."""
    import numpy as np

    g = np.load(FID_GOLDEN)
    state = {k: torch.from_numpy(g[k]) for k in g.files if k not in ("motion", "feats", "logits")}
    torch.save({"model": state}, os.path.join(folder, "h36m_classifier.pth"))


def run_skeleton_eval(dataset: str, predictor_bf16, card_name: str, root: str) -> dict:
    """``compute_metrics`` (probabilistic, CMD; APDE on H36M; FID on H36M
    through the eval CLI's ``fid_classifier`` hook) with the bf16 predictor
    over the test split of ``dataset``'s shipped annotations (its first
    SKELETON_EVAL_CUT segments), its launches a batch as the bf16 path's, eval
    preds/s; ZeroVelocity on the card against the CPU on a tree of the first
    SKELETON_CPU_SEGMENTS segments; the eval batch's device time split
    (``EvalClock``: predictor, metric suite, FID features, the rest).
    AMASS-MANO's split is cut to MANO_EVAL_CUT segments.  Returns the
    launches."""
    skeleton = predictor_bf16.skeleton
    obs_len, pred_len = SKELETONS["amass" if dataset == "3dpw" else dataset][1:]
    ann = str(ANNOTATIONS / SKELETON_EVALS[dataset] / "hmp")
    t0 = time.perf_counter()
    cut = MANO_EVAL_CUT if dataset == "amass-mano" else SKELETON_EVAL_CUT
    data_root = make_synthetic_skeleton_tree(os.path.join(root, dataset), dataset, ann,
                                             obs_length=obs_len, pred_length=pred_len,
                                             max_segments=cut, seed=SEED)
    cfg = eval_config(dataset, data_root, zero_shot_segments(dataset, data_root))
    if (cfg["obs_length"], cfg["pred_length"]) != (obs_len, pred_len):
        raise AssertionError(f"{dataset}: the config's lengths {cfg['obs_length']}, "
                             f"{cfg['pred_length']}, expected {obs_len}, {pred_len}")
    fid = None
    if dataset == "h36m":
        write_fid_classifier(cfg["precomputed_folder"])
        fid = eval_cli.fid_classifier({**cfg, "if_compute_fid": True}, "test")
    ds = build_dataset(cfg, skeleton, "test", "data_loader_test", if_compute_cmd=True)
    n = len(ds)
    batches = -(-n // BATCH)
    log(f"{dataset} test split: {n} segments ({cfg['data_loader_test']['segments_path']}), "
        f"{batches} batches of {BATCH}, mm-GT up to {ds.max_mmgt_count} futures a segment; "
        f"tree written and read in {time.perf_counter() - t0:.1f} s")
    args = dict(batch_size=BATCH, num_samples=SAMPLES, stats_mode="probabilistic", seed=SEED,
                if_compute_cmd=True, if_compute_apde=bool(cfg.get("if_compute_apde")),
                mmapd_gt_path=os.path.join(cfg["annotations_folder"], "mmapd_GT.csv"),
                pred_length=pred_len, silent=True)
    clock = EvalClock(predictor_bf16, fid)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with clock.metrics():
        results = compute_metrics(clock, ds, skeleton, fid_classifier=fid, **args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"{dataset} eval bf16", counts,
                 {k: v * batches for k, v in EXPECTED_BF16.items()})
    want_keys = 11 + bool(args["if_compute_apde"]) + (fid is not None)
    if len(results) != want_keys or not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"{dataset} eval bf16: metric table {results}")
    log(f"{dataset} eval bf16 metric table:\n" + suite_mod.draw_table(results))
    log(f"{dataset} eval bf16: {n / wall:.2f} eval preds/s ({n} segments × {SAMPLES} samples "
        f"in {wall:.3f} s, {skeleton.num_nodes} nodes, predict {pred_len}) on {card_name}")
    split = clock.split()
    log(f"{dataset} eval bf16 split per batch, median of {len(split)} batches, ms (CUDA "
        f"events): " + ", ".join(f"{k} {statistics.median(b[k] for b in split):.2f}"
                                 for k in ("period", "predictor", "metrics", "fid", "rest"))
        + f" (rest: host data, transfer, preprocess and idle); the periods sum to "
        f"{sum(b['period'] for b in split):.1f} of the {wall * 1e3:.1f} ms wall, the first "
        f"batch's {split[0]['period']:.2f} (predictor {split[0]['predictor']:.2f}, metrics "
        f"{split[0]['metrics']:.2f}, fid {split[0]['fid']:.2f}, rest {split[0]['rest']:.2f})")

    small = make_synthetic_skeleton_tree(os.path.join(root, f"{dataset}_cut"), dataset, ann,
                                         obs_length=obs_len, pred_length=pred_len,
                                         max_segments=SKELETON_CPU_SEGMENTS, seed=SEED)
    cut = build_dataset(eval_config(dataset, small, zero_shot_segments(dataset, small)),
                        skeleton, "test", "data_loader_test", if_compute_cmd=True)
    zero = {d: compute_metrics(ZeroVelocityPredictor(skeleton, SAMPLES, pred_len, device=d),
                               cut, skeleton, **args) for d in ("cuda", "cpu")}
    hold_metrics(f"{dataset} eval ZeroVelocity, card vs CPU ({len(cut)} segments)",
                 zero["cuda"], zero["cpu"], lambda w: EVAL_DEVICE_TOL * max(1.0, abs(w)))
    return counts


def run_skeleton_cli(root: str, card_name: str) -> None:
    """``cli.train_autoencoder`` and ``cli.train_diffusion`` with
    ``dataset=h36m`` at the width of configs/** (CLI_EPOCHS epochs ×
    CLI_ITERS iterations, validation each epoch on the shipped S8 segments),
    then ``cli.eval dataset=h36m`` on the stage-2 experiment (with FID)
    against ``compute_metrics`` on its ``prepare_model`` with the same seed,
    on a tree of SKELETON_CLI_SEGMENTS segments a CSV."""
    data_root = make_synthetic_skeleton_tree(
        os.path.join(root, "h36m_cli"), "h36m", str(ANNOTATIONS / "Human36M" / "hmp"),
        obs_length=25, pred_length=100, max_segments=SKELETON_CLI_SEGMENTS, seed=SEED + 1)
    common = ["dataset=h36m", f"dataset_main_path={data_root}", *CLI_TRAIN]
    ae_dir, ae_ms = run_main(train_ae_cli.main, "config_train_autoencoder", common + [
        f"output_log_path={root}/h36m_ae", f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("h36m cli stage 1", ae_dir, CLI_EPOCHS)
    diff_dir, diff_ms = run_main(train_diff_cli.main, "config_train_diffusion", [
        f"dataset_main_path={data_root}", *CLI_TRAIN, f"output_log_path={root}/h36m_diffusion",
        f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
        f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("h36m cli stage 2", diff_dir, CLI_EPOCHS)
    cfg = yaml_lite.read(os.path.join(diff_dir, "config.yaml"))
    if (cfg["dataset_name"], cfg["num_joints"], cfg["latent_size"]) != ("h36m", 17, LATENT):
        raise AssertionError(f"h36m cli stage 2 config: {cfg['dataset_name']}, "
                             f"{cfg['num_joints']}, {cfg['latent_size']}")
    write_fid_classifier(eval_config("h36m", data_root)["precomputed_folder"])
    extra = [f"checkpoint_path={diff_dir}", f"batch_size={BATCH}", "if_compute_fid=True",
             f"results_path={root}/h36m_results.yaml"]
    got, eval_ms = run_main(eval_cli.main, "config_eval", [
        "dataset=h36m", f"dataset_main_path={data_root}", "stats_mode=probabilistic", *extra])
    ecfg = eval_cli.merge_experiment_cfg(eval_config("h36m", data_root, extra))
    skeleton = build_skeleton(ecfg)
    predictor = eval_cli.prepare_model(ecfg, skeleton, torch.device("cuda"))
    ds = build_dataset(ecfg, skeleton, "test", "data_loader_test", if_compute_cmd=True)
    want = compute_metrics(predictor, ds, skeleton, batch_size=BATCH,
                           num_samples=ecfg["num_samples"], stats_mode="probabilistic",
                           seed=ecfg.get("seed", 0), if_compute_cmd=True,
                           if_compute_apde=bool(ecfg.get("if_compute_apde")),
                           mmapd_gt_path=os.path.join(ecfg["annotations_folder"], "mmapd_GT.csv"),
                           pred_length=ecfg["pred_length"], silent=True,
                           fid_classifier=eval_cli.fid_classifier(ecfg, "test"))
    if "FID" not in got:
        raise AssertionError(f"h36m eval cli: no FID in {sorted(got)}")
    hold_metrics("h36m eval cli vs compute_metrics on prepare_model", got, want,
                 lambda w: CLI_EVAL_TOL * max(1.0, abs(w)))
    log(f"h36m cli on {card_name}: stage 1 {CLI_EPOCHS} epochs × {CLI_ITERS} iterations in "
        f"{ae_ms / 1e3:.2f} s, stage 2 (bf16, k {TRAIN_K}) in {diff_ms / 1e3:.2f} s, the eval "
        f"cli over {len(ds)} segments in {eval_ms / 1e3:.2f} s")


def check_refusals() -> None:
    """Past 51 nodes every kernel refuses on the card before it launches,
    naming the ROADMAP item of shapes no skeleton of the reference has (B8
    and L1 too: they take every skeleton's count); so do the fp32 engine's
    plans at 51 (their tiles do not fit, ROADMAP Queue B item 10); K2
    refuses a bf16 x̂₀ whose rows a tensor map cannot address."""
    n, rows = 52, 64
    x = torch.zeros((n, rows, 192), dtype=torch.bfloat16, device="cuda")
    bf = dict(dtype=torch.bfloat16, device="cuda")
    calls = {"rms_qkv": lambda: proj_mod.rms_qkv(x, x[0, 0], torch.zeros(
                 (n, 192, 768), dtype=torch.bfloat16, device="cuda"), x[:, 0, :n]),
             "attention_core": lambda: attn_mod.attention_core(
                 torch.zeros((n, rows, 768), dtype=torch.bfloat16, device="cuda"), heads=8,
                 dim_head=32),
             "posterior_step": lambda: posterior_mod.posterior_step(
                 *(torch.zeros((n, rows, 96), device="cuda") for _ in range(3)),
                 torch.zeros((n, 3 * n), device="cuda")),
             "gru_rollout": lambda: rollout_mod.gru_rollout(
                 *(torch.zeros(s, device="cuda") for s in (
                     (n, rows, 288), (n, rows, 96), (n, 96, 288), (n, 288), (n, n), (n, n),
                     (n, 96, 3), (n, 3), (n, n))), ph=2),
             "gru_rollout_bf16": lambda: rollout_mod.gru_rollout(
                 torch.zeros((n, rows, 288), **bf), torch.zeros((n, rows, 96), device="cuda"),
                 torch.zeros((n, 96, 288), **bf),
                 *(torch.zeros(s, device="cuda") for s in ((n, 288), (n, n), (n, n))),
                 torch.zeros((n, 96, 3), **bf),
                 *(torch.zeros(s, device="cuda") for s in ((n, 3), (n, n))), ph=2,
                 compute_dtype=torch.bfloat16),
             "attention_core_fm": lambda: fm_mod.attention_core_fm(
                 torch.zeros((n, 768, rows), **bf), heads=8, dim_head=32)}
    m = 51
    at51 = {"resnet_block fp32": lambda: block_mod.resnet_block_plan(torch.float32, 192, m),
            "rms_qkv fp32": lambda: proj_mod.rms_qkv_plan(torch.float32, 192, 768, m),
            "rms_qkv_core fp32": lambda: layer_mod.rms_qkv_core_plan(torch.float32, 192, 8, 32,
                                                                     m)}
    # K2's tensor maps want rows of whole 16 bytes: a bf16 x̂₀ of B·D = 12
    # columns is refused
    calls["posterior_step bf16 12 columns"] = lambda: posterior_mod.posterior_step(
        torch.zeros((21, 3, 4), dtype=torch.bfloat16, device="cuda"),
        *(torch.zeros((21, 3, 4), device="cuda") for _ in range(2)),
        torch.zeros((21, 63), device="cuda"))
    before = read_counts()
    for name, call, want in [*((k, c, "multiple of 8" if "12 columns" in k
                                else "no skeleton of the reference") for k, c in calls.items()),
                             *((k, c, "Queue B item 10") for k, c in at51.items())]:
        try:
            call()
        except ValueError as e:
            if want not in str(e):
                raise
        else:
            raise AssertionError(f"{name} was not refused")
    if read_counts() != before:
        raise AssertionError("a refused call counted a launch")
    at52 = [k for k in calls if "12 columns" not in k]
    log(f"refusals: {', '.join(at52)} at {n} nodes raise, naming shapes no skeleton of the "
        f"reference has (ROADMAP Queue B item 9); at {m} nodes the fp32 engine's plans (Queue B "
        f"item 10); K2 refuses a bf16 x̂₀ of 12 columns (a TMA row is whole 16 bytes)")


def run_skeletons(device: torch.device, card_name: str, predictor_bf16_amass):
    """The skeletons phase: H36M's and FreeMan's kernels and paths
    (``run_skeleton_paths``), the three test splits' evaluation
    (``run_skeleton_eval``; 3DPW zero-shot on the AMASS model), and the H36M
    CLIs (``run_skeleton_cli``).  Returns the kernels' entries at 16 and 17
    nodes, each with its launches on its path and in its dataset's eval, and
    the launches of the 3DPW eval."""
    check_refusals()
    entries, predictors = [], {"3dpw": predictor_bf16_amass}
    for dataset in ("h36m", "freeman"):
        t = time.perf_counter()
        got, _, predictors[dataset] = run_skeleton_paths(dataset, device, card_name)
        entries += got
        log(f"skeletons: {dataset} kernels and paths {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        evals = {}
        for dataset in ("h36m", "freeman", "3dpw"):
            t = time.perf_counter()
            evals[dataset] = run_skeleton_eval(dataset, predictors[dataset], card_name, root)
            n = predictors[dataset].skeleton.num_nodes
            for k in entries:
                if k["nodes"] == n:
                    k["eval_launches"] = evals[dataset][k["name"]]
            log(f"skeletons: {dataset} eval {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_skeleton_cli(root, card_name)
        log(f"skeletons: h36m cli {time.perf_counter() - t:.1f} s")
    return entries, evals["3dpw"]


def run_mano_cli(root: str, card_name: str) -> None:
    """``cli.train_autoencoder`` and ``cli.train_diffusion`` with
    ``dataset=amass-mano`` at the width of configs/** (CLI_EPOCHS epochs ×
    CLI_ITERS iterations, validation each epoch on the tree's validation
    clips), then ``cli.eval dataset=amass-mano`` on the stage-2 experiment
    against ``compute_metrics`` on its ``prepare_model`` with the same seed,
    on a tree of SKELETON_CLI_SEGMENTS segments a CSV."""
    data_root = make_synthetic_skeleton_tree(
        os.path.join(root, "mano_cli"), "amass-mano", str(ANNOTATIONS / "AMASS-MANO" / "hmp"),
        obs_length=OBS_LEN, pred_length=PRED_LEN, max_segments=SKELETON_CLI_SEGMENTS,
        seed=SEED + 1)
    common = ["dataset=amass-mano", f"dataset_main_path={data_root}", *CLI_TRAIN]
    ae_dir, ae_ms = run_main(train_ae_cli.main, "config_train_autoencoder", common + [
        f"output_log_path={root}/mano_ae", f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("amass-mano cli stage 1", ae_dir, CLI_EPOCHS)
    diff_dir, diff_ms = run_main(train_diff_cli.main, "config_train_diffusion", [
        f"dataset_main_path={data_root}", *CLI_TRAIN, f"output_log_path={root}/mano_diffusion",
        f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
        f"model.num_epochs={CLI_EPOCHS}"])
    check_experiment("amass-mano cli stage 2", diff_dir, CLI_EPOCHS)
    cfg = yaml_lite.read(os.path.join(diff_dir, "config.yaml"))
    if (cfg["dataset_name"], cfg["num_joints"], cfg["latent_size"]) != ("amass-mano", 52, LATENT):
        raise AssertionError(f"amass-mano cli stage 2 config: {cfg['dataset_name']}, "
                             f"{cfg['num_joints']}, {cfg['latent_size']}")
    extra = [f"checkpoint_path={diff_dir}", f"batch_size={BATCH}",
             f"results_path={root}/mano_results.yaml"]
    got, eval_ms = run_main(eval_cli.main, "config_eval", [
        "dataset=amass-mano", f"dataset_main_path={data_root}", "stats_mode=probabilistic",
        *extra])
    ecfg = eval_cli.merge_experiment_cfg(eval_config("amass-mano", data_root, extra))
    skeleton = build_skeleton(ecfg)
    predictor = eval_cli.prepare_model(ecfg, skeleton, torch.device("cuda"))
    ds = build_dataset(ecfg, skeleton, "test", "data_loader_test", if_compute_cmd=True)
    want = compute_metrics(predictor, ds, skeleton, batch_size=BATCH,
                           num_samples=ecfg["num_samples"], stats_mode="probabilistic",
                           seed=ecfg.get("seed", 0), if_compute_cmd=True,
                           if_compute_apde=bool(ecfg.get("if_compute_apde")),
                           mmapd_gt_path=os.path.join(ecfg["annotations_folder"], "mmapd_GT.csv"),
                           pred_length=ecfg["pred_length"], silent=True)
    if skeleton.num_nodes != 51 or not predictor.use_fused_denoiser:
        raise AssertionError(f"amass-mano eval cli: {skeleton.num_nodes} nodes, fused denoiser "
                             f"{predictor.use_fused_denoiser}")
    hold_metrics("amass-mano eval cli vs compute_metrics on prepare_model", got, want,
                 lambda w: CLI_EVAL_TOL * max(1.0, abs(w)))
    log(f"amass-mano cli on {card_name}: stage 1 {CLI_EPOCHS} epochs × {CLI_ITERS} iterations in "
        f"{ae_ms / 1e3:.2f} s, stage 2 (bf16, k {TRAIN_K}) in {diff_ms / 1e3:.2f} s, the eval "
        f"cli over {len(ds)} segments in {eval_ms / 1e3:.2f} s")


def run_mano(device: torch.device, card_name: str):
    """The mano phase: AMASS-MANO's kernels and paths at 51 nodes
    (``run_skeleton_paths``), its bf16 evaluation on the shipped test split
    cut to MANO_EVAL_CUT segments (``run_skeleton_eval``), and its CLIs
    (``run_mano_cli``).  Returns the kernels' entries at 51 nodes, each with
    its launches on its path and in the eval."""
    t = time.perf_counter()
    entries, _, predictor_bf16 = run_skeleton_paths("amass-mano", device, card_name)
    log(f"mano: kernels and paths {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        launches = run_skeleton_eval("amass-mano", predictor_bf16, card_name, root)
        for k in entries:
            k["eval_launches"] = launches[k["name"]]
        log(f"mano: eval {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        run_mano_cli(root, card_name)
        log(f"mano: cli {time.perf_counter() - t:.1f} s")
    return entries


# The small phase: K1 at these hidden widths beside the flagship's 96 (21
# nodes, the flagship's batch and steps), and the JAX quickstart's models
# through its twin, examples/torch_quickstart_synthetic.py.
SMALL_WIDTHS = (16, 32, 64, 128)
QUICKSTART = pathlib.Path(__file__).resolve().parent / "examples"
CHAIN_KERNELS = sorted((set(EXPECTED_BF16) | set(EXPECTED_LAYER_FUSED))
                       - {"gru_rollout", "posterior_step_x0_bf16"})


def hold_chain_route(label: str, predictor) -> None:
    """A bf16 predictor at a width the JAX gate admits (the flagship's, the
    widths phase's) takes the kernel chain: the route by width must not move
    it onto the plain modules."""
    if not predictor.use_fused_denoiser:
        raise AssertionError(f"{label}: the bf16 predictor left the kernel chain: "
                             f"{predictor.fused_denoiser_refusal}")
    log(f"{label}: bf16 denoiser on the kernel chain (use_fused_denoiser True)")


def rollout_width_inputs(n: int, h: int, rows: int, gen: torch.Generator) -> dict:
    """K1's inputs at n nodes and hidden width h from ``gen``: gates and
    states O(1), banks scaled by 1/√h as a trained decoder's, influences
    row-normalized near the identity."""
    def rnd(*shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def infl():
        g = torch.eye(n, device="cuda") + 0.2 * torch.rand((n, n), generator=gen, device="cuda")
        return g / g.sum(dim=1, keepdim=True)

    return dict(cx=rnd(n, rows, 3 * h, scale=0.5), h0=rnd(n, rows, h, scale=0.5),
                w_hh=rnd(n, h, 3 * h, scale=h ** -0.5), b_hh=rnd(n, 3 * h, scale=0.1),
                g0=infl(), g_add=0.05 * infl(), w_fc=rnd(n, h, 3, scale=h ** -0.5),
                b_fc=rnd(n, 3, scale=0.1), g_fc=infl())


def check_rollout_width(h: int, gen: torch.Generator, n: int = 21) -> dict:
    """K1 built at hidden width h against its plain version at the
    flagship's 12 800 rows and 120 steps, a ragged 12 795 and
    ``odd_cluster_rows``; timed beside the plain version, with its bound."""
    rows, ph = BATCH * SAMPLES, PRED_LEN
    inp = rollout_width_inputs(n, h, rows, gen)
    plan = rollout_mod.rollout_plan(n, h)
    err = 0.0
    with torch.no_grad():
        for cut in (rows, rows - RAGGED, odd_cluster_rows(plan)):
            args = {k: v[:, :cut].contiguous() if k in ("cx", "h0") else v for k, v in inp.items()}
            got = rollout_mod.gru_rollout(**args, ph=ph)
            want = rollout_mod.gru_rollout_plain(**args, ph=ph)
            torch.cuda.synchronize()
            cut_err = (got - want).abs().max().item()
            if not (got.shape == want.shape and cut_err <= K1_TOL):
                raise AssertionError(f"gru_rollout at hidden {h} disagrees with its plain version "
                                     f"at {cut} rows: {cut_err}")
            err = max(err, cut_err)
        ms = cuda_ms(lambda: rollout_mod.gru_rollout(**inp, ph=ph), reps=3)
        plain_ms = cuda_ms(lambda: rollout_mod.gru_rollout_plain(**inp, ph=ph), reps=2)
    f = 3
    flops_row_step = 2 * n * h * 3 * h + 2 * n * n * h * 4 + 2 * n * h * f + 2 * n * n * f
    compulsory = sum(t.numel() for t in inp.values()) + ph * n * rows * f
    bnd, by = bound_ms(4.0 * compulsory, float(flops_row_step) * rows * ph)
    log(f"gru_rollout at hidden {h} ({n} nodes): max_abs_err {err:.3e} (tol {K1_TOL:.0e}) at "
        f"{rows}, {rows - RAGGED} and {odd_cluster_rows(plan)} rows; plan {plan._asdict()}; "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.3f} ms ({by})")
    return {"name": "gru_rollout", "hidden": h, "nodes": n, "steps": ph, "rows": rows,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "plan": list(plan)}


def run_small(card_name: str) -> dict:
    """The small phase (see the head of this file); returns the launches of
    the quickstart's pipeline."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    widths = [check_rollout_width(h, gen) for h in SMALL_WIDTHS]
    log(json.dumps({"k1_widths": widths, "card": card_name}))
    sys.path.insert(0, str(QUICKSTART))
    import torch_quickstart_synthetic as quickstart

    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        reset_counts()
        out = quickstart.main(["--out", os.path.join(root, "quickstart"), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = read_counts()
        seconds = time.perf_counter() - t
    predictor, served, results = out["predictor"], out["served"], out["results"]
    ae = predictor.autoencoder
    hidden = ae.decoder.rollout.cell.hidden_banks()[0].shape[-2]
    den = predictor.diffusion.denoiser
    chain = {k: launches[k] for k in CHAIN_KERNELS if launches[k]}
    posterior = launches["posterior_step"] + launches["posterior_step_x0_bf16"]
    # its denoiser (F = 32, 2 heads × 4) takes the chain padded (F 64, heads of 16)
    hold_chain_route("quickstart", predictor)
    if hidden != 16 or not predictor.use_fused_decode or launches["gru_rollout"] == 0:
        raise AssertionError(f"quickstart: K1 at hidden {hidden}, fused decode "
                             f"{predictor.use_fused_decode}, {launches['gru_rollout']} launches")
    if set(chain) != set(EXPECTED_BF16) - {"gru_rollout", "posterior_step_x0_bf16"} or \
            launches["posterior_step_x0_bf16"] == 0:
        raise AssertionError(f"quickstart: chain kernels launched {chain}, K2 {posterior} times")
    if not (tuple(served.shape) == (2, 4, 15, 21, 3) and bool(torch.isfinite(served).all())
            and all(math.isfinite(v) for v in results.values())):
        raise AssertionError(f"quickstart: served {tuple(served.shape)}, finite "
                             f"{bool(torch.isfinite(served).all())}, metrics {results}")
    log(f"small: the quickstart's pipeline on {card_name} in {seconds:.1f} s (train both "
        f"stages, eval, export, serve): ADE {results['ADE']:.4f}, APD {results['APD']:.4f}; "
        f"denoiser {den.dim}+{den.cond_dim} wide, {den.attn_heads} heads × {den.attn_dim_head}, "
        f"on the kernel chain at {predictor.diffusion.fused['widths']}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# The widths phase: the grid G of widths the JAX predictor's fused gate
# admits (bf16, heads·dh a multiple of 128, F = 2·latent ≤ 256), each a
# full-width model of the flagship's other widths (encoder and decoder hidden
# 96, depth 4, 10 steps, 21 nodes): name → (latent D, heads, dim_head).  The
# chain runs them padded (F to 64, D and the head's columns to 8, dh to 16,
# 32, 64 or 128; ops/kernels/denoiser_fused.py).
WIDTH_GRID = {"G1": (80, 8, 16), "G2": (96, 2, 64), "G3": (112, 1, 128), "G4": (100, 4, 32),
              "G5": (128, 4, 64), "G6": (48, 32, 4)}
# B2 and B9b alone at 51 nodes at the wide heads: (heads, head width, F)
WIDE_HEADS_51 = ((4, 64, 256), (1, 128, 256))


def check_wide_heads(n: int, heads: int, width: int, f: int, gen: torch.Generator) -> list:
    """B2 and B9b at ``n`` nodes for ``heads`` heads of ``width`` columns at
    input width ``f`` on random operands (B2 on B3a's output), against
    their plain versions as ``check_fused_kernel`` holds them (B2 in fp32
    too; B9b's fp32 tiles are built for heads up to 32 only)."""
    rows, hd, bf16 = BATCH * SAMPLES, heads * width, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(bf16)

    g = torch.eye(n, device="cuda") + 0.2 * torch.rand((n, n), generator=gen, device="cuda")
    g = (g / g.sum(dim=1, keepdim=True)).to(bf16)
    # the RMSNorm gain with √F folded in, as the chain's prep gives it: O(1) q, k, v
    x, w_qkv = rnd(n, rows, f, scale=0.5), rnd(n, f, 3 * hd, scale=f ** -0.5)
    g_rms = (f ** 0.5 * (1 + 0.1 * torch.randn(f, generator=gen, device="cuda"))).to(bf16)
    with torch.no_grad():
        qkv = proj_mod.rms_qkv(x, g_rms, w_qkv, g)
        q, k, v = (t.reshape(n, rows, heads, width).permute(1, 2, 0, 3)
                   .reshape(rows * heads, n, width).contiguous() for t in qkv.split(hd, dim=-1))
        core = 4.0 * rows * heads * n * n * width
        mix = 2.0 * n * n * rows * 3 * hd
        return [
            check_fused_kernel(
                "attention_core", functools.partial(attn_mod.attention_core, heads=heads,
                                                    dim_head=width),
                functools.partial(attn_mod.attention_core_plain, heads=heads, dim_head=width),
                [qkv], replaces="joint_attention.py:124", source="joint_attention.cu",
                tensor_flops=core,
                library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                odd_rows=tuple(odd_tile_rows(attn_mod.attention_plan(dt, heads, width, n).rows)
                               for dt in (bf16, torch.float32))),
            check_fused_kernel(
                "rms_qkv_core",
                functools.partial(layer_mod.rms_qkv_core, heads=heads, dim_head=width),
                functools.partial(layer_mod.rms_qkv_core_plain, heads=heads, dim_head=width),
                [x, g_rms, w_qkv, g], replaces="layer_fused.py:285", source="layer_fused.cu",
                tensor_flops=2.0 * n * rows * f * 3 * hd + mix + core,
                products=products_only((x, w_qkv)), f32=False,
                odd_rows=odd_qkv_rows(
                    lambda dt: layer_mod.rms_qkv_core_plan(dt, f, heads, width, n), n, (bf16,))),
        ]


def same_bytes_b2_ms(n: int, heads: int, dh: int, gen: torch.Generator) -> float:
    """B2's ms at heads·dh/16 heads of 16 on random operands at the bench
    rows: the bytes of ``heads`` heads of ``dh`` < 16 (which the chain pads
    to 16 columns) on the same kernel, the least a kernel that masked the
    pad in place of it could take (it would still run ``heads`` softmaxes a
    row)."""
    eq = heads * dh // 16
    qkv = torch.randn((n, BATCH * SAMPLES, 3 * eq * 16), generator=gen,
                      device="cuda").to(torch.bfloat16)
    return cuda_ms(lambda: attn_mod.attention_core(qkv, heads=eq, dim_head=16), reps=20)


def run_width(name: str, card_name: str, gen: torch.Generator) -> list:
    """One width of WIDTH_GRID: the bf16 model on the chain
    (``hold_chain_route``), each chain kernel at the bench shapes against its
    plain version (``check_denoiser_kernels``, ``check_layer_fused_kernels``
    at the chain's widths, bf16; B2 in fp32 too), the bf16 and layer-fused
    paths (preds/s, launches) held with injected noise against their plain
    versions (``hold_bf16``, HOLD_WIDTHS), and the plain bf16 denoiser
    module, the route this width took before (preds/s); at heads narrower
    than 16, B2 at the true width's bytes beside it (``same_bytes_b2_ms``).
    Returns the kernels' entries with the launches of one prediction on
    their path."""
    latent, heads, dh = WIDTH_GRID[name]
    arch = {**ARCH, "attn_heads": heads, "attn_dim_head": dh}
    device = torch.device("cuda")
    skeleton, p16 = build_model(device, torch.bfloat16, latent=latent, diffusion_arch=arch)
    _, p32 = build_model(device, latent=latent, diffusion_arch=arch)
    label = f"widths {name} (latent {latent}, {heads} heads × {dh})"
    hold_chain_route(label, p16)
    log(f"{label}: the chain's widths {p16.diffusion.fused['widths']}")
    entries = (check_denoiser_kernels(p16, gen, flagship=False)
               + check_layer_fused_kernels(p16, gen, flagship=False))
    if p16.diffusion.fused["widths"].width != dh:
        b2 = next(e for e in entries if e["name"] == "attention_core")
        b2["same_bytes_ms"] = same_bytes_b2_ms(skeleton.num_nodes, heads, dh, gen)
        log(f"{label}: B2 {b2['ms']:.4f} ms on heads of {dh} padded to 16, "
            f"{b2['same_bytes_ms']:.4f} ms at {heads * dh // 16} heads of 16 (the true width's "
            f"bytes), bound {b2['bound_ms']:.4f} ms (padded {b2['padded_bound_ms']:.4f})")
    obs = 0.3 * torch.randn((BATCH, OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                            device="cuda")
    rates = []
    launches = run_main_path(skeleton, p16, obs, card_name, EXPECTED_BF16, f"{label} bf16 path",
                             rates)
    # the predictions' mean printed, not held, as at 16 and 17 nodes (ROADMAP
    # Queue C item 7): at G6 the states' mean ratio 0.833 reads 1.023 after
    # the decode, whichever kernel runs (scripts/torch_widths_hold.py)
    compare_bf16(skeleton, p16, p32, obs, gen, hold=HOLD_WIDTHS)
    with layer_fused_path():
        layer = run_main_path(skeleton, p16, obs, card_name, EXPECTED_LAYER_FUSED,
                              f"{label} layer-fused bf16 path", rates)
    compare_layer_fused(skeleton, p16, p32, obs, gen, hold=HOLD_WIDTHS)
    fused, p16.diffusion.fused = p16.diffusion.fused, None
    try:  # the route before: the plain bf16 denoiser module, K2's fp32 entry
        run_main_path(skeleton, p16, obs, card_name, EXPECTED_FP32,
                      f"{label} plain bf16 denoiser", rates)
    finally:
        p16.diffusion.fused = fused
    log(f"{label}: {rates[0]:.2f} preds/s on the chain, {rates[1]:.2f} layer-fused, "
        f"{rates[2]:.2f} on the plain bf16 denoiser ({rates[0] / rates[2]:.2f}×) on {card_name}")
    for e in entries:
        e.update(grid=name, heads=f"{heads} × {dh}",
                 launches=(launches if e["name"] in EXPECTED_BF16 else layer)[e["name"]],
                 preds_s={"chain": rates[0], "layer_fused": rates[1], "plain_bf16": rates[2]})
    return entries


def run_widths(card_name: str) -> list:
    """The widths phase (see the head of this file); returns the kernels'
    entries."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    entries = []
    for name in WIDTH_GRID:
        entries += run_width(name, card_name, gen)
    for heads, width, f in WIDE_HEADS_51:
        for e in check_wide_heads(51, heads, width, f, gen):
            e.update(grid=f"51 nodes, F {f}", heads=f"{heads} × {width}", launches=0)
            entries.append(e)
    return entries


# The capstone phase: scripts/torch_convergence_capstone.py at full width
# (the flagship's configs, observe 30, predict 120, its full-size synthetic
# motion tree) on a minimal schedule set through the script's own overrides.
CAPSTONE_CUT = ["--ae-epochs", "1", "--ae-iters", "2", "--diff-epochs", "1", "--diff-iters", "2",
                "--diff-warmup", "1", "--eval-freq", "1"]
# the kernels the capstone's run must launch: K1 (the AutoEncoder's
# validation, stage 2's k-best decode, the evals), K2 and the single-stage
# bf16 chain (stage 2's validation, the evals)
CAPSTONE_KERNELS = tuple(EXPECTED_BF16)


def run_capstone(card_name: str) -> dict:
    """The convergence capstone's twin through its ``main`` on a temporary
    root (``CAPSTONE_CUT``): the run ends with every phase done, its report
    has every key of the JAX script's report, and K1, K2 and the bf16 chain
    were launched.  Returns the launches of the run."""
    import torch_convergence_capstone as capstone

    jax_keys = {"description", "smoke", "partial_variants_missing", "config", "metrics",
                "valid_ade_trajectory_k50_motion", "valid_ade_trajectory_autoencoder",
                "kept_checkpoints_k50_motion", "final_lr", "curriculum_ph_max",
                "limb_stretch_flagship_mm", "checks", "margins", "last_phase_done",
                "timings_sec"}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "torch_convergence.json")
        reset_counts()
        t = time.perf_counter()
        try:
            report = capstone.main(["--root", root, "--out-json", out, *CAPSTONE_CUT])
        finally:
            os.chdir(cwd)
        seconds = time.perf_counter() - t
        counts = read_counts()
        with open(out) as f:
            banked = json.load(f)
    missing = jax_keys - set(report)
    if report["last_phase_done"] != "all" or missing or banked != json.loads(json.dumps(report)):
        raise AssertionError(f"capstone: last phase {report['last_phase_done']}, keys missing "
                             f"{sorted(missing)}, or the banked report differs")
    if report["partial_variants_missing"] or len(report["metrics"]) != 4:
        raise AssertionError(f"capstone: runs {sorted(report['metrics'])}")
    idle = [k for k in CAPSTONE_KERNELS if not counts[k]]
    if idle:
        raise AssertionError(f"capstone: {idle} never launched: {counts}")
    log(f"capstone on {card_name}: scripts/torch_convergence_capstone.py {' '.join(CAPSTONE_CUT)} "
        f"in {seconds:.1f} s (phases {report['timings_sec']}); flagship/ZV ADE ratio "
        f"{report['margins']['flagship_over_zv_ade_ratio']}, checks judged "
        f"{sum(v is not None for v in report['checks'].values())} of {len(report['checks'])}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


# ---- the serving phase ----------------------------------------------------------

SERVING_BUCKETS = {"bf16": [64, 256], "fp32": [256]}
SERVING_TIMEOUT_S = 900
# the fresh process of the serving phase: the serving module, the kernel
# wrappers it registers as ops and torch.export.load, no model class.  It
# loads every artifact under args["root"], then waits for a line on its
# standard input (the main process sends it when the serving phase begins,
# so that nothing else runs on the card meanwhile), runs one call of each
# bucket with a generator seeded with SEED + 50 on the phase's observations
# (its output saved beside the artifact) between a reset and a read of the
# launch counters, times TIMED_CALLS more calls and prints one JSON line
SERVE = r"""
import json, sys, time
import torch
from skeletondiffusion_tpu_torch.serving import ServingModel
from skeletondiffusion_tpu_torch.ops.kernels import (graph_linear_fused, gru_rollout,
    joint_attention, attention_proj, posterior_step, resnet_block)
COUNTERS = {"gru_rollout": (gru_rollout, "launches"),
            "posterior_step": (posterior_step, "launches"),
            "posterior_step_x0_bf16": (posterior_step, "launches_x0_bf16"),
            "graph_linear_fused": (graph_linear_fused, "launches"),
            "resnet_block": (resnet_block, "launches_block"),
            "rms_qkv": (attention_proj, "launches_rms_qkv"),
            "attention_core": (joint_attention, "launches"),
            "outproj_res": (attention_proj, "launches_outproj_res"),
            "final_block_in": (resnet_block, "launches_final_in"),
            "final_block_out": (resnet_block, "launches_final_out")}
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
args = json.loads(sys.argv[1])
out, models = {}, {}
for name in args["names"]:
    t0 = time.perf_counter()
    models[name] = ServingModel(f"{args['root']}/{name}", device="cuda")
    out[name] = {"load_s": time.perf_counter() - t0}
sys.stdin.readline()
obs = 0.3 * torch.randn(args["obs_shape"], device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(args["seed"] - 1))
gen = lambda i: torch.Generator(device="cuda").manual_seed(args["seed"] + i)
for name, model in models.items():
    for rows in model.batch_sizes:
        model(gen(1), obs[:rows])  # warm-up
        torch.cuda.synchronize()
        for m, a in COUNTERS.values():
            setattr(m, a, 0)
        pred = model(gen(0), obs[:rows])
        torch.cuda.synchronize()
        launches = {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}
        torch.save(pred.cpu(), f"{args['root']}/{name}/served_{rows}.pt")
        times = []
        for i in range(args["calls"]):
            t0 = time.perf_counter()
            model(gen(1 + i), obs[:rows])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name][rows] = {"launches": launches, "times": times}
heavy = [m for m in ("models", "diffusion", "eval_pipeline")
         if f"skeletondiffusion_tpu_torch.{m}" in sys.modules]
assert not heavy, heavy
print(json.dumps(out))
"""


def live_calls(predictor, obs: torch.Tensor) -> tuple:
    """The live predictor's output for the serving phase's generator seed,
    and its seconds a call (TIMED_CALLS calls after a warm-up), as the served
    programs are timed."""
    gen = lambda i: torch.Generator(device="cuda").manual_seed(SEED + 50 + i)  # noqa: E731
    predictor(gen(1), obs)
    torch.cuda.synchronize()
    pred, _ = predictor(gen(0), obs)
    times = []
    for i in range(TIMED_CALLS):
        t0 = time.perf_counter()
        predictor(gen(1 + i), obs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return pred.cpu(), times


def hold_served(label: str, served: torch.Tensor, live: torch.Tensor, live_fp32) -> None:
    """The served prediction equals the live one bit for bit; otherwise it is
    printed why and held within the path's bounds: fp32 within E2E_TOL, bf16
    within hold_bf16's (mean below, max within BF16_E2E_MAX of the live bf16
    path's deviation from the live fp32 path on the same noise)."""
    if torch.equal(served, live):
        log(f"serving, {label}: the served prediction equals the live one bit for bit")
        return
    d = (served - live).abs()
    log(f"serving, {label}: the served prediction differs from the live one (max |Δ| "
        f"{d.max().item():.3e}, mean {d.mean().item():.3e}, input space): the program's "
        "glue between the kernels does not run as the live path's, so it is held within the "
        "path's bounds")
    if live_fp32 is None:
        if not d.max().item() <= E2E_TOL:
            raise AssertionError(f"serving, {label}: max |Δ| {d.max().item()} > {E2E_TOL}")
        return
    bf = (live - live_fp32).abs()
    if not (d.mean() < bf.mean() and d.max() <= BF16_E2E_MAX * bf.max()):
        raise AssertionError(f"serving, {label}: |Δ| max {d.max().item()} mean "
                             f"{d.mean().item()} against the bf16 path's own deviation "
                             f"(max {bf.max().item()}, mean {bf.mean().item()})")


def export_serving(root: str) -> None:
    """Export the flagship's bf16 predictor at SERVING_BUCKETS["bf16"] and
    its fp32 one at SERVING_BUCKETS["fp32"] (``build_model``: the weights
    of the main process's predictors) under ``root``; print one JSON line
    of each artifact's manifest and size.  Run in a process of its own
    (``start_serving``): the export traces on the host while the
    main process drives the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        _, predictor = build_model(torch.device("cuda"), dtype)
        art = os.path.join(root, name)
        export_predictor(predictor, art, SERVING_BUCKETS[name])
        with open(os.path.join(art, "manifest.json")) as f:
            manifest = json.load(f)
        out[name] = {"manifest": manifest, "dir": art,
                     "size": sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))}
    print(json.dumps(out))


def start_serving(root: str) -> subprocess.Popen:
    """The serving phase's two processes, chained, started after the build:
    ``export_serving(root)`` (its output to ``root/export.log``), then, in
    its place, the fresh process of ``SERVE``, which loads the artifacts and
    waits for the serving phase.  Both run on the host while the main
    process drives the card."""
    repo = str(build.PACKAGE_DIR.parent)
    args = {"root": root, "seed": SEED + 50, "calls": TIMED_CALLS,
            "names": list(SERVING_BUCKETS), "obs_shape": [BATCH, OBS_LEN, 21, 3]}
    script = ('"$PY" -c "import sys, chip_smoke; chip_smoke.export_serving(sys.argv[1])" '
              '"$ROOT" > "$ROOT/export.log" 2>&1 && exec "$PY" -c "$SERVE" "$ARGS"')
    # a session of their own: stop_serving ends the export's process too
    return subprocess.Popen(
        ["bash", "-c", script], cwd=repo, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=repo, PY=sys.executable, ROOT=root, SERVE=SERVE,
                 ARGS=json.dumps(args)))


def stop_serving(server: subprocess.Popen) -> None:
    """Kill what is left of ``start_serving``'s processes."""
    if server.poll() is None:
        os.killpg(server.pid, signal.SIGKILL)
        server.communicate()


def run_serving(predictor_bf16, predictor, card_name: str, root: str,
                server: subprocess.Popen) -> dict:
    """Let ``server`` (``start_serving``) run the served programs, hold each
    bucket's served prediction against the live predictor's for the same
    generator state, each kernel's launches a call against the live path's,
    and time both.  Returns the served programs' launches a call at the
    largest bucket: {"bf16": counts, "fp32": counts}."""
    skeleton = predictor.skeleton
    t0 = time.perf_counter()
    try:
        out, err = server.communicate("go\n", timeout=SERVING_TIMEOUT_S)
    finally:
        stop_serving(server)
    with open(os.path.join(root, "export.log")) as f:
        export_lines = f.read().strip().splitlines()
    if server.returncode != 0:
        raise AssertionError("serving: the export or the fresh process failed:\n"
                             + "\n".join(export_lines[-20:]) + "\n" + err[-4000:])
    artifacts = json.loads(export_lines[-1])
    served = json.loads(out.strip().splitlines()[-1])
    log(f"serving: the fresh process (no model class imported; its artifacts exported and "
        f"loaded beside the earlier phases) ran the programs in {time.perf_counter() - t0:.1f} s")
    for name, art in artifacts.items():
        m = art["manifest"]
        log(f"serving, {name}: exported {m['path']} at buckets {m['batch_sizes']} in "
            f"{ {b: round(v, 2) for b, v in m['export_seconds'].items()} } s; artifact "
            f"{art['size'] / 2**20:.1f} MiB; loaded in {served[name]['load_s']:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 49)
    obs = 0.3 * torch.randn((BATCH, OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                            device="cuda")
    launches = {}
    for name, pred, expected in (("bf16", predictor_bf16, EXPECTED_BF16),
                                 ("fp32", predictor, EXPECTED_FP32)):
        for rows in SERVING_BUCKETS[name]:
            got = served[name][str(rows)]
            want = {k: expected.get(k, 0) for k in got["launches"]}
            if got["launches"] != want:
                raise AssertionError(f"serving, {name} at {rows}: launches a call "
                                     f"{got['launches']}, the live path's {want}")
            live, live_times = live_calls(pred, obs[:rows])
            live_fp32 = live_calls(predictor, obs[:rows])[0] if name == "bf16" else None
            hold_served(f"{name} at {rows} rows", torch.load(
                os.path.join(artifacts[name]["dir"], f"served_{rows}.pt")), live, live_fp32)
            p50, live_p50 = statistics.median(got["times"]), statistics.median(live_times)
            log(f"serving, {name} at {rows} rows: served {rows / p50:.2f} preds/s, live "
                f"{rows / live_p50:.2f} preds/s (batch {rows} × {SAMPLES} samples, median of "
                f"{TIMED_CALLS} calls: served {[round(t, 4) for t in got['times']]} s, live "
                f"{[round(t, 4) for t in live_times]} s; served/live "
                f"{live_p50 / p50:.4f}) on {card_name}; launches a call "
                f"{ {k: v for k, v in got['launches'].items() if v} }, the live path's")
        launches[name] = served[name][str(SERVING_BUCKETS[name][-1])]["launches"]
    return launches


# ---- the parallel phase ----------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_LR = 1e-3  # the flagship config's
# a rank's gradient after the all-reduce against the mean of the same halves'
# gradients in one process: the same products on the same rows, then one fp32
# sum of two terms (gloo's) against the host's
PARALLEL_SPLIT_TOL = 1e-6


def parallel_eval_rank(mesh, data_root: str) -> tuple:
    """A rank of the parallel phase's eval: the bf16 flagship of
    ``build_model`` on its rows of the eval phase's split, through
    ``compute_metrics(..., mesh=mesh)``; (the metric table, its launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    skeleton, predictor = build_model(mesh.device, torch.bfloat16)
    dataset, apde_csv = build_eval_split(skeleton, data_root)
    reset_counts()
    results = compute_metrics(predictor, dataset, skeleton, batch_size=BATCH,
                              num_samples=SAMPLES, stats_mode="probabilistic", seed=SEED,
                              if_compute_cmd=True, if_compute_apde=True,
                              mmapd_gt_path=apde_csv, silent=True, mesh=mesh)
    torch.cuda.synchronize()
    return results, read_counts()


def parallel_ranks(mesh, data_root: str, spec: dict, step_args: tuple) -> tuple:
    """One rank of the parallel phase: the eval (``parallel_eval_rank``), the
    fp32 stage-2 step (``dryrun.stage2_step``) on the data axis, then the same
    step on a mesh of 1 data × PARALLEL_RANKS model ranks built over the same
    processes (``create_mesh(..., model_parallel=)``: new groups, the weights
    split at ``shard_params_model_axis``'s default ``min_size``)."""
    t0 = time.perf_counter()
    evaluated = parallel_eval_rank(mesh, data_root)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = dryrun.stage2_step(mesh, spec, *step_args)
    step_s = time.perf_counter() - t0
    model_mesh = create_mesh(PARALLEL_RANKS, model_parallel=PARALLEL_RANKS, device="cuda")
    return evaluated, eval_s, step, step_s, dryrun.stage2_step(model_mesh, spec, *step_args)


def vector_relative(a: dict, b: dict) -> float:
    """‖a − b‖ / ‖b‖ over every tensor of two dicts with the same keys."""
    diff = math.sqrt(sum(float(((a[k] - v) ** 2).sum()) for k, v in b.items()))
    return diff / max(math.sqrt(sum(float((v ** 2).sum()) for v in b.values())), 1e-30)


def flagship_spec() -> dict:
    """The flagship (fp32) as ``dryrun`` builds it, with the train phase's k
    and similarity space."""
    return {"seed": SEED, "latent": LATENT, "hidden": HIDDEN, "timesteps": TIMESTEPS,
            "arch": {**ARCH, "use_attention": True, "self_condition": False,
                     "norm_type": "none"},
            "skeleton": dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                             num_joints=22, pose_box_size=1.5, obs_length=OBS_LEN,
                             pred_length=PRED_LEN, if_consider_hip=False),
            "trainer": dict(lr=PARALLEL_LR, train_pick_best_sample_among_k=TRAIN_K,
                            similarity_space="input_space")}


def run_parallel(data_root: str, eval_results: dict, card_name: str) -> None:
    """Two ranks on the one card over gloo (``dryrun.run_ranks``): the bf16
    eval of the eval phase over a data axis of two, held against that
    phase's single-process table at EVAL_DEVICE_TOL·max(1, |v|), with its
    launches; and one fp32 stage-2 step of the flagship on TRAIN_BATCH × k
    TRAIN_K rows with injected t and noise, held against the same step in
    one process on the whole batch at the train phase's bounds (loss
    TRAIN_LOSS_TOL, gradient norm TRAIN_GNORM_TOL, relative), and its
    loss and gradient against the mean of the two halves' steps taken in
    this process (the rows a rank takes, one call each) within
    PARALLEL_SPLIT_TOL; then the same step on the model axis
    (``hold_model_axis``)."""
    spec = flagship_spec()
    gen = torch.Generator().manual_seed(SEED + 60)
    x = 0.3 * torch.randn((TRAIN_BATCH, OBS_LEN, 21, 3), generator=gen)
    y = 0.3 * torch.randn((TRAIN_BATCH, PRED_LEN, 21, 3), generator=gen)
    t = torch.randint(0, TIMESTEPS, (TRAIN_BATCH,), generator=gen)
    noise = torch.randn((TRAIN_BATCH * TRAIN_K, 21, LATENT), generator=gen)
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(parallel_ranks, PARALLEL_RANKS, data_root, spec, (x, y, t, noise),
                             device="cuda", timeout_s=600)
    log(f"parallel: {PARALLEL_RANKS} ranks on one card (gloo) ran in "
        f"{time.perf_counter() - t0:.1f} s: eval {[round(r[1], 1) for r in ranks]} s, stage-2 "
        f"step {[round(r[3], 1) for r in ranks]} s")
    batches = -(-EVAL_SEGMENTS // BATCH)
    for rank, ((results, counts), *_) in enumerate(ranks):
        check_counts(f"parallel eval, rank {rank}", counts,
                     {k: v * batches for k, v in EXPECTED_BF16.items()})
        hold_metrics(f"parallel eval, rank {rank} of {PARALLEL_RANKS} against the eval "
                     "phase's single process", results, eval_results,
                     lambda w: EVAL_DEVICE_TOL * max(1.0, abs(w)))
    one = dryrun.stage2_step(None, spec, x, y, t, noise, device="cuda")
    # the same rows a call as a rank, in this process: the mean of the halves'
    # gradients is what the all-reduce must give
    half = TRAIN_BATCH // PARALLEL_RANKS
    halves = [dryrun.stage2_step(None, spec, x[r * half:(r + 1) * half],
                                 y[r * half:(r + 1) * half], t[r * half:(r + 1) * half],
                                 noise[r * half * TRAIN_K:(r + 1) * half * TRAIN_K],
                                 device="cuda") for r in range(PARALLEL_RANKS)]
    split = {k: sum(h["grads"][k] for h in halves) / PARALLEL_RANKS for k in one["grads"]}
    split_loss = sum(h["loss"] for h in halves) / PARALLEL_RANKS
    for rank, (_, _, step, _, _) in enumerate(ranks):
        loss_err = relative(step["loss"], one["loss"])
        gnorm_err = relative(step["grad_norm"], one["grad_norm"])
        split_err = vector_relative(step["grads"], split)
        whole_err = vector_relative(step["grads"], one["grads"])
        worst = max((step["params"][k] - v).abs().max().item() for k, v in one["params"].items())
        log(f"parallel stage-2 step (fp32, batch {TRAIN_BATCH} × k {TRAIN_K}), rank {rank}: "
            f"against the mean of the two halves' steps in one process (the same rows a call): "
            f"loss relative {relative(step['loss'], split_loss):.3e}, gradient ‖Δ‖/‖g‖ "
            f"{split_err:.3e} (tol {PARALLEL_SPLIT_TOL:.0e}); against one process on the whole "
            f"batch: loss {step['loss']!r} vs {one['loss']!r} (relative {loss_err:.3e}, tol "
            f"{TRAIN_LOSS_TOL:.0e}), grad norm {step['grad_norm']!r} vs {one['grad_norm']!r} "
            f"(relative {gnorm_err:.3e}, tol {TRAIN_GNORM_TOL:.0e}), gradient ‖Δ‖/‖g‖ "
            f"{whole_err:.3e} and parameters after the step max |Δ| {worst:.3e} (not held: the "
            f"whole batch's products run other cuBLAS tilings, the gradient is a mean of "
            f"{TRAIN_BATCH * TRAIN_K} rows' terms that mostly cancel, and Adam's first step "
            f"g/(|g| + ε) is ±lr = {PARALLEL_LR} for any gradient above ε)")
        if not (loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
                and split_err <= PARALLEL_SPLIT_TOL
                and relative(step["loss"], split_loss) <= PARALLEL_SPLIT_TOL):
            raise AssertionError(f"parallel stage-2 step, rank {rank}: loss {loss_err}, grad "
                                 f"norm {gnorm_err}, gradient against the halves {split_err}")
    hold_model_axis([r[4] for r in ranks], one, [r[2] for r in ranks])


def hold_model_axis(ranks: list, one: dict, data_steps: list) -> None:
    """The parallel phase's fp32 stage-2 step of the flagship on a mesh of 1
    data × 2 model ranks on the one card (gloo; ``ranks``): the weights that
    ``shard_params_model_axis`` splits (its default ``min_size``: the banks
    and the dense layers) keep half their output features on each rank, and
    each rank runs the whole batch.  Held against the one-process step
    ``one`` at the train phase's bounds (loss TRAIN_LOSS_TOL, gradient norm
    TRAIN_GNORM_TOL, relative); the split shapes and the step's seconds
    printed beside the one-process step's and the data axis's
    (``data_steps``)."""
    split = ranks[0]["split"]
    log(f"parallel model axis: {PARALLEL_RANKS} ranks (1 data × {PARALLEL_RANKS} model) on one "
        f"card; {len(split)} weights split (whole → a rank's): "
        + ", ".join(f"{k} {w} → {l}" for k, (w, l) in split.items()))
    for rank, step in enumerate(ranks):
        loss_err = relative(step["loss"], one["loss"])
        gnorm_err = relative(step["grad_norm"], one["grad_norm"])
        worst = max((step["params"][k] - v).abs().max().item() for k, v in one["params"].items())
        log(f"parallel model-axis stage-2 step (fp32, batch {TRAIN_BATCH} × k {TRAIN_K}), rank "
            f"{rank} {step['mesh']}: loss {step['loss']!r} vs {one['loss']!r} (relative "
            f"{loss_err:.3e}, tol {TRAIN_LOSS_TOL:.0e}), grad norm {step['grad_norm']!r} vs "
            f"{one['grad_norm']!r} (relative {gnorm_err:.3e}, tol {TRAIN_GNORM_TOL:.0e}), "
            f"parameters after the step max |Δ| {worst:.3e} (not held, as on the data axis); "
            f"step {step['step_s']:.3f} s, the whole weights in one process "
            f"{one['step_s']:.3f} s, a data-axis rank {[round(d['step_s'], 3) for d in data_steps]} s")
        if not (len(split) > 0 and loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
                and step["split"] == split):
            raise AssertionError(f"parallel model-axis step, rank {rank}: loss {loss_err}, grad "
                                 f"norm {gnorm_err}, {len(split)} weights split")


def log_kernel_time(label: str, entries: list, launches: dict) -> None:
    """Kernel time per prediction of the entries launched on a path: ms a
    launch × the path's ``launches``."""
    entries = [k for k in entries if launches[k["name"]]]
    total = sum(k["ms"] * launches[k["name"]] for k in entries)
    log(f"{label}, kernel time per prediction (ms × launches): " + ", ".join(
        f"{k['name']} {k['ms'] * launches[k['name']]:.3f}" for k in entries) +
        f"; sum {total:.3f} ms")


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    card_name = card()
    device = torch.device("cuda")
    log(f"card: {card_name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")
    phase("device", t)

    t = time.perf_counter()
    # the small phase's K1 widths (the quickstart's 16 among them)
    widths = [(21, h) for h in SMALL_WIDTHS if h != build.DEFAULT_HIDDEN]
    seconds = build.build_all(NODE_COUNTS, widths)
    for nodes in NODE_COUNTS:
        for src in build.sources():
            build.library(src.stem, nodes)
            for line in build.ptxas_report(src.stem, nodes).splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  {src.stem} ({nodes} nodes): {line.strip()}")
    for nodes, hidden in widths:
        for src in build.HIDDEN_SOURCES:
            build.library(src, nodes, hidden)
            for line in build.ptxas_report(src, nodes, hidden).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src} ({nodes} nodes, hidden {hidden}): {line.strip()}")
    log(f"build: nvcc {seconds:.2f} s, every source at each of {NODE_COUNTS} nodes and "
        f"{', '.join(build.HIDDEN_SOURCES)} at hidden {sorted({h for _, h in widths})}, at once, "
        f"into {', '.join(str(build.build_dir(n)) for n in NODE_COUNTS)}")
    phase("build", t)
    # the serving phase's export and load run on the host beside the next phases
    serving_root = tempfile.mkdtemp()
    server = start_serving(serving_root)
    try:
        return run_phases(t_all, card_name, device, serving_root, server)
    finally:
        stop_serving(server)
        shutil.rmtree(serving_root, ignore_errors=True)


def run_phases(t_all: float, card_name: str, device: torch.device, serving_root: str,
               server: subprocess.Popen) -> int:
    """The phases after the build (``main``), the serving phase's processes
    (``start_serving``) running meanwhile."""
    t = time.perf_counter()
    skeleton, predictor = build_model(device)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_gru_rollout(predictor, gen), check_posterior_step(predictor, gen)]
    phase("kernels", t)

    t = time.perf_counter()
    obs = 0.3 * torch.randn((BATCH, OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                            device="cuda")
    launches = run_main_path(skeleton, predictor, obs, card_name, EXPECTED_FP32,
                             "main path fp32")
    compare_with_plain(skeleton, predictor, obs, gen)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase("main", t)

    t = time.perf_counter()
    _, predictor_bf16 = build_model(device, torch.bfloat16)
    hold_chain_route("amass flagship (21 nodes)", predictor_bf16)
    fused = check_denoiser_kernels(predictor_bf16, gen)
    phase("denoiser", t)

    t = time.perf_counter()
    expected_bf16 = EXPECTED_BF16
    launches = run_main_path(skeleton, predictor_bf16, obs, card_name, expected_bf16,
                             "main path bf16")
    compare_bf16(skeleton, predictor_bf16, predictor, obs, gen)
    for k in fused:
        k["launches"] = launches[k["name"]]
    log_kernel_time("bf16 path", fused, launches)
    kernels += fused
    phase("main_bf16", t)

    t = time.perf_counter()
    layer = check_layer_fused_kernels(predictor_bf16, gen)
    phase("layer_fused", t)

    t = time.perf_counter()
    with layer_fused_path():
        launches = run_main_path(skeleton, predictor_bf16, obs, card_name,
                                 EXPECTED_LAYER_FUSED, "main path bf16, layer-fused")
    compare_layer_fused(skeleton, predictor_bf16, predictor, obs, gen)
    for k in layer:
        k["launches"] = launches[k["name"]]
    log_kernel_time("layer-fused bf16 path", fused + layer, launches)
    kernels += layer
    phase("main_layer_fused", t)

    t = time.perf_counter()
    k1_ms = next(k["ms"] for k in kernels if k["name"] == "gru_rollout")
    rollout_bf16 = check_gru_rollout_bf16(predictor, gen, k1_ms)
    launches = run_decode_check(card_name)
    rollout_bf16["launches"] = launches["gru_rollout_bf16"]
    kernels.append(rollout_bf16)
    phase("decode_bf16", t)

    t = time.perf_counter()
    core_fm = check_attention_core_fm(gen)
    launches = run_attention_lab(card_name)
    core_fm["launches"] = launches["attention_core_fm"]
    kernels.append(core_fm)
    phase("attn_core_fm", t)

    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        data_root = build_synthetic_tree(root)
        log(f"synthetic AMASS tree written in {time.perf_counter() - t:.1f} s")
        launches, eval_preds_s, eval_results = run_eval(
            skeleton, predictor_bf16, predictor, card_name, expected_bf16, data_root)
        for k in kernels:
            k["eval_launches"] = launches[k["name"]]
        phase("eval", t)

        t = time.perf_counter()
        launches = run_train(skeleton, data_root, card_name, expected_bf16)
        for k in kernels:
            k["train_launches"] = launches[k["name"]]
        phase("train", t)

        t = time.perf_counter()
        ae_dir = run_cli(data_root, os.path.join(root, "cli"), card_name, expected_bf16,
                         eval_preds_s)
        phase("cli", t)

        t = time.perf_counter()
        launches = run_variants(skeleton, predictor, obs, gen, card_name, data_root,
                                os.path.join(root, "cli"), ae_dir, expected_bf16)
        for k in kernels:
            k["variant_launches"] = {v: c[k["name"]] for v, c in launches.items()}
        phase("variants", t)

        t = time.perf_counter()
        run_parallel(data_root, eval_results, card_name)
        phase("parallel", t)

    t = time.perf_counter()
    launches = run_serving(predictor_bf16, predictor, card_name, serving_root, server)
    for k in kernels:
        k["serving_launches"] = {name: c.get(k["name"], 0) for name, c in launches.items()}
    phase("serving", t)

    t = time.perf_counter()
    skeleton_kernels, launches = run_skeletons(device, card_name, predictor_bf16)
    for k in kernels:
        k["eval_3dpw_launches"] = launches[k["name"]]
    kernels += skeleton_kernels
    phase("skeletons", t)

    t = time.perf_counter()
    kernels += run_mano(device, card_name)
    phase("mano", t)

    t = time.perf_counter()
    launches = run_capstone(card_name)
    for k in kernels:
        k["capstone_launches"] = launches[k["name"]] if k.get("nodes", 21) == 21 else 0
    phase("capstone", t)

    t = time.perf_counter()
    launches = run_small(card_name)
    for k in kernels:  # the quickstart's models have 21 nodes
        k["small_launches"] = launches[k["name"]] if k.get("nodes", 21) == 21 else 0
    phase("small", t)

    t = time.perf_counter()
    kernels += run_widths(card_name)
    phase("widths", t)

    for k in kernels:  # the served programs are the 21-node flagship's
        k.setdefault("serving_launches", {"bf16": 0, "fp32": 0})
    log(json.dumps({"kernels": kernels}))
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    log(card())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
