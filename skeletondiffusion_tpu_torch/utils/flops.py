"""Analytical useful-FLOP accounting for the prediction pipeline.

A copy of ``skeletondiffusion_tpu/utils/flops.py``: the counts are the
model's, not the device's.  "Useful" = the mathematically required
multiply-adds of the model as DEFINED (2 FLOPs per MAC), independent of how
a kernel pads or tiles — the numerator of MFU.  Formulas follow the module
definitions (``models/denoiser.py``, ``models/autoencoder.py``,
``ops/graph_gru.py``, ``diffusion/process.py``); anything sub-percent
(biases, activations, softmax normalizers, the batch-independent time MLP
at sampling time) is deliberately excluded and noted.  ``mfu`` divides by
one H100's dense bf16 tensor-core peak.
"""
from __future__ import annotations

from typing import Dict

# one NVIDIA H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, at
# its 700 W power limit)
H100_BF16_PEAK_FLOPS = 989e12


def graph_linear_flops(n: int, fin: int, fout: int, learn_influence: bool = True) -> float:
    """StaticGraphLinear per batch item: per-node weight product
    [fin]·[fin,fout] over N nodes + the G influence mix [N,N]·[N,fout]."""
    f = 2.0 * n * fin * fout
    if learn_influence:
        f += 2.0 * n * n * fout
    return f


def gru_step_flops(n: int, fin: int, hidden: int) -> float:
    """StaticGraphGRU cell per item per step: x·W_ih [fin,3H] + h·W_hh
    [H,3H] over N nodes, plus TWO G mixes of the [N,3H] gate products
    (`ops/graph_gru.py:85-91`)."""
    h3 = 3 * hidden
    return 2.0 * n * (fin + hidden) * h3 + 2.0 * (2.0 * n * n * h3)


def encoder_flops(n: int, obs_len: int, hidden: int = 96, latent: int = 96,
                  fin: int = 3) -> float:
    """Past-embedding per OBSERVATION: initial-hidden graph linear + GRU over
    obs_len steps + latent head (`models/autoencoder.py::Encoder`)."""
    return (
        graph_linear_flops(n, fin, hidden)
        + obs_len * gru_step_flops(n, fin, hidden)
        + graph_linear_flops(n, hidden, latent)
    )


def decoder_flops(n: int, pred_len: int, hidden: int = 96, latent: int = 96,
                  feat: int = 3) -> float:
    """Decode rollout per SAMPLE: hidden init from [x_{T-2}‖z] + pred_len GRU
    steps with constant input [x_{T-1}‖z] + per-step pose head
    (`models/autoencoder.py::Decoder`)."""
    fin = feat + latent
    return (
        graph_linear_flops(n, fin, hidden)
        + pred_len * (gru_step_flops(n, fin, hidden) + graph_linear_flops(n, hidden, feat))
    )


def denoiser_forward_flops(n: int, dim: int = 96, cond: int = 96, depth: int = 4,
                           heads: int = 8, dim_head: int = 32) -> float:
    """One Denoiser forward per SAMPLE (flagship arch,
    `models/denoiser.py`): stem + 2·depth ResnetBlocks + (2·depth−1)
    attention layers + long-skip final block + head.  Excluded: the time MLP
    (batch-independent under the sampler's scalar t) and softmax/RMSNorm
    elementwise (<0.5%)."""
    f = dim + cond
    hid = heads * dim_head
    stem = graph_linear_flops(n, f, f)
    res = graph_linear_flops(n, f, f) * 2  # block1 + block2 (identity residual)
    attn = (
        graph_linear_flops(n, f, 3 * hid)          # qkv
        + 4.0 * heads * n * n * dim_head           # sim (2·N²·dh/head) + AV
        + graph_linear_flops(n, hid, f)            # out
    )
    final = (
        graph_linear_flops(n, 2 * f, f) * 1        # block1 (2F→F)
        + graph_linear_flops(n, f, f)              # block2
        + graph_linear_flops(n, 2 * f, f)          # res_linear
    )
    head = graph_linear_flops(n, f, dim)
    n_pairs = 2 * depth
    return stem + n_pairs * res + (n_pairs - 1) * attn + final + head


def sampler_flops(n: int, timesteps: int = 10, latent: int = 96, **denoiser_kw) -> float:
    """Ancestral sampling per SAMPLE: T denoiser forwards + the dense [N,N]
    posterior products per step (coef1·x̂₀, coef2·x_t, U·σε —
    `diffusion/process.py::q_posterior/combine_mean_var_noise`)."""
    per_step = denoiser_forward_flops(n, **denoiser_kw) + 3.0 * (2.0 * n * n * latent)
    return timesteps * per_step


def prediction_flops(n: int, obs_len: int = 30, pred_len: int = 120,
                     num_samples: int = 50, timesteps: int = 10,
                     latent: int = 96, hidden: int = 96,
                     depth: int = 4, heads: int = 8, dim_head: int = 32) -> Dict[str, float]:
    """Useful FLOPs for ONE prediction = one observation embedded once +
    ``num_samples`` sampled/decoded futures (the bench unit).  Returns
    per-phase and total FLOPs."""
    embed = encoder_flops(n, obs_len, hidden=hidden, latent=latent)
    sample = num_samples * sampler_flops(
        n, timesteps=timesteps, latent=latent,
        dim=latent, cond=latent, depth=depth, heads=heads, dim_head=dim_head,
    )
    decode = num_samples * decoder_flops(n, pred_len, hidden=hidden, latent=latent)
    # metric transform: hip re-centering + per-segment rescale, ~12 flops per
    # output element
    metric = num_samples * 12.0 * pred_len * n * 3
    return {
        "embed": embed,
        "sample": sample,
        "decode": decode,
        "metric": metric,
        "total": embed + sample + decode + metric,
    }


def train_step_flops_stage2(n: int, batch: int, k: int = 50, *,
                            obs_len: int = 30, pred_len: int = 120,
                            latent: int = 96, hidden: int = 96,
                            depth: int = 4, heads: int = 8,
                            dim_head: int = 32) -> Dict[str, float]:
    """Useful FLOPs of ONE stage-2 (diffusion) train step
    (`train/trainer_diffusion.py::train_step`): frozen-AE embeddings
    (forward only — stop_gradient), the k-fan-out denoiser forward+backward
    (backward of a matmul is two matmuls → 3× forward), the forward-only
    k-sample decode for the motion argmin (stop_gradient prunes its
    backward), and the q_sample/Mahalanobis [N,N] mixes.  Optimizer/EMA
    elementwise updates (~20 flops/param) are excluded (<0.1%)."""
    embed = batch * (
        encoder_flops(n, obs_len, hidden=hidden, latent=latent)
        + encoder_flops(n, pred_len, hidden=hidden, latent=latent)
    )
    denoiser = 3.0 * batch * k * denoiser_forward_flops(
        n, dim=latent, cond=latent, depth=depth, heads=heads, dim_head=dim_head
    )
    # q_sample correlated-noise mix, x̂₀ recombination, loss whitening: ~5
    # dense [N,N]·[N,latent] products per (item,sample) incl. their backward
    mixes = batch * k * 5.0 * (2.0 * n * n * latent)
    decode = batch * k * decoder_flops(n, pred_len, hidden=hidden, latent=latent)
    similarity = batch * k * 4.0 * pred_len * n * 3
    total = embed + denoiser + mixes + decode + similarity
    return {"embed": embed, "denoiser": denoiser, "mixes": mixes,
            "decode": decode, "similarity": similarity, "total": total}


def train_step_flops_stage1(n: int, batch: int, *, obs_len: int = 30,
                            pred_len: int = 120, hidden: int = 96,
                            latent: int = 96) -> Dict[str, float]:
    """Useful FLOPs of ONE stage-1 (autoencoder) train step: full
    autoencode (past embedding + future encode + rollout decode)
    forward+backward (3× forward)."""
    fwd = batch * (
        encoder_flops(n, obs_len, hidden=hidden, latent=latent)
        + encoder_flops(n, pred_len, hidden=hidden, latent=latent)
        + decoder_flops(n, pred_len, hidden=hidden, latent=latent)
    )
    return {"forward": fwd, "total": 3.0 * fwd}


def mfu(flops_per_s: float, peak: float = H100_BF16_PEAK_FLOPS) -> float:
    """Achieved over peak FLOP/s (default: one H100's dense bf16)."""
    return flops_per_s / peak
