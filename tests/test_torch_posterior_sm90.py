"""K2, the posterior step's tensor-core kernel (``csrc/posterior_step.cu``),
on the CPU: a PyTorch model of its 3×TF32 arithmetic against the plain
version and the JAX package's Pallas kernel in interpret mode, its launch
plans, and its wrapper's refusals.

The model: the contraction laid out as the kernel lays it out (each input's
first 8·⌊N/8⌋ rows in whole k-steps, x_t's, ε's, x̂₀'s, then the three
inputs' N mod 8 remaining rows packed together, K padded to 8, zero weights
past them); every operand v split into hi = tf32(v) and lo = tf32(v − hi),
TF32 rounding to nearest (ties away, as ``cvt.rna.tf32.f32``) by masking
the low 13 mantissa bits; a bf16 x̂₀ (exact in TF32) takes no lo part; the
products a_hi·b_lo + a_lo·b_hi and a_hi·b_hi summed apart (in float64: the
tensor cores' truncating sums are held on the card, chip_smoke at 1e-4),
then added.  It is held within 1e-5 of the plain version at every t of a
nonisotropic process's tables (t = 0's noise block zero) and of an
isotropic one's diagonal tables, at a ragged column count, with both x̂₀
dtypes, at 16, 17, 21 and 51 nodes; and of the Pallas kernel at one t of
each.  Single-pass TF32 misses the hold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.diffusion.covariance import get_cov_from_corr
from skeletondiffusion_tpu_torch.diffusion.process import (build_isotropic_process,
                                                           build_nonisotropic_process)
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as k2

NODES = [16, 17, 21, 51]
T = 10
TOL = 1e-5
BF16, FP32 = torch.bfloat16, torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero: add half of the dropped bits' range to the magnitude, mask them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def contraction_slots(n: int) -> list:
    """(input, row) of each of the kernel's K contraction slots (input 0
    x_t, 1 ε, 2 x̂₀), None where the weight is zero."""
    full, rem = n // 8, n % 8
    slots = [(i, r) for i in range(3) for r in range(8 * full)]
    slots += [(rho // rem, 8 * full + rho % rem) for rho in range(3 * rem)]
    return slots + [None] * (-len(slots) % 8)


def tf32x3_model(x0, xt, noise, m_t, passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic (module docstring); ``passes=1`` is
    single-pass TF32 (hi·hi alone)."""
    n = xt.shape[0]
    cols = xt[0].numel()
    inputs = [xt.reshape(n, cols), noise.reshape(n, cols),
              torch.clamp(x0.float(), -1.0, 1.0).reshape(n, cols)]
    slots = contraction_slots(n)
    x = torch.stack([inputs[s[0]][s[1]] if s else torch.zeros(cols) for s in slots])
    m = torch.stack([m_t[:, (0 if s[0] == 2 else (s[0] + 1) * n) + s[1]] if s
                     else torch.zeros(n) for s in slots], dim=1)
    xh, mh = tf32(x), tf32(m)
    xl, ml = tf32(x - xh), tf32(m - mh)
    if x0.dtype == BF16:  # no lo part of the bf16 x̂₀'s whole k-steps
        xl[2 * 8 * (n // 8):3 * 8 * (n // 8)] = 0.0
    big = mh.double() @ xh.double()
    if passes == 1:
        return big.float().reshape(xt.shape)
    small = mh.double() @ xl.double() + ml.double() @ xh.double()
    return (big + small).float().reshape(xt.shape)


def _tables(n: int, case: str) -> torch.Tensor:
    if case == "diagonal":
        return build_isotropic_process(n, T, device="cpu").posterior_step_tables()
    chain = np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)  # a skeleton-like adjacency
    sigma, lam, u = get_cov_from_corr(chain)
    return build_nonisotropic_process(sigma, lam, u, timesteps=T,
                                      device="cpu").posterior_step_tables()


def _inputs(n: int, dtype, d: int, seed: int, b: int = 3):
    rng = np.random.default_rng(seed)
    x0, xt, eps = (rng.standard_normal((n, b, d), dtype=np.float32) for _ in range(3))
    return torch.from_numpy(1.5 * x0).to(dtype), torch.from_numpy(xt), torch.from_numpy(eps)


def _pallas(x0, xt, eps, m_t) -> torch.Tensor:
    """The Pallas kernel in interpret mode, D zero-padded to its 128 lanes."""
    d = xt.shape[-1]
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, 128 - d)))  # noqa: E731
    jx0 = pad(x0.float().numpy()).astype(jnp.bfloat16 if x0.dtype == BF16 else jnp.float32)
    out = posterior_step_pallas(jx0, pad(xt.numpy()), pad(eps.numpy()), jnp.asarray(m_t.numpy()),
                                batch_tile=8, interpret=True)
    return torch.from_numpy(np.array(out)[..., :d])


# (the case's D: 24 columns a row make B·D = 72, a last 32-column tile of 8;
# its t against Pallas)
CASES = {"tables": (32, T // 2), "diagonal": (32, 0), "ragged": (24, T - 1)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [FP32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", NODES)
def test_tf32x3_model_holds_plain_and_pallas(n, dtype, case):
    d, t_pallas = CASES[case]
    tables = _tables(n, case)
    if case == "diagonal":  # [c1·I | c2·I | σ·I]
        off = tables.reshape(T, n, 3, n) * (1 - torch.eye(n))[None, :, None, :]
        assert off.abs().max().item() == 0.0
    assert torch.all(tables[0, :, 2 * n:] == 0)  # t = 0: no noise
    x0, xt, eps = _inputs(n, dtype, d, seed=n)
    assert (xt.shape[1] * d) % 32 != 0 or case != "ragged"
    for t in range(T):
        got = tf32x3_model(x0, xt, eps, tables[t])
        want = k2.posterior_step_plain(x0, xt, eps, tables[t])
        assert (got - want).abs().max().item() <= TOL, (t, (got - want).abs().max().item())
    got = tf32x3_model(x0, xt, eps, tables[t_pallas])
    want = _pallas(x0, xt, eps, tables[t_pallas])
    assert (got - want).abs().max().item() <= TOL


def test_single_pass_tf32_misses_the_hold():
    """hi·hi alone keeps ~3 digits: far outside chip_smoke's 1e-4."""
    n = 51
    x0, xt, eps = _inputs(n, FP32, 32, seed=5)
    m_t = _tables(n, "tables")[T // 2]
    want = k2.posterior_step_plain(x0, xt, eps, m_t)
    assert (tf32x3_model(x0, xt, eps, m_t, passes=1) - want).abs().max().item() > 1e-4
    assert (tf32x3_model(x0, xt, eps, m_t) - want).abs().max().item() <= TOL


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp),
                      1.0 + 0.51 * one_ulp, 3.0], dtype=FP32)
    assert tf32(x).tolist() == [1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + one_ulp, 3.0]
    assert torch.equal(tf32(x.to(BF16).float()), x.to(BF16).float())  # bf16 is TF32


# (cols, warps, stages, k, shared-memory bytes) of each node count's plans
PINNED = {
    (16, FP32): (32, 4, 2, 48, 56384), (16, BF16): (32, 4, 2, 48, 48192),
    (17, FP32): (32, 4, 2, 56, 85568), (17, BF16): (32, 4, 2, 56, 77376),
    (21, FP32): (32, 4, 2, 64, 87104), (21, BF16): (32, 4, 2, 64, 78912),
    (51, FP32): (32, 7, 1, 160, 223288), (51, BF16): (32, 8, 1, 160, 220224),
}


@pytest.mark.parametrize("dtype", [FP32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", NODES)
def test_plans_are_pinned_and_fit(n, dtype):
    plan = k2.posterior_plan(n, dtype)
    assert tuple(plan) == PINNED[(n, dtype)]
    assert plan.smem <= k2.MAX_SMEM and plan.warps <= k2.MAX_WARPS
    assert plan.k == len(contraction_slots(n))
    n_pad = -(-n // 8) * 8
    stage = 2 * n_pad * 128 + n_pad * 32 * (2 if dtype == BF16 else 4)
    assert plan.smem == (1024 + plan.warps * plan.stages * (-(-stage // 1024) * 1024)
                         + plan.k // 8 * (n_pad // 8) * 32 * 16 + 8 * plan.warps * plan.stages)
    if n > 32:  # one stage a warp, as many warps as fit
        assert k2.plan_smem(n, dtype, plan.warps + 1, 1) > k2.MAX_SMEM


def _as_cuda_request(monkeypatch, calls: list):
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "stream_of", lambda t: 0)

    def entry(name, symbol, n_pointers, n_ints, nodes=21):
        def call(*args):
            calls.append((symbol, args[n_pointers:-1]))
            return 0
        return call
    monkeypatch.setattr(build, "c_entry", entry)


@pytest.mark.parametrize("dtype", [FP32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", NODES)
def test_wrapper_hands_the_kernel_its_plan(monkeypatch, n, dtype):
    calls = []
    _as_cuda_request(monkeypatch, calls)
    x0, xt, eps = _inputs(n, dtype, 96, seed=1, b=4)
    k2.posterior_step(x0, xt, eps, torch.zeros(n, 3 * n))
    plan = k2.posterior_plan(n, dtype)
    symbol = "posterior_step_x0_bf16" if dtype == BF16 else "posterior_step_f32"
    assert calls == [(symbol, (n, 4 * 96, plan.warps, plan.stages, plan.smem))]


def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch):
    """Misaligned tensors, column counts a tensor map cannot address and
    node counts no library is built for raise before a launch; nothing
    falls back to the plain version."""
    calls = []
    _as_cuda_request(monkeypatch, calls)
    n, m_t = 21, torch.zeros(21, 63)
    counts = (k2.launches, k2.launches_x0_bf16, k2.launches_cuda_core)
    x0, xt, eps = _inputs(n, FP32, 8, seed=2, b=4)
    shifted = torch.zeros(x0.numel() + 1)[1:].view(x0.shape)  # 4 bytes past a 16-byte boundary
    for fn in (k2.posterior_step, k2.posterior_step_cuda_core):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(shifted, xt, eps, m_t)
        with pytest.raises(ValueError, match="multiple of 8"):  # B·D = 12, bf16
            fn(*_inputs(n, BF16, 4, seed=3)[:1], *_inputs(n, FP32, 4, seed=3)[1:], m_t)
        with pytest.raises(ValueError, match="multiple of 4"):  # B·D = 6, fp32
            fn(*_inputs(n, FP32, 2, seed=3), m_t)
        with pytest.raises(ValueError, match="takes 2 to 51 nodes"):
            fn(*_inputs(52, FP32, 8, seed=3), torch.zeros(52, 156))
    assert calls == [] and (k2.launches, k2.launches_x0_bf16, k2.launches_cuda_core) == counts


def test_cuda_core_design_needs_cuda_tensors():
    x0, xt, eps = _inputs(16, FP32, 8, seed=4)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        k2.posterior_step_cuda_core(x0, xt, eps, torch.zeros(16, 48))
