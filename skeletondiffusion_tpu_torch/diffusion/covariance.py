"""Skeleton-correlation covariance construction: Σ_N = U Λ_N Uᵀ from the
(positive-definitized) adjacency/reachability matrix.

Host-side numpy float64 — the eigendecomposition happens once at model
construction, so the host is the right place (SURVEY.md §7.1); only the
resulting float32 tables reach the device.  Semantics mirror the reference
(`src/core/diffusion/utils.py:3-86`).  A copy of
``skeletondiffusion_tpu/diffusion/covariance.py`` without its diagnostics:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# eigenvalue magnitude below which a direction counts as null space; the
# reference pins this to float32 resolution (`utils.py:3-8`)
_NULL_EPS = 0.7e-7


def dim_null_space(matrix: np.ndarray) -> int:
    """Reference `utils.py:3-8`."""
    assert matrix.shape[-1] == matrix.shape[-2], "Matrix must be square"
    return int(np.sum(np.abs(np.linalg.eigh(matrix)[0]) < _NULL_EPS))


def is_positive_def(matrix: np.ndarray) -> bool:
    """Reference `utils.py:10-17`.  ``eigvalsh`` (the matrix is asserted
    symmetric): exact real spectrum — the reference's general ``eigvals``
    can emit spurious tiny imaginary parts on symmetric input, which its
    realness check would then reject for a perfectly valid matrix."""
    assert np.allclose(matrix, matrix.swapaxes(-1, -2)), "Matrix must be symmetric"
    return bool((np.linalg.eigvalsh(matrix) > 0).all())


def make_positive_definite(matrix: np.ndarray, epsilon: float = 1e-6, if_submin: bool = False) -> np.ndarray:
    """Add (spectral norm + ε)·I — or (−λ_min + ε)·I with ``if_submin`` — to
    the diagonal; reference `utils.py:19-35`."""
    eigenvalues = np.linalg.eigvalsh(matrix)
    if bool((eigenvalues > 0).all()):
        return matrix
    if not if_submin:
        shift = np.abs(eigenvalues).max() + epsilon
    else:
        shift = -eigenvalues.min() + epsilon
    pos_def = matrix + np.eye(matrix.shape[0]) * shift
    assert dim_null_space(pos_def) == 0
    return pos_def


def normalize_cov(
    Sigma_N: np.ndarray,
    Lambda_N: np.ndarray,
    U: np.ndarray,
    if_sigma_n_scale: bool = True,
    sigma_n_scale: str = "spectral",
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale Σ_N / Λ_N by the spectral (max eigenvalue) or Frobenius-style
    (mean eigenvalue) factor; reference `utils.py:37-62`."""
    N, _ = Sigma_N.shape
    assert Lambda_N.shape == (N,)
    assert U.shape == (N, N)

    if if_sigma_n_scale:
        if sigma_n_scale == "spectral":
            relative_scale_factor = Lambda_N.max()
        elif sigma_n_scale == "frob":
            relative_scale_factor = Lambda_N.sum() / N
        else:
            raise NotImplementedError(f"sigma_n_scale={sigma_n_scale}")
        Lambda_N = Lambda_N / relative_scale_factor
        Sigma_N = Sigma_N / relative_scale_factor
        recon = U @ np.diag(Lambda_N) @ U.T
        assert np.allclose(Sigma_N, recon, atol=1e-6), "Sigma_N must equal U Λ Uᵀ"
    assert (Lambda_N > _NULL_EPS).all(), f"Lambda_N must be positive definite: {Lambda_N}"
    assert is_positive_def(Sigma_N), "Sigma_N must be positive definite"
    return Sigma_N, Lambda_N


def verify_noise_scale(process, n_samples: int = 2000, seed: int = 0):
    """Diagnostic: empirical per-step noise energy √Λ_t·ε vs the isotropic
    (1−α_t)·N reference scale, numpy from ``seed``; port of the JAX
    package's (reference `src/core/diffusion/utils.py:89-95`).  ``process``
    is a ``NonisotropicProcess`` (its Λ_t [T, N] and β_t, tensors or
    arrays)."""
    rng = np.random.default_rng(seed)
    Lambda_t = np.asarray(_host(process.Lambda_t))  # [T,N]
    T, N = Lambda_t.shape
    noise = rng.standard_normal((n_samples, T, N))
    zeta = np.sqrt(Lambda_t)[None] * noise
    current = (zeta**2).sum(-1).mean(0)
    alphas = 1 - np.asarray(_host(process.betas))
    return current, (1 - alphas) * N


def _host(a):
    """A tensor's values as numpy (arrays as they are)."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else a


def get_cov_from_corr(
    correlation_matrix: np.ndarray,
    if_sigma_n_scale: bool = True,
    sigma_n_scale: str = "spectral",
    if_run_as_isotropic: bool = False,
    diffusion_covariance_type: str = "skeleton-diffusion",
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Σ_N, Λ_N, U) from a correlation (adjacency/reachability) matrix.

    Reference `src/core/diffusion/utils.py:65-86` — this is part of the
    public plug-and-play API (README.md:72-98).  The ``if_run_as_isotropic``
    branches reproduce the documented isotropic-equivalence ablation modes.
    """
    correlation_matrix = np.asarray(correlation_matrix, dtype=np.float64)
    N, _ = correlation_matrix.shape

    if if_run_as_isotropic:
        if diffusion_covariance_type == "skeleton-diffusion":
            return np.zeros_like(correlation_matrix), np.ones(N), np.eye(N)
        if diffusion_covariance_type == "anisotropic":
            return np.eye(N), np.ones(N), np.eye(N)
        return np.zeros_like(correlation_matrix), np.zeros(N), np.eye(N)

    Sigma_N = make_positive_definite(correlation_matrix)
    Lambda_N, U = np.linalg.eigh(Sigma_N, UPLO="L")
    Sigma_N, Lambda_N = normalize_cov(
        Sigma_N=Sigma_N, Lambda_N=Lambda_N, U=U,
        if_sigma_n_scale=if_sigma_n_scale, sigma_n_scale=sigma_n_scale, **kwargs,
    )
    return Sigma_N, Lambda_N, U
