"""Problem fixture generators — the reference's test-matrix families (M6,
AMS:611-639) re-implemented (NOT copied) with seeded PRNGs, plus the extra
benchmark families the north star requires (well-conditioned and ill-conditioned
N-scalable systems; BASELINE.md rows 7-9).

All generators return host numpy arrays in complex128 (diagnosis precision); the
solver casts to its device dtype.
"""
from __future__ import annotations

import numpy as np


def hilbert(n: int) -> np.ndarray:
    i = np.arange(n)
    return 1.0 / (1.0 + i[:, None] + i[None, :])


def dynamic_solve_system(n: int, t_step: int, time_max_iter: int = 100,
                         seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Time-varying ill-conditioned Ax=b (reference AMS:611-617): Hilbert base +
    0.1·N diagonal boost + oscillating antisymmetric corner coupling + 1e-4 noise;
    b modulated in time."""
    rng = np.random.default_rng(seed)
    t_norm = t_step / time_max_iter
    A = hilbert(n).astype(np.complex128) + np.diag(np.full(n, n * 0.1))
    inductor = np.zeros((n, n), np.complex128)
    inductor[0, n - 1] = 1.0
    inductor[n - 1, 0] = -1.0
    A = A + np.sin(t_step * 2 * np.pi / 20) * (10.0 + t_norm * 20.0) * inductor
    A = A + np.cos(t_step * 2 * np.pi / 15) * \
        (rng.random((n, n)) + 1j * rng.random((n, n))) * 1e-4
    base = np.array([1, -1, 0.5, -0.5, 0.1] * (n // 5 + 1))[:n].astype(np.complex128)
    b = base * (1 + 0.1 * np.sin(t_step * np.pi / 10))
    return A, b


def laplace_like_complex(n: int, make_hermitian: bool = False,
                         seed: int = 0) -> np.ndarray:
    """Complex Laplace-like eigen fixture (reference AMS:619-628): tridiagonal −2/1
    stencil with off-band complex couplings, corner wrap terms, near-degenerate last
    diagonal pair, and 1e-3 noise; optionally Hermitized via (A + Aᴴ)/2."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), np.complex128)
    np.fill_diagonal(A, -2.0)
    idx = np.arange(n - 1)
    A[idx, idx + 1] = 1.0
    A[idx + 1, idx] = 1.0
    A[0, 2] = 0.5
    A[2, 0] = 0.5j
    A[n - 1, n - 3] = 0.8j
    A[n - 3, n - 1] = 0.8
    A[n // 2 - 1, n // 2] = 1.5 + 0.5j
    A[n // 2, n // 2 - 1] = -1.5 + 0.5j
    A += (rng.random((n, n)) * 2 - 1) * 1e-3 + 1j * (rng.random((n, n)) * 2 - 1) * 1e-3
    A[0, n - 1] += 0.2
    A[n - 1, 0] += 0.2j
    A[n - 1, n - 1] = A[n - 2, n - 2] + 1e-6
    if make_hermitian:
        A = (A + A.conj().T) / 2.0
    return A


def low_rank_svd_matrix(m: int, n: int, target_rank: int = 2,
                        seed: int = 0, noise: float = 1e-4) -> np.ndarray:
    """Noisy near-low-rank rectangular fixture (reference AMS:630-639):
    σ_i = 5/(i+1) for the target rank, ~1e-7 tail, plus dense noise."""
    rng = np.random.default_rng(seed)
    QU, _ = np.linalg.qr(rng.random((m, m)) + 1j * rng.random((m, m)))
    QV, _ = np.linalg.qr(rng.random((n, n)) + 1j * rng.random((n, n)))
    k = min(m, n)
    s = np.zeros(k)
    s[:target_rank] = [5.0 / (i + 1) for i in range(target_rank)]
    s[target_rank:] = 1e-7 * rng.random(k - target_rank)
    S = np.zeros((m, n), np.complex128)
    np.fill_diagonal(S, s)
    A = QU @ S @ QV.conj().T
    return A + (rng.standard_normal((m, n)) +
                1j * rng.standard_normal((m, n))) * noise


def well_conditioned_system(n: int, seed: int = 0,
                            complex_: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Diagonally-dominant random Ax=b (BASELINE.md row 7 family)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.complex128)
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    A += n * np.eye(n)
    b = rng.standard_normal(n) + (1j * rng.standard_normal(n) if complex_ else 0.0)
    return A, b.astype(np.complex128)


def ill_conditioned_system(n: int, cond: float = 1e6, seed: int = 0
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Controlled-κ dense system: Q₁ diag(logspace σ) Q₂ᴴ with geometric singular
    values spanning ``cond`` (the 4096² north-star family, BASELINE.md)."""
    rng = np.random.default_rng(seed)
    Q1, _ = np.linalg.qr(rng.standard_normal((n, n)) +
                         1j * rng.standard_normal((n, n)))
    Q2, _ = np.linalg.qr(rng.standard_normal((n, n)) +
                         1j * rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    A = (Q1 * s) @ Q2.conj().T
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b.astype(np.complex128)


def hermitian_matrix(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (A + A.conj().T) / 2.0
