"""Tall operands of known singular values: A = U·diag(σ)·Vᴴ with U (m×n)
and V (n×n) Haar, σ_k = ratio^k for k < top, then a logspace tail (LAPACK's
xLATMS with MODE 0, given singular values; LAWN 41). A frozen copy of
``svd_operand`` in ``maus_tpu_torch/benchmarks/common.py``, the JAX
package's SVD probe operand, with the spectrum read from the configuration.

Set-up builds the configuration's ``pool`` operands in complex128 and keeps
them in complex64 (two Haar QRs each, too dear for every request); request
``i`` takes pool entry ``i mod pool`` rephased with fresh unit-modulus
diagonals, D₁·A·D₂, which keeps every singular value. An SVD takes no b.
"""
from __future__ import annotations

import math

import torch

from port_bench import operands

C128 = torch.complex128


def spectrum(config: dict, device="cpu") -> torch.Tensor:
    """The n singular values of the configuration, float64, largest first."""
    n, top = int(config["n"]), int(config["sigma_top"])
    lo, hi = (float(x) for x in config["sigma_tail_log10"])
    ratio = float(config["sigma_ratio"])
    return torch.cat([ratio ** torch.arange(top, dtype=torch.float64, device=device),
                      torch.logspace(lo, hi, n - top, dtype=torch.float64, device=device)])


def factors(config: dict, seed: int, device):
    """(U, σ, V) of one operand drawn from ``seed``: U (m×n) and V (n×n)
    Haar in complex128, σ the configuration's spectrum."""
    m, n = int(config["m"]), int(config["n"])
    g = operands.generator(seed, device)

    def haar(rows: int, cols: int) -> torch.Tensor:
        q, r = torch.linalg.qr(operands.cnormal(g, (rows, cols), C128, device))
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    U = haar(m, n)
    V = haar(n, n)
    return U, spectrum(config, device), V


def setup(config, traffic, seed, device):
    pool = []
    for p in range(int(config["pool"])):
        U, sig, V = factors(config, operands.sub_seed(seed, 1, p), device)
        pool.append(((U * sig[None, :]) @ V.mH).to(torch.complex64).contiguous())
        del U, V
    return pool


def rephase(A: torch.Tensor, seed: int) -> torch.Tensor:
    """D₁·A·D₂ with fresh unit-modulus diagonals of A's row and column
    counts, drawn from ``seed``: an operand with A's singular values."""
    m, n = A.shape
    g = operands.generator(seed, A.device)
    t1 = torch.rand(m, generator=g, dtype=torch.float32, device=A.device) * (2 * math.pi)
    t2 = torch.rand(n, generator=g, dtype=torch.float32, device=A.device) * (2 * math.pi)
    d1 = torch.polar(torch.ones_like(t1), t1)
    d2 = torch.polar(torch.ones_like(t2), t2)
    return (d1[:, None] * A * d2[None, :]).contiguous()


def operand(config, traffic, pool, seed, i, device):
    top = spectrum(config)[:int(config["sigma_top"])]
    return rephase(pool[i % len(pool)], seed), None, {"sigma_top": top}
