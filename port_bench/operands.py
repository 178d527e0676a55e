"""Seeded operands on the run's device, and the seeds they are drawn from.

``cnormal``, ``haar``, ``cond_operand``, ``eig_operand`` and
``hermitian_operand`` are frozen copies of ``make_system``, ``eig_operand``
and ``hermitian_operand`` in ``maus_tpu_torch/benchmarks/common.py``.
``rephase`` is the benchmark's own: it turns one operand of the pool into a
fresh one with the same singular values.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A non-negative 63-bit seed drawn from the run's ``seed`` and ``keys``
    (any whole numbers; large and negative ones included)."""
    words = [int(seed) % 2**64] + [int(k) % 2**64 for k in keys]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def cnormal(gen, shape, dtype, device):
    """Standard complex normal entries (unit variance per plane)."""
    rdt = dtype.to_real()
    return torch.complex(torch.randn(*shape, generator=gen, dtype=rdt, device=device),
                         torch.randn(*shape, generator=gen, dtype=rdt, device=device))


def haar(gen, n: int, dtype, device) -> torch.Tensor:
    """A Haar-distributed unitary: the QR of a complex Gaussian with the
    phases of R's diagonal moved into Q."""
    q, r = torch.linalg.qr(cnormal(gen, (n, n), dtype, device))
    d = torch.diagonal(r)
    return q * (d / d.abs())[None, :]


def cond_operand(n: int, cond: float, seed: int, device) -> torch.Tensor:
    """A = Q₁·diag(logspace(0, −log10 κ))·Q₂ᴴ with Haar Q₁, Q₂, complex64:
    LAPACK's xLATMS MODE=3 with COND = κ (LAWN 41)."""
    g = generator(seed, device)
    q1 = haar(g, n, torch.complex64, device)
    q2 = haar(g, n, torch.complex64, device)
    s = torch.logspace(0.0, -math.log10(cond), n,
                       dtype=torch.float32, device=device).to(torch.complex64)
    A = (q1 * s[None, :]) @ q2.mH
    return A.contiguous()


def rephase(A: torch.Tensor, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(D₁·A·D₂, b) with fresh unit-modulus diagonals D₁, D₂ and a fresh
    complex normal b, all drawn from ``seed``: a new system whose singular
    values, and so κ, are A's own."""
    n = A.shape[0]
    g = generator(seed, A.device)
    two_pi = 2 * math.pi
    t1 = torch.rand(n, generator=g, dtype=torch.float32, device=A.device) * two_pi
    t2 = torch.rand(n, generator=g, dtype=torch.float32, device=A.device) * two_pi
    d1 = torch.polar(torch.ones_like(t1), t1)
    d2 = torch.polar(torch.ones_like(t2), t2)
    b = cnormal(g, (n,), A.dtype, A.device)
    return (d1[:, None] * A * d2[None, :]).contiguous(), b


def eig_operand(n: int, seed: int, device) -> torch.Tensor:
    """A = (G₁ + iG₂)/√N with G₁, G₂ standard normal, complex64 (Ginibre)."""
    g = generator(seed, device)
    re = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    im = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    return (torch.complex(re, im) / math.sqrt(n)).contiguous()


def hermitian_operand(n: int, seed: int, device) -> torch.Tensor:
    """A = (G + Gᴴ)/2 with G = :func:`eig_operand`, complex64 (GUE)."""
    G = eig_operand(n, seed, device)
    return ((G + G.mH) / 2).contiguous()


def fingerprint(A: torch.Tensor, b) -> torch.Tensor:
    """A few entries of the operand (and of b), copied to the host: the
    check that the operand rebuilt after the window is the one served."""
    step = max(1, A.shape[0] // 4)
    parts = [A[::step, ::step].reshape(-1)]
    if b is not None:
        parts.append(b[::step].to(A.dtype))
    return torch.cat(parts).cpu()
