"""Mixed-precision iterative refinement.

Counterpart of ``maus_tpu/ops/refine.py``. The factorization and the
correction solves run in the working dtype (complex64 on the card); iterates
and residuals are held in ``torch.complex128``, and every certification is a
true-FP64 residual ``b − A·x`` computed by kernel K1
(:func:`maus_tpu_torch.ops.kernels.residual.true_residual`).

The JAX package's four-way ladder for that residual (the fused Pallas kernel,
the resident and streamed bf16 slice ladders, the emulated-f64 3M GEMVs) and
its ``SplitComplex`` / ``FacPlanes`` representations exist because the TPU has
no FP64 and no complex128; none of them is needed here.
"""
from __future__ import annotations

import math

import torch

from ..utils.metrics import span
from .batched_solve import solve_any
from .gmres import gmres_batched
from .kernels.residual import true_residual

C128 = torch.complex128


def _norm(z: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(z))


def _min_nan(new: float, old: float) -> float:
    """``jnp.minimum`` semantics: a NaN on either side propagates."""
    return new if (math.isnan(new) or new < old) else old


def refine_split(A: torch.Tensor, fac, b: torch.Tensor, x0: torch.Tensor,
                 steps: int = 3, tol: float = 0.0
                 ) -> tuple[torch.Tensor, float]:
    """Refine ``x0`` toward the solution of the TRUE system ``A x = b``.

    ``A`` is the operand the result is certified against, in its own dtype:
    the complex64 working array itself when that is exact (the bench operand,
    every float32/complex64 user input), or the user's complex128 operand.
    K1 reads it as given, so no widened copy of A is ever made. This call
    with the complex64 operand is the counterpart of the JAX package's
    ``refine_split_c64exact`` (the hi-only ``split_triple_c64`` case); with
    the complex128 operand it is ``refine_split`` over ``split_triple``.
    ``fac`` is the working-dtype factorization (the preconditioner), ``b``
    the right-hand side (widened to complex128).

    Returns ``(x, rel)``: the complex128 iterate and its certified relative
    residual ‖b − A x‖/‖b‖ (a Python float). Early-exits once ``rel`` reaches
    ``tol`` or stops improving.
    """
    A = A.contiguous()
    b64 = b.to(C128).contiguous()
    Ac = A if A.dtype == x0.dtype else A.to(x0.dtype)
    bnorm = max(_norm(b64), 1e-30)
    # Certified-incremental refinement: the inner loop carries the residual
    # incrementally in the working dtype (r ← r − A·d, one working-dtype
    # matrix-vector product per step, with relative drift ≈ ε·κ per step);
    # every INNER steps, or on apparent convergence or stall, the outer loop
    # certifies with a true FP64 residual and keeps the best certified
    # iterate. The returned rel is always a true FP64 measurement.
    INNER = 8

    def inner(x64, r64, rel):
        prev, it = math.inf, 0
        # push past the certify target by 4×: the carried estimate drifts
        while it < INNER and rel > 0.25 * tol and rel <= 0.9 * prev:
            with span("maus.refine.step"):
                d = solve_any(fac, r64.to(x0.dtype))
                x_new = x64 + d.to(C128)
                r_new = r64 - (Ac @ d).to(C128)
                rel_new = _norm(r_new) / bnorm
            if rel_new < rel:          # keep the better iterate and its residual
                x64, r64 = x_new, r_new
            prev, rel = rel, _min_nan(rel_new, rel)
            it += 1
        return x64, it

    x64 = x0.to(C128)
    r64 = true_residual(A, x64, b64)
    rel = _norm(r64) / bnorm
    prev, total = math.inf, 0
    while total < steps and rel > tol and rel <= 0.9 * prev:
        xi, it_i = inner(x64, r64, rel)
        r_true = true_residual(A, xi, b64)          # certify
        rel_true = _norm(r_true) / bnorm
        if rel_true < rel:
            x64, r64 = xi, r_true
        prev, rel = rel, _min_nan(rel_true, rel)
        total += max(it_i, 1)
    return x64, rel


def refine_gmres(A: torch.Tensor, fac, b: torch.Tensor, x0: torch.Tensor,
                 steps: int = 3, tol: float = 0.0, restart: int = 30
                 ) -> tuple[torch.Tensor, float]:
    """GMRES-IR: refinement whose correction solve is GMRES on the
    right-preconditioned operator ``A·P⁻¹`` (P = the working-dtype
    factorization), which extends the reachable κ past where plain IR
    stalls. Same operands and contract as :func:`refine_split`."""
    A = A.contiguous()
    b64 = b.to(C128).contiguous()
    Ac = A if A.dtype == x0.dtype else A.to(x0.dtype)
    bnorm = max(_norm(b64), 1e-30)

    def matvec(Z):
        # right-preconditioned operator A · P⁻¹, batched over one row
        return (Ac @ solve_any(fac, Z[0]))[None, :]

    x64 = x0.to(C128)
    r64 = true_residual(A, x64, b64)
    rel = _norm(r64) / bnorm
    prev, it = math.inf, 0
    while it < steps and rel > tol and rel <= 0.95 * prev:
        res = gmres_batched(matvec, r64.to(x0.dtype)[None, :], tol=1e-6,
                            restart=restart, max_restarts=2)
        d = solve_any(fac, res.x[0])               # un-precondition: P⁻¹ y
        x_new = x64 + d.to(C128)
        r_new = true_residual(A, x_new, b64)
        rel_new = _norm(r_new) / bnorm
        prev = rel
        # a NaN rel_new from a broken-down GMRES round must not replace the
        # carried certified rel; the iterate is guarded the same way
        if rel_new < rel:
            x64, r64, rel = x_new, r_new, rel_new
        it += 1
    return x64, rel
