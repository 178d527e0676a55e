"""Matrix diagnosis, run once before the evolution loop.

Counterpart of ``maus_tpu/solver/diagnose.py``: density, Hermitian and
complex-symmetric structure, positive definiteness, and a condition estimate
(exact on the host for small operands, an on-device power / inverse-power
probe otherwise), and for an SVD the effective rank from a singular-value
sketch. The results are plain Python values.

Not carried over: the probe's TPU fallbacks (exact-slicing bf16 matvecs, and
complex64 IR residuals past the ladder limit with their widened gate) — the
card has native FP64, so the probe's residuals are FP64 (kernel K1) at any
size.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import RANK_REL_CUT, ProblemKnowledge, ProblemType
from ..ops.batched_solve import factor_qr, solve_qr, solve_qr_adj
from ..ops.kernels import residual
from ..utils.metrics import span


def _to_dense_numpy(A) -> np.ndarray:
    """Accept numpy arrays and scipy.sparse matrices; return a dense ndarray."""
    if hasattr(A, "toarray"):
        return np.asarray(A.toarray())
    return np.asarray(A)


def estimate_cond(A: np.ndarray, exact_below: int = 512, iters: int = 30) -> float:
    """2-norm condition estimate on the host: exact SVD for small matrices,
    power / inverse-power iteration on AᴴA above ``exact_below``."""
    n = min(A.shape)
    if n == 0:
        return 1.0
    if max(A.shape) <= exact_below:
        try:
            c = np.linalg.cond(A)
            return float(c) if np.isfinite(c) else np.inf
        except np.linalg.LinAlgError:
            return np.inf
    rng_ = np.random.default_rng(0)
    x = rng_.standard_normal(A.shape[1]) + 1j * rng_.standard_normal(A.shape[1])
    for _ in range(iters):
        x = A.conj().T @ (A @ x)
        nx = np.linalg.norm(x)
        if nx == 0:
            return np.inf
        x /= nx
    smax = float(np.sqrt(np.linalg.norm(A.conj().T @ (A @ x))))
    try:
        import scipy.linalg as sla
        y = rng_.standard_normal(A.shape[1]) + 1j * rng_.standard_normal(A.shape[1])
        if A.shape[0] == A.shape[1]:
            lu_piv = sla.lu_factor(A)

            def gram_inv(z):          # (AᴴA)⁻¹ z = A⁻¹ (A⁻ᴴ z)
                return sla.lu_solve(lu_piv, sla.lu_solve(lu_piv, z, trans=2))
        else:
            lu_piv = sla.lu_factor(A.conj().T @ A)

            def gram_inv(z):
                return sla.lu_solve(lu_piv, z)
        for _ in range(iters):
            y = gram_inv(y)
            ny = np.linalg.norm(y)
            if not np.isfinite(ny) or ny == 0:
                return np.inf
            y /= ny
        sminsq_inv = np.linalg.norm(gram_inv(y))
        smin = float(np.sqrt(1.0 / sminsq_inv)) if sminsq_inv > 0 else 0.0
    except (np.linalg.LinAlgError, ValueError):
        return np.inf
    return smax / smin if smin > 0 else np.inf


# ---------------------------------------------------------------------------
# On-device condition probe: no host LAPACK for large N
# ---------------------------------------------------------------------------

def _cond_probe_device(A: torch.Tensor, power_iters: int = 16,
                       inv_iters: int = 6, ir_steps: int = 10):
    """(σ_max, amplification g ≈ 1/σ_min², first-solve backward residual,
    final IR residual) from one working-dtype QR plus O(N²) iterations.

    The IR residuals double as a conditioning signal: a backward-stable
    working-dtype solve leaves an FP64-measured relative residual ≈ ε·κ(A),
    which keeps growing past the point where the inverse-power estimate
    floors at the factorization's accuracy.

    The working solves go through the linear path's QR bundle
    (``ops/batched_solve.factor_qr``): A x = b by ``solve_qr`` and Aᴴ x = b
    by ``solve_qr_adj``, each a product with R⁻¹ and Q or Qᴴ applied block
    by block from the reflectors, and one captured graph on the card. Each
    FP64 residual is one K1 read of A, or of one conjugate-transposed copy
    Aᴴ in the working dtype, and each IR step computes one."""
    n = A.shape[0]
    dev = A.device
    rdt = A.real.dtype
    c128 = torch.complex128
    # both start vectors from one seeded host generator, drawn before any
    # work is queued: every device starts from the same vectors, so the
    # card's estimate is the CPU's up to rounding
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.complex(torch.randn(n, generator=g, dtype=rdt),
                      torch.randn(n, generator=g, dtype=rdt)).to(dev, A.dtype)
    y = torch.complex(torch.randn(n, generator=g, dtype=torch.float64),
                      torch.randn(n, generator=g, dtype=torch.float64)).to(dev)

    def vnorm(z):
        return torch.linalg.vector_norm(z)

    with span("maus.diagnose.cond.power"):
        x = x / vnorm(x)
        for _ in range(power_iters):
            z = A.mH @ (A @ x)
            x = z / torch.clamp_min(vnorm(z), 1e-30)
        smax = torch.sqrt(vnorm(A.mH @ (A @ x)))

    # the QR builds the R⁻¹ that every solve of the probe goes through
    with span("maus.diagnose.cond.qr"), span("maus.diagnose.cond.rinv"):
        fac = factor_qr(A)

    Ah = A.mH.contiguous()

    def _ir(b, M, solve):
        """Solve M x = b (M is A or Aᴴ) to FP64 accuracy with the
        working-dtype factorization, carrying the residual of the kept
        iterate into the next correction; returns (x, rel_first, rel_final)."""
        bnorm = torch.clamp_min(vnorm(b), 1e-300)
        xc = solve(b.to(A.dtype)).to(c128)
        rc = residual.true_residual(M, xc, b)
        nrc = vnorm(rc)
        rel_first = nrc / bnorm
        for _ in range(ir_steps):
            x2 = xc + solve(rc.to(A.dtype))        # added in complex128
            r2 = residual.true_residual(M, x2, b)
            nr2 = vnorm(r2)
            better = nr2 < nrc
            xc = torch.where(better, x2, xc)
            rc = torch.where(better, r2, rc)
            nrc = torch.minimum(nr2, nrc)
        return xc, rel_first, nrc / bnorm

    with span("maus.diagnose.cond.inverse"):
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        gamp, rel_first, rel_final = zero + 1.0, zero, zero
        for _ in range(inv_iters):
            y = y / torch.clamp_min(vnorm(y), 1e-300)
            u, rf1, rl1 = _ir(y, Ah, lambda r: solve_qr_adj(fac, r))
            y, rf2, rl2 = _ir(u, A, lambda r: solve_qr(fac, r))
            gamp = vnorm(y)
            # later right-hand sides align with the smallest singular
            # direction, which maximizes the ε·κ backward-residual signal
            rel_first = torch.maximum(rel_first, torch.maximum(rf1, rf2))
            rel_final = torch.maximum(rel_final, torch.maximum(rl1, rl2))
    return smax.double(), gamp, rel_first, rel_final


def _cond_from_probe(probe) -> float:
    """The condition estimate from :func:`_cond_probe_device`'s outputs,
    read to the host."""
    out = torch.stack(probe).cpu().numpy()
    smax, g, rel_final = float(out[0]), float(out[1]), float(out[3])
    if not (np.isfinite(smax) and np.isfinite(g)) or g <= 0:
        return np.inf
    cond_lo = smax * np.sqrt(g)      # √g → 1/σ_min as inverse power converges
    # "resolved" ⇔ the mixed-precision IR drove the solve residual to the
    # FP64 residual arithmetic's floor; then √g is trustworthy. Beyond
    # κ ≈ 1/ε of the working dtype the factorization cannot tell κ=1e10 from
    # singular, and the honest answer is ∞ (Critical regime).
    gate = max(1e-6, 100.0 * float(np.finfo(np.float64).eps))
    return cond_lo if rel_final <= gate else np.inf


def estimate_cond_device(A: torch.Tensor) -> float:
    """Condition estimate computed on the operand's device (one
    working-dtype QR plus O(N²) iterations)."""
    with span("maus.diagnose.cond"):
        return _cond_from_probe(_cond_probe_device(A))


def _structure_probe(Ad: torch.Tensor):
    """(hermitian defect, symmetric defect, nnz), computed on the device."""
    dh = float((Ad - Ad.mH).abs().max())
    ds = float((Ad - Ad.T).abs().max())
    nnz = int(torch.count_nonzero(Ad.abs() > 1e-12))
    return dh, ds, nnz


def _svd_probe_dev(Ad: torch.Tensor) -> np.ndarray:
    """Descending singular-value sketch computed on the device: exact for
    min(M, N) ≤ 512, else a randomized range finder (64 Gaussian columns,
    seeded) and the SVD of the projected operand, which sees the top ~64
    σ's."""
    m, n = Ad.shape
    k = min(m, n)
    if k <= 512:
        s = torch.linalg.svdvals(Ad)
    else:
        g = torch.Generator(device=Ad.device)
        g.manual_seed(1)
        G = torch.randn(n, min(64, k), generator=g, dtype=torch.float32,
                        device=Ad.device).to(Ad.dtype)
        Q, _ = torch.linalg.qr(Ad @ G)
        s = torch.linalg.svdvals(Q.mH @ Ad)
    return s.to(torch.float32).cpu().numpy().astype(np.float64)


def _svd_probe_host(Ad: np.ndarray) -> np.ndarray:
    """The host counterpart of :func:`_svd_probe_dev` (numpy's generator,
    seed 1, as in the JAX package)."""
    m, n = Ad.shape
    k = min(m, n)
    if k <= 512:
        return np.linalg.svd(Ad, compute_uv=False)
    rng_ = np.random.default_rng(1)
    Q = np.linalg.qr(Ad @ rng_.standard_normal((n, min(64, k))))[0]
    return np.linalg.svd(Q.conj().T @ Ad, compute_uv=False)


def _chol_ok_dev(Ad: torch.Tensor) -> bool:
    _, info = torch.linalg.cholesky_ex(Ad)
    return int(info) == 0


def _classify_host(Ad: np.ndarray):
    """Structure flags from the host data (1e-9 absolute tolerance)."""
    herm = bool(np.allclose(Ad, Ad.conj().T, atol=1e-9))
    sym = not herm and np.iscomplexobj(Ad) and bool(np.allclose(Ad, Ad.T, atol=1e-9))
    pd = False
    if herm:
        try:
            np.linalg.cholesky(Ad)
            pd = True
        except np.linalg.LinAlgError:
            pd = False
    return herm, sym, pd


def _classify_device(exact: torch.Tensor, working: torch.Tensor):
    """(nnz, flags) from a device copy that carries the exact data; the
    Cholesky probe runs on the working copy, which the solver factorizes."""
    dh, ds, nnz = _structure_probe(exact)
    herm = dh <= 1e-9
    sym = not herm and ds <= 1e-9
    return nnz, (herm, sym, herm and _chol_ok_dev(working))


def diagnose(A, problem_type: ProblemType,
             sparse_density_threshold: float = 0.25,
             device_operand: torch.Tensor = None,
             device_full: torch.Tensor = None,
             device_exact: bool = False) -> ProblemKnowledge:
    """Classify the operand (reference ``_diagnose_matrix_initial``). Linear
    systems and eigenproblems need a square operand and are diagnosed alike;
    an SVD operand may be rectangular, keeps the structure flags False off
    the square, and adds the effective rank: singular values above
    ``RANK_REL_CUT``·σ_max of a sketch (exact for min(M, N) ≤ 512).

    ``A``: the host operand, or ``None`` when the operand exists only on the
    device (a tensor input). ``device_operand``: the working-dtype copy on
    the device; the condition estimate runs on it for large N.
    ``device_full``: the full-precision complex128 device copy of a
    complex128 input whose working copy is rounded; structure is then
    measured on the exact data. ``device_exact``: the working copy IS the
    user's exact data (float32/complex64 input)."""
    problem_type = ProblemType(problem_type)
    if A is None:
        if device_operand is None:
            raise ValueError("diagnose needs either a host operand or "
                             "device_operand")
        was_sparse = False
        Ad = None
        if device_operand.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape "
                             f"{tuple(device_operand.shape)}")
        m, n = device_operand.shape
    else:
        was_sparse = hasattr(A, "toarray")
        Ad = _to_dense_numpy(A)
        if Ad.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape {Ad.shape}")
        m, n = Ad.shape
    if m != n and problem_type != ProblemType.SVD:
        raise ValueError(f"{problem_type.name} requires a square matrix, "
                         f"got {(m, n)}")
    big = m * n > 10_000_000
    # (is_hermitian, is_complex_symmetric, is_positive_definite)
    flags = (False, False, False)
    if m != n:
        # rectangular (SVD): density only, structure is not meaningful
        nnz = int(torch.count_nonzero(device_operand.abs() > 1e-12)) \
            if Ad is None else int(np.count_nonzero(np.abs(Ad) > 1e-12))
    elif device_full is not None:
        nnz, flags = _classify_device(device_full, device_operand)
    elif device_operand is not None and (device_exact or not big):
        if device_exact or Ad is None:
            nnz, flags = _classify_device(device_operand, device_operand)
        else:
            # small operand with a possibly rounded device copy: host data
            nnz = int(np.count_nonzero(np.abs(Ad) > 1e-12))
            flags = _classify_host(Ad)
    elif device_operand is not None:
        # big operand, only a rounded working copy: the 1e-9 absolute test
        # is not resolvable at working precision — classify as general
        _, _, nnz = _structure_probe(device_operand)
    else:
        nnz = int(np.count_nonzero(np.abs(Ad) > 1e-12))
        if not big:
            flags = _classify_host(Ad)
    is_hermitian, is_complex_symmetric, is_positive_definite = flags
    density = nnz / max(1, m * n)
    is_sparse = was_sparse or density < sparse_density_threshold

    sketch = None
    if device_operand is not None and m == n and (max(m, n) > 512 or Ad is None):
        cond = estimate_cond_device(device_operand)
    elif Ad is None:
        # rectangular device operand: σ ratio of the sketch, a lower bound on
        # κ above min(M, N) = 512 (only an SVD's initial Ψ aggression reads it)
        sketch = _svd_probe_dev(device_operand)
        cond = float(sketch[0] / sketch[-1]) if sketch[-1] > 0 else np.inf
    else:
        cond = estimate_cond(Ad)
    is_singular = (not np.isfinite(cond)) or cond > 1e15

    effective_rank = None
    if problem_type == ProblemType.SVD:
        if sketch is None:
            sketch = _svd_probe_dev(device_operand) if Ad is None \
                else _svd_probe_host(Ad)
        smax = sketch[0] if len(sketch) else 1.0
        effective_rank = int(np.sum(sketch / max(smax, 1e-300) > RANK_REL_CUT)) \
            or 1

    return ProblemKnowledge(
        shape=(m, n), is_hermitian=is_hermitian,
        is_complex_symmetric=is_complex_symmetric,
        is_positive_definite=is_positive_definite,
        is_sparse_input=is_sparse, density=float(density),
        cond_estimate=float(cond) if np.isfinite(cond) else float("inf"),
        is_singular=bool(is_singular), effective_rank=effective_rank)
