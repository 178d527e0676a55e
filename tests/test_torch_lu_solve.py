"""Kernel LS (``ops/kernels/lu_solve``): solves against the packed LU
factors of ``lu_factor``, and the eig finisher's use of it.

On the CPU the wrappers run the plain versions (the kernel's blocked
algorithm in torch operations): the permutation is held to
``torch.lu_unpack``'s, and the solve to ``torch.linalg.lu_solve`` on the
same factors by the normwise backward error ‖H·x − b‖/(‖H‖_F·‖x‖ + ‖b‖),
in complex128, of both. Its bar is 10·√N·ε of the dtype: an LU with partial
pivoting and two triangular solves are backward stable with an error that
grows like N·ε times the pivot growth in the worst case, and like √N·ε for
the random rounding of Gaussian operands, whose growth is small (the bar
``chip_smoke.py`` holds P4's solves to). The kernel runs only on a CUDA
card (the ``cuda`` tests below, which skip here; they import no JAX)."""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import maus_tpu_torch.ops.refine_eig as refine_eig
from maus_tpu_torch.ops.kernels import lu as klu
from maus_tpu_torch.ops.kernels import lu_solve as ls

torch.set_num_threads(1)

C64, C128 = torch.complex64, torch.complex128


def _gauss(shape, dtype, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    rdt = dtype.to_real()
    return torch.complex(torch.randn(shape, generator=g, dtype=rdt, device=device),
                         torch.randn(shape, generator=g, dtype=rdt, device=device))


def _bar(N, dtype):
    return 10 * math.sqrt(N) * torch.finfo(dtype.to_real()).eps


def _backward_error(H, X, B):
    """max over the batch and columns of ‖H·x − b‖/(‖H‖_F·‖x‖ + ‖b‖), in
    complex128."""
    H, X, B = H.to(C128), X.to(C128), B.to(C128)
    if B.ndim == 2:
        X, B = X[..., None], B[..., None]
    r = torch.linalg.vector_norm(H @ X - B, dim=1)
    den = torch.linalg.matrix_norm(H)[:, None] * torch.linalg.vector_norm(X, dim=1) \
        + torch.linalg.vector_norm(B, dim=1)
    return float((r / den).max())


@pytest.mark.parametrize("K,N", [(1, 1), (3, 63), (8, 200)])
def test_plain_perm_is_lu_unpacks_permutation(K, N):
    H = _gauss((K, N, N), C64, K + N)
    lu, piv = klu.lu_factor_plain(H)
    P, _, _ = torch.lu_unpack(lu, piv)
    # H = P·L·U, so (Pᵀ·B)[r] = B[perm[r]]
    want = P.mT.real.argmax(dim=-1)
    got = ls.lu_perm(lu, piv)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("R", [None, 1, 2])
@pytest.mark.parametrize("K,N", [(1, 1), (3, 63), (8, 200), (3, 129)])
def test_plain_solve_against_lu_solve(dtype, R, K, N):
    H = _gauss((K, N, N), dtype, 10 * K + N)
    B = _gauss((K, N) if R is None else (K, N, R), dtype, 7)
    lu, piv = klu.lu_factor_plain(H)
    X = ls.lu_solve(lu, ls.lu_perm(lu, piv), B)
    want = torch.linalg.lu_solve(lu, piv, B[..., None] if R is None else B)
    want = want[..., 0] if R is None else want
    assert X.shape == B.shape and X.dtype == dtype
    bar = _bar(N, dtype)
    assert _backward_error(H, X, B) <= bar
    assert _backward_error(H, want, B) <= bar


def test_zero_pivot_gives_a_non_finite_row_and_leaves_the_others():
    H = _gauss((3, 70, 70), C64, 3)
    H[1, :, 5] = 0                               # singular: a zero pivot in column 5
    lu, piv = klu.lu_factor_plain(H)
    X = ls.lu_solve(lu, ls.lu_perm(lu, piv), _gauss((3, 70, 2), C64, 4))
    finite = torch.isfinite(torch.view_as_real(X)).all(dim=-1).all(dim=(1, 2))
    assert finite.tolist() == [True, False, True]


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    H = _gauss((2, 8, 8), C64, 0)
    lu, piv = klu.lu_factor_plain(H)
    perm = ls.lu_perm(lu, piv)
    B = _gauss((2, 8), C64, 1)
    with pytest.raises(TypeError):
        ls.lu_solve(lu, perm, B.to(C128))                  # dtype other than lu's
    with pytest.raises(TypeError):
        ls.lu_solve(lu.real.contiguous(), perm, B.real)    # not complex
    for bad in (_gauss((2, 8, 3), C64, 1), _gauss((2, 7), C64, 1), B[None]):
        with pytest.raises(ValueError):
            ls.lu_solve(lu, perm, bad)                     # R > 2, N or ndim wrong
    with pytest.raises(ValueError):
        ls.lu_solve(lu.mT, perm, B)                        # factors not contiguous
    with pytest.raises(ValueError):
        ls.lu_solve(lu[0], perm[0], B[0])                  # not a batch
    with pytest.raises(ValueError):
        ls.lu_solve(lu, perm.long(), B)                    # perm not int32
    with pytest.raises(ValueError):
        ls.lu_perm(lu, piv[:, :4].contiguous())            # piv's shape
    meta = lu.to("meta")
    with pytest.raises(ValueError):
        ls.lu_solve(meta, perm, B)                         # devices differ
    with pytest.raises(ValueError):
        ls.lu_solve(meta, perm.to("meta"), B.to("meta"))   # neither CPU nor CUDA
    with pytest.raises(ValueError):
        ls.lu_perm(meta, piv.to("meta"))


def _leaders(N, K, seed, device="cpu"):
    """A Ginibre operand in complex128 and K of its eigenpairs moved off by
    ≈ 3e-6, in complex64, as the engine hands leaders to the finisher."""
    A = _gauss((N, N), C128, seed, device) / math.sqrt(2 * N)
    w, X = torch.linalg.eig(A.cpu())
    w, X = w.to(device), X.to(device)
    pick = torch.arange(K, device=device) * (N // K)
    V = X[:, pick].mT + 3e-6 * _gauss((K, N), C128, seed + 1, device)
    lam = w[pick] + 3e-6
    return A, lam.to(C64), V.to(C64)


def test_merged_newton_solve_equals_two_one_column_solves():
    """Each Newton step solves H⁻¹v and H⁻¹r in one call; solving them as
    two one-column calls gives the same (V, λ, resid) to the bit: a column's
    arithmetic does not depend on the number of columns beside it."""
    A64, lam0, V0 = _leaders(96, 6, 11)
    Ac = A64.to(C64)
    psi = 3e-6 * float(torch.linalg.vector_norm(A64)) / math.sqrt(96)
    solve = refine_eig._percand_shifted_solver(Ac, -(lam0 - psi)[:, None])

    def split(B):
        if B.ndim == 2:
            return solve(B)
        return torch.stack([solve(B[..., c].contiguous()) for c in range(2)], -1)

    def smv(X):
        return X @ A64.T

    V = V0.to(C128)
    V = V / torch.linalg.vector_norm(V, dim=-1, keepdim=True)
    merged = refine_eig._bordered_newton(smv, solve, V, lam0.to(C128), 5, C64)
    apart = refine_eig._bordered_newton(smv, split, V, lam0.to(C128), 5, C64)
    for got, want in zip(merged, apart):
        assert torch.equal(got, want)
    # and the steps did their work: the residuals fell from the start's
    lam_s = (V.conj() * smv(V)).sum(-1)
    start = torch.linalg.vector_norm(smv(V) - lam_s[:, None] * V, dim=-1)
    assert bool((merged[2] < start).all())


def test_a_finisher_call_solves_fourteen_times_through_the_wrapper(monkeypatch):
    """2 rounds × (2 pre-sweeps + 5 Newton steps), each step one two-column
    solve: 14 reads of a chunk's factors, one span each; the pivots become a
    permutation once a round."""
    calls = []
    perms = []
    solve, perm = refine_eig.lu_solve, refine_eig.lu_perm

    def counted(lu, p, B):
        calls.append(B.shape)
        return solve(lu, p, B)

    def counted_perm(lu, piv):
        perms.append(piv.shape)
        return perm(lu, piv)

    monkeypatch.setattr(refine_eig, "lu_solve", counted)
    monkeypatch.setattr(refine_eig, "lu_perm", counted_perm)
    A64, lam0, V0 = _leaders(64, 4, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        refine_eig.refine_eigenpairs(A64, lam0, V0, steps=5)
    spans = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "maus.refine_eig.solve"]
    assert len(calls) == len(spans) == 14 and len(perms) == 2
    assert sorted(set(calls)) == [(4, 64), (4, 64, 2)]
    assert calls.count((4, 64, 2)) == 10


# ---- the kernel on the card (skips without one) ----------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _card_factors(K, N, dtype, seed, shift=0.0):
    dev = _card()
    H = _gauss((K, N, N), dtype, seed, dev) / math.sqrt(N)
    H.diagonal(dim1=-2, dim2=-1).add_(shift)
    lu, piv = klu.lu_factor(H)
    return H, lu, piv, ls.lu_perm(lu, piv)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,dtype", [(8, 4096, C64), (4, 4096, C128), (3, 1000, C64),
                                       (2, 4097, C64), (5, 129, C128), (2, 1, C64)])
@pytest.mark.parametrize("R", [None, 1, 2])
def test_kernel_against_plain(K, N, dtype, R):
    """Well-conditioned operands (Gaussian/√N + 4·I, condition number ≈ 3),
    so that the two solutions agree to a few ε of the dtype whatever the
    summation order; the permutation equals the plain one."""
    H, lu, piv, perm = _card_factors(K, N, dtype, N + K, shift=4.0)
    assert torch.equal(perm, ls.lu_perm_plain(piv))
    B = _gauss((K, N) if R is None else (K, N, R), dtype, 3, H.device)
    launches = ls.LAUNCHES
    X = ls.lu_solve(lu, perm, B)
    torch.cuda.synchronize()
    assert ls.LAUNCHES == launches + 1 and X.shape == B.shape
    want = ls.lu_solve_plain(lu, perm, B)
    err = float((X - want).abs().max() / want.abs().max())
    assert err <= 100 * torch.finfo(dtype.to_real()).eps * math.sqrt(N)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,dtype", [(8, 4096, C64), (4, 4096, C128), (2, 4097, C64)])
def test_kernel_two_columns_equal_two_one_column_solves(K, N, dtype):
    """Each column's arithmetic is the same at R = 1 and R = 2 (the strip's
    sums reduced in one order whatever R), so a Newton step's merged solve
    is the two solves it replaces, to the bit."""
    H, lu, piv, perm = _card_factors(K, N, dtype, 3 * N + K)
    B = _gauss((K, N, 2), dtype, 5, H.device)
    merged = ls.lu_solve(lu, perm, B)
    apart = torch.stack([ls.lu_solve(lu, perm, B[..., c].contiguous()) for c in range(2)],
                        -1)
    assert torch.equal(merged, apart)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,dtype", [(8, 4096, C64), (4, 4096, C128), (3, 1000, C64)])
@pytest.mark.parametrize("R", [1, 2])
def test_kernel_backward_error_within_twice_lu_solves(K, N, dtype, R):
    """Plain Gaussian operands (condition numbers in the thousands): the
    kernel's normwise backward error is at most twice that of
    ``torch.linalg.lu_solve`` on the same factors, and within the bar."""
    H, lu, piv, perm = _card_factors(K, N, dtype, 2 * N + K)
    B = _gauss((K, N, R), dtype, 9, H.device)
    X = ls.lu_solve(lu, perm, B)
    want = torch.linalg.lu_solve(lu, piv, B)
    got_err, lib_err = _backward_error(H, X, B), _backward_error(H, want, B)
    assert got_err <= 2 * lib_err and got_err <= _bar(N, dtype)


@pytest.mark.cuda
def test_kernel_zero_pivot_contract():
    dev = _card()
    H = _gauss((3, 300, 300), C64, 3, dev)
    H[1, :, 200] = 0
    lu, piv = klu.lu_factor(H)
    X = ls.lu_solve(lu, ls.lu_perm(lu, piv), _gauss((3, 300, 2), C64, 4, dev))
    finite = torch.isfinite(torch.view_as_real(X)).all(dim=-1).all(dim=(1, 2))
    assert finite.tolist() == [True, False, True]


@pytest.mark.cuda
def test_refine_eigenpairs_launches_fourteen_solves_on_the_card():
    dev = _card()
    A64, lam0, V0 = _leaders(512, 8, 21, dev)
    launches, perms = ls.LAUNCHES, ls.PERM_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lam, V, res = refine_eig.refine_eigenpairs(A64, lam0, V0, steps=5)
        torch.cuda.synchronize()
    spans = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "maus.refine_eig.solve"]
    assert ls.LAUNCHES - launches == len(spans) == 14
    assert ls.PERM_LAUNCHES - perms == 2
    assert bool(torch.isfinite(res).all())


def _library_solver(M, diag):
    """The finisher's solver as it was before kernel LS: the same factors,
    each solve ``torch.linalg.lu_solve``."""
    K, N = diag.shape[0], M.shape[-1]
    H = M.expand(K, N, N).clone()
    H.diagonal(dim1=-2, dim2=-1).add_(diag)
    lu, piv = klu.lu_factor(H)

    def solve(B):
        X = torch.linalg.lu_solve(lu, piv, B[..., None] if B.ndim == 2 else B)
        return X[..., 0] if B.ndim == 2 else X
    return solve


@pytest.mark.cuda
def test_the_finisher_converges_no_worse_than_with_lu_solve(monkeypatch):
    """Over 12 seeds of 8 leaders at N = 512, no more pairs stay above 1e-8
    after ``refine_eigenpairs`` with kernel LS than with
    ``torch.linalg.lu_solve`` on the same factors (on an H100: 1 against 12;
    LS sums each row's strip in a tree of FP32 partial sums)."""
    _card()
    above = {"kernel": 0, "library": 0}
    for seed in range(100, 112):
        A64, lam0, V0 = _leaders(512, 8, seed, "cuda")
        for name in above:
            if name == "library":
                monkeypatch.setattr(refine_eig, "_percand_shifted_solver",
                                    _library_solver)
            _, _, res = refine_eig.refine_eigenpairs(A64, lam0, V0, steps=5)
            above[name] += int((res > 1e-8).sum())
            monkeypatch.undo()
    assert above["kernel"] <= above["library"], above
