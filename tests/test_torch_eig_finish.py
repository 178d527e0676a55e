"""The general eig's finish, in the card's working dtype (complex64 with its
eigen floor) on the CPU.

Seeded Ginibre operands (the benchmark's ensemble: complex N(0, 1/N)
entries) at N = 64-256 against a plain complex128 reference,
``torch.linalg.eig``, with no JAX and no kernel of the port: every pair the
port claims at tol has that residual in complex128, lies within its
Bauer-Fike band of an eigenvalue of the reference, and the pairs it calls
distinct are distinct eigenpairs, at least the target of them. An ordinary
operand, whose pairs all reach tol in the working-dtype rounds, does no
straggler work. And the short stop's mechanism: a working-dtype LU too
inexact for Newton to contract leaves a pair above tol after the working
rounds; the complex128 round takes it to tol, and only when the answer
would otherwise fall short of its target.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import maus_tpu_torch as maus
import maus_tpu_torch.ops.refine_eig as refine_eig
import maus_tpu_torch.solver.api as api
from maus_tpu_torch.solver.api import eig_convergence_floor

torch.set_num_threads(1)

C64, C128 = torch.complex64, torch.complex128
TOL = 1e-8
TARGET = 16


def ginibre(n: int, seed: int) -> torch.Tensor:
    """(G₁ + iG₂)/√N, complex64."""
    g = torch.Generator().manual_seed(seed)
    re = torch.randn(n, n, generator=g, dtype=torch.float32)
    im = torch.randn(n, n, generator=g, dtype=torch.float32)
    return torch.complex(re, im) / math.sqrt(n)


def card_eig(A: torch.Tensor, seed: int):
    n = A.shape[0]
    cfg = maus.SolverConfig(dtype=C64, convergence_floor=eig_convergence_floor(C64, n))
    return maus.eig(A, tol=TOL, num_candidates=2 * TARGET, target_solutions=TARGET,
                    seed=seed, config=cfg, device="cpu")


@pytest.mark.parametrize("n,seed", [(64, 1), (128, 2), (192, 3), (256, 4)])
def test_ginibre_pairs_against_a_plain_complex128_reference(n, seed):
    A = ginibre(n, 1000 + seed)
    rep = card_eig(A, seed)
    A64 = A.to(C128)
    w, X = torch.linalg.eig(A64)
    X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
    cond_x = float(torch.linalg.cond(X))
    assert rep.num_distinct == len(rep.solutions) == len(rep.residuals)
    matched = []
    for (lam, v), claimed in zip(rep.solutions, rep.residuals):
        if not claimed <= TOL:
            continue
        v = torch.as_tensor(v).to(C128)
        lam = complex(lam)
        r = float(torch.linalg.vector_norm(A64 @ v - lam * v) / torch.linalg.vector_norm(v))
        assert r <= TOL, (lam, r, claimed)
        # Bauer-Fike: some eigenvalue lies within cond(X)·r; the reference's
        # own eigenvalues carry a rounding error far below the slack
        d = (w - lam).abs()
        j = int(torch.argmin(d))
        assert float(d[j]) <= cond_x * r + 1e-10, (lam, float(d[j]), cond_x * r)
        matched.append(j)
    # distinct pairs are distinct eigenpairs, and the count is at least the target
    assert len(matched) == len(set(matched)) >= TARGET


def _spans(prof, name):
    return [ev for ev in prof.profiler.kineto_results.events() if ev.name() == name]


def test_an_ordinary_operand_does_no_straggler_work(monkeypatch):
    dtypes = []
    batch = api.MausSolver._refine_batch

    def watched(self, ks, lam, V, best, psi_rel=None, dtype=None):
        dtypes.append(dtype)
        return batch(self, ks, lam, V, best, psi_rel=psi_rel, dtype=dtype)

    monkeypatch.setattr(api.MausSolver, "_refine_batch", watched)
    A = ginibre(128, 77)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = card_eig(A, 5)
    assert sorted(rep.residuals)[TARGET - 1] <= TOL
    assert _spans(prof, "maus.eig.straggler") == []
    assert C128 not in dtypes
    # one finisher call a chunk of leaders, through its host read
    chunk = api.MausSolver._REFINE_CHUNK
    rounds = _spans(prof, "maus.refine_eig.round")
    assert len(rounds) >= math.ceil(len(rep.solutions) / chunk)


def _inexact_complex64_lu(monkeypatch, rel: float):
    """Factor every complex64 H as H + E with ‖E‖_F = rel·‖H‖_F (a fixed
    seeded E); complex128 factorizations stay exact."""
    exact = refine_eig.lu_factor

    def lu(H):
        if H.dtype != C64:
            return exact(H)
        g = torch.Generator().manual_seed(7)
        E = torch.complex(torch.randn(H.shape, generator=g), torch.randn(H.shape, generator=g))
        scale = rel * torch.linalg.matrix_norm(H) / torch.linalg.matrix_norm(E)
        return exact(H + E * scale[..., None, None])

    monkeypatch.setattr(refine_eig, "lu_factor", lu)


def _leaders_at_the_floor(n: int, k: int):
    """An N = 64 Ginibre operand and k of its eigenpairs moved off by 3e-6,
    as the engine hands them over at the complex64 floor."""
    A = ginibre(n, 11)
    g = torch.Generator().manual_seed(12)
    w, X = torch.linalg.eig(A.to(C128))
    X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
    P = torch.complex(torch.randn(k, n, generator=g, dtype=torch.float64),
                      torch.randn(k, n, generator=g, dtype=torch.float64))
    V = (X[:, :k].T + 3e-6 * P / torch.linalg.vector_norm(P, dim=1, keepdim=True)).to(C64)
    return A, (w[:k] + 3e-6).to(C64), V


@pytest.mark.parametrize("target,stragglers", [(8, 1), (7, 0)])
def test_a_working_lu_that_does_not_contract_leaves_stragglers(monkeypatch, target,
                                                               stragglers):
    """Newton against an inexact factorization contracts by about ‖E‖·‖S‖
    a step (E its backward error, S the reduced resolvent at the
    eigenvalue). At 4096² the card's complex64 LU has ‖E‖ ≈ 1e-5·‖H‖ and
    some Ginibre pairs an ‖S‖ large enough that the working rounds stall at
    a few 1e-8; here, at N = 64 where the CPU's complex64 LU is exact to
    ~1e-7 and ‖S‖ is small, the LU is given a 10% error so that one pair of
    eight stalls the same way. The small-ψ round restarts it from its
    complex64-rounded state and leaves it above tol. With a target of 8 the
    answer would be short, so the complex128 round takes the straggler to
    FP64 level; with a target of 7 it is not needed, and does not run."""
    _inexact_complex64_lu(monkeypatch, 0.1)
    A, lam, V = _leaders_at_the_floor(64, 8)
    cfg = maus.SolverConfig(dtype=C64, convergence_floor=eig_convergence_floor(C64, 64),
                            num_candidates=8)
    s = maus.MausSolver(A, maus.ProblemType.EIGENVALUE, config=cfg, target_solutions=target,
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        best = s._refine_spectral(list(range(8)), lam, V, np.full(8, 3e-6))
    res = sorted(best[k][2] for k in range(8))
    assert len(_spans(prof, "maus.eig.straggler")) == stragglers
    if stragglers:
        assert res[-1] <= TOL
    else:
        assert res[-2] <= TOL < res[-1]
    # the finished pairs, in complex128 against the operand
    A64 = A.to(C128)
    for k in range(8):
        lam_k, v_k, r_k = best[k]
        v_k = torch.as_tensor(v_k)
        r = float(torch.linalg.vector_norm(A64 @ v_k - lam_k * v_k)
                  / torch.linalg.vector_norm(v_k))
        assert r == pytest.approx(r_k, rel=1e-3, abs=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 300])
def test_graph_replayed_hessenberg_matches_the_cpu_reduction(n):
    """On the card each reflector of the blocked Hessenberg reduction is one
    replay of a captured CUDA graph; in complex128 its H and Q agree with
    the eager CPU reduction entry by entry, a second call (a replay of the
    cached graph) gives the same bits, and another shape captures anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    from maus_tpu_torch.ops import hessenberg as ht

    A = ginibre(n, 40 + n).to(C128)
    want = ht.reduce_hessenberg_blocked(A)
    got = ht.reduce_hessenberg_blocked(A.cuda())
    again = ht.reduce_hessenberg_blocked(A.cuda())
    scale = float(torch.linalg.matrix_norm(A))
    assert float((got.h.cpu() - want.h).abs().max()) <= 1e-10 * scale
    assert float((got.q.cpu() - want.q).abs().max()) <= 1e-10 * n ** 0.5
    assert torch.equal(got.h, again.h) and torch.equal(got.q, again.q)
    assert list(ht._CUDA_WORK) == [(n, 64, C128, A.cuda().device)]
