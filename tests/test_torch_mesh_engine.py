"""The port's mesh engine: ``solve/eig/svd(mesh=)`` on gloo ranks on the
CPU, world sizes 2 and 4, held to the cases of the JAX package's
``tests/test_mesh_engine.py``, ``tests/test_property_fuzz_mesh.py`` and
``tests/test_dist_qr.py`` (same seeds and sizes, same bars: distinct counts,
eigenvalues and σ against LAPACK, residuals recomputed here against the
claimed ones), plus what the port adds: the operand and the factors stay
(N, N/m) shards and no collective of an engine run moves an operand-sized
array; a plain tensor takes the steps' plain expressions; ``IslandAGE``
over two replica ranks runs the one-device trajectory; the CLI's
``--cpu --cpu-devices 2 ... --mesh-model 2`` runs.

One spawn a world size runs the cases' rank body (no JAX); the assertions
run here. World size 2 runs every case; world size 4 the cases of
``WORLD4`` (one of each path and every sharding check), which keeps the
4-rank spawn short on a loaded CPU.
"""
import numpy as np
import pytest
import torch

from maus_tpu_torch.parallel import launch

torch.set_num_threads(1)

SOLVE_KINDS = ["general", "hermitian", "real", "scaled_tiny", "scaled_huge",
               "diag_dominant"]
N_FUZZ = 32
WORLD4 = {"eig_engine", "eig_engine_one", "eig_target", "svd_low_rank",
          "solve_general", "solve_hermitian", "solve_real", "solve_scaled_tiny",
          "solve_scaled_huge", "solve_diag_dominant",
          "solve_dist_qr", "svd_engine_sharding", "linear_carry", "step_svd"}


def _rand_complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _case_matrix(rng, n, kind):
    A = _rand_complex(rng, (n, n))
    return {"general": A, "hermitian": (A + A.conj().T) / 2,
            "real": rng.standard_normal((n, n)) + 0j, "scaled_tiny": A * 1e-6,
            "scaled_huge": A * 1e6, "diag_dominant": A + 3 * n * np.eye(n)}[kind]


def _conditioned(n, cond, seed):
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(_rand_complex(rng, (n, n)))
    q2, _ = np.linalg.qr(_rand_complex(rng, (n, n)))
    return (q1 * np.logspace(0, -np.log10(cond), n)[None, :]) @ q2.conj().T, \
        _rand_complex(rng, n)


def _c64_cfg(ptype, k, n, tol):
    from maus_tpu_torch import SolverConfig

    eps32 = float(np.finfo(np.float32).eps)
    return SolverConfig(problem_type=ptype, num_candidates=k, tol=tol,
                        dtype=torch.complex64,
                        convergence_floor=float(max(50.0, np.sqrt(n)) * eps32))


def _inputs():
    """Every case's operand, from the JAX tests' seeds."""
    inp = {}
    rng = np.random.default_rng(0)
    inp["eig_engine"] = _rand_complex(rng, (48, 48))
    inp["eig_c64"] = _rand_complex(np.random.default_rng(1), (64, 64))
    G = _rand_complex(np.random.default_rng(2), (32, 32))
    inp["eig_hermitian"] = (G + G.conj().T) / 2
    inp["svd_spectrum"] = _rand_complex(np.random.default_rng(3), (48, 64))
    inp["svd_c64"] = _rand_complex(np.random.default_rng(4), (48, 64))
    rng = np.random.default_rng(5)
    u1, u2 = np.linalg.qr(_rand_complex(rng, (32, 2)))[0].T
    v1, v2 = np.linalg.qr(_rand_complex(rng, (40, 2)))[0].T
    inp["svd_low_rank"] = 5.0 * np.outer(u1, v1.conj()) + \
        2.5 * np.outer(u2, v2.conj())
    inp["svd_iters"] = _rand_complex(np.random.default_rng(6), (24, 32))
    inp["svd_sharded"] = _rand_complex(np.random.default_rng(8), (48, 64))
    for kind in SOLVE_KINDS:
        rng = np.random.default_rng(sum(map(ord, kind)) % 1000)
        inp[f"solve_{kind}"] = (_case_matrix(rng, N_FUZZ, kind),
                                _rand_complex(rng, N_FUZZ))
    for kind in ("general", "hermitian", "scaled_huge"):
        rng = np.random.default_rng(3 + sum(map(ord, kind)) % 1000)
        inp[f"eigfuzz_{kind}"] = _case_matrix(rng, N_FUZZ, kind)
    for kind in ("general", "scaled_tiny"):
        rng = np.random.default_rng(7 + sum(map(ord, kind)) % 1000)
        inp[f"svd_{kind}"] = _case_matrix(rng, N_FUZZ, kind)[:24]
    inp["solve_dist_qr"] = _conditioned(64, 1e6, seed=3)
    return inp


# --------------------------------------------------------------------------
# rank body (no JAX)
# --------------------------------------------------------------------------

def _rank_cases(mesh, inp, cases):
    import maus_tpu_torch as mt
    from maus_tpu_torch import ProblemKnowledge, ProblemType, SolverConfig
    from maus_tpu_torch.parallel import comm
    from maus_tpu_torch.parallel.dist_qr import DistQR, stage_operands
    from maus_tpu_torch.parallel.dist_refine import stage_spectral
    from maus_tpu_torch.parallel.placement import ColumnSharded
    from maus_tpu_torch.solver import candidate, evolve

    torch.set_num_threads(1)
    out = {}

    def report(rep):
        return dict(solutions=rep.solutions, residuals=rep.residuals,
                    num_distinct=rep.num_distinct, iterations=rep.iterations,
                    target=rep.target_solutions, converged=rep.converged,
                    shards=rep.shards)

    EIG, SVD = ProblemType.EIGENVALUE, ProblemType.SVD
    A = inp["eig_engine"]
    cases = set(inp) | {"eig_engine_one", "eig_target", "svd_engine_sharding",
                        "linear_carry", "step_svd"} if cases is None else cases
    runs = {
        "eig_engine": lambda: mt.eig(A, tol=1e-8, max_iterations=60,
                                     num_candidates=16, seed=3, mesh=mesh),
        "eig_engine_one": lambda: mt.eig(A, tol=1e-8, max_iterations=60,
                                         num_candidates=16, seed=3,
                                         device=mesh.device),
        "eig_target": lambda: mt.eig(A, tol=1e-8, max_iterations=60,
                                     num_candidates=16, seed=3,
                                     target_solutions=4, mesh=mesh),
        "eig_c64": lambda: mt.eig(inp["eig_c64"], tol=1e-10, max_iterations=60,
                                  mesh=mesh, config=_c64_cfg(EIG, 16, 64, 1e-10)),
        "eig_hermitian": lambda: mt.eig(inp["eig_hermitian"], tol=1e-8,
                                        max_iterations=60, num_candidates=12,
                                        mesh=mesh),
        "svd_spectrum": lambda: mt.svd(inp["svd_spectrum"], tol=1e-8,
                                       max_iterations=80, num_candidates=8,
                                       mesh=mesh),
        "svd_c64": lambda: mt.svd(inp["svd_c64"], tol=1e-10, max_iterations=80,
                                  mesh=mesh, config=_c64_cfg(SVD, 8, 64, 1e-10)),
        "svd_low_rank": lambda: mt.svd(inp["svd_low_rank"], tol=1e-8,
                                       max_iterations=60, num_candidates=6,
                                       mesh=mesh),
        "svd_iters": lambda: mt.svd(inp["svd_iters"], tol=1e-8,
                                    max_iterations=200, num_candidates=4,
                                    mesh=mesh),
        "solve_dist_qr": lambda: mt.solve(*inp["solve_dist_qr"], tol=1e-8,
                                          max_iterations=40, num_candidates=8,
                                          mesh=mesh),
    }
    for key in inp:
        if key.startswith("solve_") and key != "solve_dist_qr":
            runs[key] = lambda k=key: mt.solve(*inp[k], tol=1e-8, max_iterations=40,
                                               num_candidates=6, seed=1, mesh=mesh)
        elif key.startswith("eigfuzz_"):
            runs[key] = lambda k=key: mt.eig(inp[k], tol=1e-8, max_iterations=60,
                                             num_candidates=8, seed=2, mesh=mesh)
        elif key in ("svd_general", "svd_scaled_tiny"):
            runs[key] = lambda k=key: mt.svd(inp[k], tol=1e-8, max_iterations=60,
                                             num_candidates=6, seed=3, mesh=mesh)
    for key, fn in runs.items():
        if key in cases:
            out[key] = report(fn())
    if mesh.model == 4 or "eig_engine" in cases:
        with pytest.raises(ValueError, match="divisible"):
            mt.eig(np.eye(10 if mesh.model == 4 else 9), mesh=mesh)

    # the staged operand and the carried factors are (N, N/m) shards, and
    # no collective of an engine run moves an operand-sized array
    B = inp["svd_sharded"]
    A_loc, A64 = stage_spectral(mesh, B)
    cfg = SolverConfig(problem_type=SVD, num_candidates=8, tol=1e-8,
                       dtype=A_loc.dtype,
                       convergence_floor=float(50 * np.finfo(np.float64).eps))
    with comm.counting() as counts:
        carry = evolve.evolve_while(cfg, ProblemKnowledge(shape=B.shape),
                                    ColumnSharded(mesh, A_loc), None, 0, 5, 8)
    out["svd_engine_sharding"] = dict(
        shapes=[tuple(A_loc.shape), tuple(A64.shape)],
        largest=max(counts.largest.values()), calls=dict(counts.calls),
        iterations=int(carry.iteration))
    A, b = inp["solve_dist_qr"]
    A_loc, b_work, A_true, _ = stage_operands(mesh, A, b)
    kn = ProblemKnowledge(shape=A.shape)
    lcfg = SolverConfig(num_candidates=8, tol=1e-6, dtype=A_loc.dtype,
                        convergence_floor=1e-5, refine=False)
    op = ColumnSharded(mesh, A_loc)
    c0 = evolve.init_carry(lcfg, kn, op, 0)
    with comm.counting() as counts:
        c3 = evolve.evolve_while(lcfg, kn, op, b_work, 0, 3, 1)
    out["linear_carry"] = dict(
        fac=type(c0.fac) is DistQR, shapes=[tuple(t.shape) for t in
                                            (A_loc, A_true, c0.fac.q, c0.fac.r,
                                             c3.fac.q, c3.fac.r)],
        finite=bool(torch.isfinite(c3.best_residual)), largest=max(
            counts.largest.values()), iterations=int(c3.iteration))

    # the steps through a column-sharded operand against the plain tensor
    pop = candidate.init_population(cfg, 0, B.shape, device=mesh.device)
    strat = evolve.initial_strategy(cfg, ProblemKnowledge(shape=B.shape),
                                    device=mesh.device)
    Bt = torch.from_numpy(B)
    p_plain, _ = candidate.step_svd(cfg, Bt, pop, strat)
    p_mesh, _ = candidate.step_svd(
        cfg, ColumnSharded(mesh, stage_spectral(mesh, B)[0]), pop, strat)
    out["step_svd"] = dict(v=(p_plain.v - p_mesh.v).abs().max().item(),
                           res=(p_plain.residual - p_mesh.residual).abs().max().item())
    return out


def _rank_islands(mesh):
    from maus_tpu_torch.age import AgeConfig, IslandAGE

    torch.set_num_threads(1)
    cfg = AgeConfig(max_cycles=4, candidates_per_cycle=10, diffusion_n=32,
                    diffusion_t=20)
    a = IslandAGE(n_islands=3, config=cfg, seed=7, mesh=mesh, migrate_every=2)
    b = IslandAGE(n_islands=3, config=cfg, seed=7, migrate_every=2,
                  device=mesh.device)
    return a.run(4), b.run(4)


_RUNS = {}


def _run(m):
    """The spawn of world size m (every case at 2, ``WORLD4`` at 4), once."""
    if m not in _RUNS:
        inp = _inputs()
        res = launch.run(_rank_cases, m, inp, None if m == 2 else WORLD4,
                         backend="gloo", device="cpu")
        _RUNS[m] = dict(m=m, inp=inp, res=res)
    return _RUNS[m]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    return _run(request.param)


@pytest.fixture(scope="module")
def world2():
    return _run(2)


def _eig_pairs_ok(A, rep, lam_tol, res_tol):
    lam_true = np.linalg.eigvals(A)
    for (lam, v), claimed in zip(rep["solutions"], rep["residuals"]):
        assert np.min(np.abs(lam_true - lam)) < lam_tol
        recomputed = np.linalg.norm(A @ v - lam * v)
        assert recomputed < res_tol
        assert recomputed <= max(2 * claimed, 1e-12 * np.abs(lam_true).max())


def _triplets_ok(B, rep, sig_tol, res_tol):
    s_true = np.linalg.svd(B, compute_uv=False)
    for (sig, u, v), claimed in zip(rep["solutions"], rep["residuals"]):
        assert np.min(np.abs(s_true - sig)) < sig_tol
        r = np.linalg.norm(B @ v - sig * u) + np.linalg.norm(B.conj().T @ u - sig * v)
        assert r < res_tol and r <= max(2 * claimed, 1e-12 * s_true[0])


def test_eig_matches_single_device_engine(world):
    """Same engine, same seed (48², 16 candidates): the mesh path reaches
    the one-device path's distinct count (less 2, the JAX bar), eigenvalues
    within 1e-6 of LAPACK, residuals ≤ 1e-8·‖A‖_F."""
    A = world["inp"]["eig_engine"]
    rep, one = world["res"]["eig_engine"], world["res"]["eig_engine_one"]
    assert rep["num_distinct"] >= min(one["num_distinct"], 16 - 2)
    _eig_pairs_ok(A, rep, 1e-6, 1e-8 * np.linalg.norm(A))


def test_eig_c64_finisher_lifts_to_f64(world2):
    """Complex64 engine, FP64 finisher: ≥ 6 pairwise distinct pairs, each
    claimed ≤ 1e-11·‖A‖_F and recomputed within 2× the claim."""
    A = world2["inp"]["eig_c64"]
    rep = world2["res"]["eig_c64"]
    assert rep["num_distinct"] >= 6
    lams = np.array([lam for lam, _ in rep["solutions"]])
    assert np.min(np.abs(lams[:, None] - lams[None, :]) + np.eye(len(lams))) > 1e-6
    for (lam, v), claimed in zip(rep["solutions"], rep["residuals"]):
        assert claimed < 1e-11 * np.linalg.norm(A)
        assert np.linalg.norm(A @ v - lam * v) < max(2 * claimed, 1e-13)


def test_eig_hermitian_routes_through_dist_hessenberg(world2):
    """A Hermitian operand takes the sharded Hessenberg path: ≥ 6 pairs,
    real eigenvalues within 1e-6 of eigvalsh."""
    H = world2["inp"]["eig_hermitian"]
    rep = world2["res"]["eig_hermitian"]
    assert rep["num_distinct"] >= 6
    lam_true = np.linalg.eigvalsh(H)
    for lam, _ in rep["solutions"]:
        assert abs(lam.imag) < 1e-7 and np.min(np.abs(lam_true - lam.real)) < 1e-6


def test_svd_matches_true_spectrum(world2):
    B = world2["inp"]["svd_spectrum"]
    rep = world2["res"]["svd_spectrum"]
    assert rep["num_distinct"] >= 4
    _triplets_ok(B, rep, 1e-6, 1e-8 * np.linalg.norm(B))


def test_svd_c64_finisher_lifts_to_f64(world2):
    B = world2["inp"]["svd_c64"]
    rep = world2["res"]["svd_c64"]
    assert rep["num_distinct"] >= 4
    for (sig, u, v), claimed in zip(rep["solutions"], rep["residuals"]):
        assert claimed < 1e-11 * np.linalg.norm(B)
        r = np.linalg.norm(B @ v - sig * u) + np.linalg.norm(B.conj().T @ u - sig * v)
        assert r < max(2 * claimed, 1e-12)


def test_svd_low_rank_dynamic_target(world):
    """Rank 2: the dynamic target stops the run at 2 triplets, σ within
    1e-6 of 5 and 2.5."""
    rep = world["res"]["svd_low_rank"]
    sigs = sorted((s for s, _, _ in rep["solutions"]), reverse=True)
    assert abs(sigs[0] - 5.0) < 1e-6 and abs(sigs[1] - 2.5) < 1e-6
    assert rep["target"] == 2


def test_svd_max_iterations_honored(world2):
    rep = world2["res"]["svd_iters"]
    assert rep["iterations"] <= 200 and rep["num_distinct"] >= 2


@pytest.mark.parametrize("kind", SOLVE_KINDS)
def test_mesh_solve_reaches_tol_and_reports_honestly(world, kind):
    """Each structure and scale draw converges; the true relative residual
    is ≤ 1e-8 and the reported one within 1e-8 + 50% of it."""
    A, b = world["inp"][f"solve_{kind}"]
    rep = world["res"][f"solve_{kind}"]
    assert rep["converged"]
    x = rep["solutions"][int(np.argmin(rep["residuals"]))][0]
    true_rel = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert true_rel <= 1e-8
    assert abs(rep["residuals"][0] - true_rel) <= 1e-8 + 0.5 * true_rel


@pytest.mark.parametrize("kind", ["general", "hermitian", "scaled_huge"])
def test_mesh_eig_matches_spectrum(world2, kind):
    A = world2["inp"][f"eigfuzz_{kind}"]
    rep = world2["res"][f"eigfuzz_{kind}"]
    assert rep["num_distinct"] >= 2
    scale = np.max(np.abs(np.linalg.eigvals(A)))
    _eig_pairs_ok(A, rep, 1e-5 * scale, np.inf)


@pytest.mark.parametrize("kind", ["general", "scaled_tiny"])
def test_mesh_svd_matches_spectrum(world2, kind):
    B = world2["inp"][f"svd_{kind}"]
    rep = world2["res"][f"svd_{kind}"]
    assert rep["num_distinct"] >= 2
    s1 = np.linalg.svd(B, compute_uv=False)[0]
    _triplets_ok(B, rep, 1e-5 * s1, np.inf)


def test_population_evolve_with_sharded_factorization(world):
    """κ = 1e6 at 64²: the engine ran, and the refined solution's true
    relative residual is ≤ 1e-8 (``tests/test_dist_qr.py``)."""
    A, b = world["inp"]["solve_dist_qr"]
    rep = world["res"]["solve_dist_qr"]
    assert rep["converged"] and rep["iterations"] > 0
    x = rep["solutions"][0][0]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-8


def test_operand_and_factors_stay_column_sharded(world):
    """Every rank holds A, its FP64 copy and the carried Q and R as
    (N, N/m) shards, before and after evolving; no collective of either
    engine run moves an array as large as the operand."""
    m = world["m"]
    s = world["res"]["svd_engine_sharding"]
    assert s["shapes"] == [(48, 64 // m)] * 2
    assert 0 < s["largest"] < 48 * 64 * 16 and s["iterations"] == 5
    lin = world["res"]["linear_carry"]
    assert lin["fac"] and lin["shapes"] == [(64, 64 // m)] * 6
    assert lin["finite"] and 0 < lin["largest"] < 64 * 64 * 16


@pytest.mark.parametrize("case,names", [
    ("solve_dist_qr", ("A", "A_true", "Q", "R")),
    ("eig_engine", ("A", "A64", "H", "Q")),
    ("svd_low_rank", ("A", "A64"))])
def test_reports_hold_only_column_shards(world, case, names):
    """Each mesh path reports the operand and factor shards it held in the
    run, read from the path itself (the engine's sharded operand, the
    carried factors, the Hessenberg form): every one (rows, N/m); a
    one-device run reports none."""
    m, inp = world["m"], world["inp"][case]
    A = inp[0] if case.startswith("solve") else inp
    shards = world["res"][case]["shards"]
    assert tuple(shards) == names
    assert all(s == (A.shape[0], A.shape[1] // m) for s in shards.values())
    assert world["res"]["eig_engine_one"]["shards"] is None


def test_sharded_step_matches_the_plain_step(world):
    """One SVD step through the column-sharded operand equals the step on
    the plain tensor within rounding (1e-12)."""
    d = world["res"]["step_svd"]
    assert d["v"] < 1e-12 and d["res"] < 1e-12


def test_islands_over_two_replica_ranks_match_one_device():
    """Stage III split over two replica ranks (3 islands × 10 candidates,
    padded) gives the one-device run's trajectory exactly
    (``tests/test_age_islands.py::test_mesh_independent_trajectory``)."""
    mesh_run, one = launch.run(_rank_islands, 2, backend="gloo", device="cpu",
                               replica=2, model=1)
    assert [o["best_fitness"] for o in mesh_run] == [o["best_fitness"] for o in one]
    assert [o["library_total"] for o in mesh_run] == [o["library_total"] for o in one]


def test_cli_cpu_devices_mesh_model_runs(capsys):
    """``--cpu --cpu-devices 2 solve --mesh-model 2 --check`` runs the mesh
    path on two gloo ranks and prints the converged report."""
    from maus_tpu_torch import cli

    assert cli.main(["--cpu", "--cpu-devices", "2", "solve", "--n", "32",
                     "--mesh-model", "2", "--check"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("SOLVE_LINEAR_SYSTEM: 1/1 distinct solutions")
    assert "matched 1/1" in out[-1]


def test_eig_mesh_honours_target_solutions(world):
    """``eig(mesh=, target_solutions=4)`` stops at 4 distinct pairs of 16
    candidates: the port forwards the argument, which the JAX package's
    mesh path ignores (its target is the candidate count; ROADMAP Queue 3)."""
    rep = world["res"]["eig_target"]
    assert rep["target"] == 4 and rep["num_distinct"] >= 4
    assert rep["iterations"] <= world["res"]["eig_engine"]["iterations"]
    _eig_pairs_ok(world["inp"]["eig_engine"], rep, 1e-6,
                  1e-8 * np.linalg.norm(world["inp"]["eig_engine"]))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_mesh_floor_rule_is_the_jax_mesh_rule(dtype):
    """The mesh linear floor is 50·ε of the working dtype, as in
    ``maus_tpu/solver/api.py:1121``, not the single-device
    ``convergence_floor`` (complex64 κ = 1e6: 0.238 there, 5.96e-6 here;
    ROADMAP Queue 3)."""
    from maus_tpu_torch.solver.api import convergence_floor, mesh_convergence_floor

    eps = float(np.finfo(np.float32 if dtype == torch.complex64 else np.float64).eps)
    assert mesh_convergence_floor(dtype) == 50 * eps
    if dtype == torch.complex64:
        assert convergence_floor(dtype, 1e6) > 1e4 * mesh_convergence_floor(dtype)
