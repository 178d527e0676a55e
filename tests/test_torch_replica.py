"""The candidate axis over replica ranks: ``place_population`` and the
engine's candidate step split over a (replica, model) mesh of gloo ranks on
the CPU.

The cases are the JAX package's ``tests/test_parallel.py`` runs (same
generators, seeds, candidate counts, tolerances and iteration bounds, in
complex128), plus a Lanczos Hermitian case (``eigh_max_n`` below N, so that
the deflation against the converged vectors is split too) and a 48×32
low-rank SVD. Each is held to two bars:

- the JAX test's own outcome bar (a converged linear candidate under 1e-8;
  8 distinct Hermitian pairs; ≥ 4 general pairs, each within 1e-4 of
  LAPACK), which the JAX package's ``evolve_while`` on its 2×4 mesh with
  ``place_population`` is held to as well (outcomes, not elements: the two
  packages' random streams differ);
- the run of the same seed without placement, inside the rank body: the
  same iterations, distinct counts and statuses; after two iterations the
  iterates within 1e-10·max|v| and the residuals within 1e-10; the
  metrics rows equal on every rank; at most 2 replica-axis collectives an
  iteration, none larger than the population's rows (nor than A, where the
  population is the smaller). On the (2, 1) mesh that run is a one-device
  run; on the (2, 2) mesh it is the model-sharded run of one replica group
  (a (1, 2) mesh's), whose operand the placed run shares.

One spawn a world size: world 2 is a (2, 1) mesh and runs every case; world
4 is a (2, 2) mesh and runs ``WORLD4`` (a Hermitian operand takes the
model-sharded Hessenberg path there, which the JAX Hermitian bar does not
describe).
"""
import dataclasses

import numpy as np
import pytest
import torch

from maus_tpu_torch.parallel import launch

torch.set_num_threads(1)

# name: (operand from the generators, candidates, tol, max_iterations)
CASES = {"linear": (lambda g: g.well_conditioned_system(64, seed=0), 8, 1e-8, 30),
         "hermitian": (lambda g: g.laplace_like_complex(8, make_hermitian=True),
                       16, 1e-7, 20),
         "lanczos": (lambda g: g.laplace_like_complex(48, make_hermitian=True),
                     16, 1e-7, 40),
         "general": (lambda g: g.laplace_like_complex(8), 24, 1e-6, 40),
         "svd": (lambda g: g.low_rank_svd_matrix(48, 32, target_rank=4, noise=1e-9),
                 8, 1e-6, 100)}
WORLD4 = ("linear", "general", "svd")
LANCZOS_EIGH_MAX_N = 32
TWO_STEP_TOL = 1e-10


def _problem(name):
    """(A, b, problem type) of a case, from the port's numpy generators
    (the JAX package's, line for line)."""
    from maus_tpu_torch import ProblemType
    from maus_tpu_torch.problems import generators as gen

    made = CASES[name][0](gen)
    if name == "linear":
        return made[0], made[1], ProblemType.SOLVE_LINEAR_SYSTEM
    return made, None, ProblemType.SVD if name == "svd" else ProblemType.EIGENVALUE


# --------------------------------------------------------------------------
# rank body (no JAX)
# --------------------------------------------------------------------------

def _host(carry):
    pop = carry.pop
    return dict(iterations=int(carry.iteration),
                num_distinct=int(carry.strat.num_distinct),
                status=pop.status.numpy().copy(), residual=pop.residual.numpy().copy(),
                lam=pop.lam.numpy().copy(), v=pop.v.numpy().copy())


def _finite_diff(a, b):
    """max|a − b| over the entries finite in both; inf where one side is
    finite and the other not."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any():
        return float("inf")
    return float(np.abs(a[fa] - b[fb]).max()) if fa.any() else 0.0


def _rank_case(mesh, name):
    import torch.distributed as dist

    from maus_tpu_torch import MausSolver
    from maus_tpu_torch.parallel import comm, placement
    from maus_tpu_torch.parallel.dist_qr import stage_operands
    from maus_tpu_torch.parallel.dist_refine import stage_spectral
    from maus_tpu_torch.parallel.placement import ColumnSharded
    from maus_tpu_torch.solver import candidate
    from maus_tpu_torch.solver import evolve as ev

    A, b, ptype = _problem(name)
    _, K, tol, iters = CASES[name]
    s = MausSolver(A, ptype, b_vector=b, initial_num_candidates=K,
                   global_convergence_tol=tol, device=mesh.device)
    cfg, kn, target = s.config, s.knowledge, s.target_solutions
    if name == "lanczos":
        cfg = dataclasses.replace(cfg, eigh_max_n=LANCZOS_EIGH_MAX_N)
    op, rhs = s.A, s.b
    if mesh.model > 1:
        if b is not None:
            A_loc, rhs, _, _ = stage_operands(mesh, A, b, dtype=cfg.dtype)
        else:
            A_loc, _ = stage_spectral(mesh, A, dtype=cfg.dtype)
        op = ColumnSharded(mesh, A_loc)

    # the rows each shifted solve is handed (K2's batch at model 1)
    solve_rows = []
    inner = candidate.solve_shifted_via_hessenberg
    dist_inner = ev.dist_solve_shifted

    def counted(cache, lams, B, psi=None):
        solve_rows.append(B.shape[0])
        return inner(cache, lams, B, psi)

    def dist_counted(mesh_, cache, lams, B, psi=None):
        solve_rows.append(B.shape[0])
        return dist_inner(mesh_, cache, lams, B, psi)

    candidate.solve_shifted_via_hessenberg = counted
    ev.dist_solve_shifted = dist_counted

    def carry0(placed):
        c = ev.init_carry(cfg, kn, op, 0)
        if placed:
            c.pop = placement.place_population(mesh, c.pop)
        return c

    try:
        ref, ref_rows = ev.evolve_metrics(cfg, kn, op, rhs, 0, iters, target,
                                          carry0=carry0(False))
        solve_rows.clear()
        with comm.counting() as counts:
            got, rows = ev.evolve_metrics(cfg, kn, op, rhs, 0, iters, target,
                                          carry0=carry0(True))
        placed_rows = sorted(set(solve_rows))
        two_ref = ev.evolve_while(cfg, kn, op, rhs, 0, 2, target,
                                  carry0=carry0(False))
        two_got = ev.evolve_while(cfg, kn, op, rhs, 0, 2, target,
                                  carry0=carry0(True))
    finally:
        candidate.solve_shifted_via_hessenberg = inner
        ev.dist_solve_shifted = dist_inner

    mine = {f.name: getattr(rows, f.name).numpy()
            for f in dataclasses.fields(rows)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mine, placed_rows))
    same_rows = all(set(m) == set(mine) and all(
        np.array_equal(m[k], mine[k], equal_nan=True) for k in mine)
        for m, _ in every)
    v2 = two_ref.pop.v.numpy()
    pop = got.pop
    row_bytes = (pop.v.shape[1] + (0 if pop.u is None else pop.u.shape[1]) + 6) \
        * 16 * pop.capacity
    return dict(
        ref=_host(ref), got=_host(got),
        ref_distinct_rows=ref_rows.num_distinct.numpy(),
        got_distinct_rows=rows.num_distinct.numpy(),
        metrics_equal_on_every_rank=same_rows,
        solve_rows=[r for _, r in every],
        dv2=float(np.abs(two_got.pop.v.numpy() - v2).max()),
        v2_scale=float(np.abs(v2).max()),
        dres2=_finite_diff(two_got.pop.residual.numpy(),
                           two_ref.pop.residual.numpy()),
        two_iterations=(int(two_ref.iteration), int(two_got.iteration)),
        replica_calls=counts.axis_calls["replica"],
        replica_largest=counts.axis_largest["replica"],
        population_bytes=row_bytes, operand_bytes=A.shape[0] * A.shape[1] * 16)


def _rank_placement(mesh):
    """``place_population`` keeps every value and attaches the slot range;
    K indivisible by the replica axis raises."""
    from maus_tpu_torch import ProblemType, SolverConfig
    from maus_tpu_torch.parallel.placement import place_population
    from maus_tpu_torch.solver import candidate

    cfg = SolverConfig(num_candidates=8, dtype=torch.complex128,
                       problem_type=ProblemType.EIGENVALUE)
    pop = candidate.init_population(cfg, 0, (16, 16), device=mesh.device)
    placed = place_population(mesh, pop)
    same = all(torch.equal(getattr(pop, f.name), getattr(placed, f.name))
               for f in dataclasses.fields(pop)
               if isinstance(getattr(pop, f.name), torch.Tensor))
    try:
        place_population(mesh, candidate.init_population(
            dataclasses.replace(cfg, num_candidates=7), 0, (16, 16),
            device=mesh.device))
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(same=same, lo=placed.slots.lo, hi=placed.slots.hi,
                refused=refused)


def _rank_cases(mesh, cases):
    torch.set_num_threads(1)
    out = {"placement": _rank_placement(mesh)}
    for name in cases:
        out[name] = _rank_case(mesh, name)
    return out


_RUNS = {}


def _run(world):
    """The spawn of world size 2 ((2, 1) mesh, every case) or 4 ((2, 2)
    mesh, ``WORLD4``), once."""
    if world not in _RUNS:
        cases = tuple(CASES) if world == 2 else WORLD4
        _RUNS[world] = launch.run(_rank_cases, world, cases, backend="gloo",
                                  device="cpu", replica=2, model=world // 2)
    return _RUNS[world]


RUNS = [(2, name) for name in CASES] + [(4, name) for name in WORLD4]
RUN_IDS = [f"world{w}-{name}" for w, name in RUNS]


@pytest.fixture(scope="module", params=RUNS, ids=RUN_IDS)
def case(request):
    world, name = request.param
    return dict(world=world, name=name, **_run(world)[name])


@pytest.mark.parametrize("world", [2, 4], ids=["world2", "world4"])
def test_place_population_preserves_values(world):
    """Every value unchanged; rank 0 (replica index 0) holds slots [0, 4)
    of 8; 7 candidates over 2 replica ranks raise ``ValueError``."""
    p = _run(world)["placement"]
    assert p["same"] and (p["lo"], p["hi"]) == (0, 4)
    assert p["refused"] is not None and "divisible" in p["refused"]


def test_same_path_as_unplaced_run(case):
    """The same iterations, distinct counts (every iteration's) and final
    statuses as the run without placement."""
    ref, got = case["ref"], case["got"]
    assert got["iterations"] == ref["iterations"]
    assert got["num_distinct"] == ref["num_distinct"]
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(case["got_distinct_rows"], case["ref_distinct_rows"])


def test_two_steps_elementwise(case):
    """After two iterations: max|Δv| ≤ 1e-10·max|v| and max|Δresidual| ≤
    1e-10 (``__graft_entry__.py``'s check, tightened for complex128)."""
    assert case["two_iterations"][0] == case["two_iterations"][1]
    assert case["dv2"] <= TWO_STEP_TOL * case["v2_scale"]
    assert case["dres2"] <= TWO_STEP_TOL


def test_metrics_equal_on_every_rank(case):
    assert case["metrics_equal_on_every_rank"]


def test_replica_collectives(case):
    """At most 2 replica-axis collectives an iteration, the largest no
    larger than the population's rows, and smaller than A where the
    population is."""
    iters = case["got"]["iterations"]
    assert 0 < case["replica_calls"] <= 2 * iters
    assert case["replica_largest"] <= case["population_bytes"]
    if case["population_bytes"] < case["operand_bytes"]:
        assert case["replica_largest"] < case["operand_bytes"]


def test_each_rank_solves_its_slots_only():
    """The general eig's shifted solves (K2 on one device, the sharded
    Hessenberg solve with model > 1) see K/r = 12 rows on every rank, and
    never the whole population."""
    K = CASES["general"][1]
    for world in (2, 4):
        rows = _run(world)["general"]["solve_rows"]
        assert len(rows) == world and all(r == [K // 2] for r in rows)


# --------------------------------------------------------------------------
# the JAX test's outcome bars, for both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ``evolve_while`` on a (replica=2, model=4) mesh
    from a carry whose population went through ``place_population``."""
    import jax

    import maus_tpu
    from maus_tpu.core.types import ProblemType
    from maus_tpu.parallel import mesh as mesh_mod
    from maus_tpu.parallel import placement
    from maus_tpu.problems import generators as gen
    from maus_tpu.solver import evolve as ev

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh8 = mesh_mod.make_mesh(replica=2, model=4)
    out = {}
    A_h, b_h = gen.well_conditioned_system(64, seed=0)
    s = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b_h,
                            initial_num_candidates=8)
    A_s, b_s = placement.place_operands(mesh8, s.A, s.b)
    c0 = ev.init_carry(s.config, s.knowledge, A_s, s._key)
    c0 = c0._replace(pop=placement.place_population(mesh8, c0.pop))
    carry, _ = ev.evolve_while(s.config, s.knowledge, A_s, b_s, s._key, 30, 1,
                               carry0=c0)
    out["linear"] = dict(status=np.asarray(carry.pop.status),
                         v=np.asarray(carry.pop.v))
    A_h = gen.laplace_like_complex(8, make_hermitian=False)
    s = maus_tpu.MausSolver(A_h, ProblemType.EIGENVALUE, initial_num_candidates=24,
                            global_convergence_tol=1e-6)
    A_s, _ = placement.place_operands(mesh8, s.A)
    c0 = ev.init_carry(s.config, s.knowledge, A_s, s._key)
    c0 = c0._replace(pop=placement.place_population(mesh8, c0.pop))
    carry, _ = ev.evolve_while(s.config, s.knowledge, A_s, None, s._key, 40,
                               s.target_solutions, carry0=c0)
    out["general"] = dict(num_distinct=int(carry.strat.num_distinct),
                          status=np.asarray(carry.pop.status),
                          lam=np.asarray(carry.pop.lam))
    return out


def _outcome(source, name, jax_runs):
    if source == "jax":
        return jax_runs[name]
    return _run(int(source[-1]))[name]["got"]


@pytest.mark.parametrize("source", ["port-world2", "port-world4", "jax"])
def test_linear_bar(source, jax_runs):
    """A converged candidate with ‖Ax − b‖/‖b‖ < 1e-8
    (``test_evolve_linear_sharded_end_to_end``)."""
    from maus_tpu_torch.problems import generators as gen

    A, b = gen.well_conditioned_system(64, seed=0)
    out = _outcome(source, "linear", jax_runs)
    conv = out["status"] == 3
    assert conv.any()
    x = out["v"][conv][0]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("source", ["port-world2", "port-world4", "jax"])
def test_general_eig_bar(source, jax_runs):
    """≥ 4 distinct pairs, each converged λ within 1e-4 of LAPACK
    (``test_evolve_general_eig_sharded``)."""
    from maus_tpu_torch.problems import generators as gen

    A = gen.laplace_like_complex(8, make_hermitian=False)
    out = _outcome(source, "general", jax_runs)
    assert out["num_distinct"] >= 4
    w_true = np.linalg.eigvals(A)
    for lam in out["lam"][out["status"] == 3]:
        assert np.min(np.abs(w_true - lam)) < 1e-4


def test_hermitian_bar():
    """8 distinct pairs of the 8² Hermitian operand in 20 iterations
    (``test_evolve_eigen_sharded``), each converged λ within 1e-7 of
    eigvalsh."""
    from maus_tpu_torch.problems import generators as gen

    A = gen.laplace_like_complex(8, make_hermitian=True)
    out = _run(2)["hermitian"]["got"]
    assert out["num_distinct"] == 8
    w = np.linalg.eigvalsh(A)
    for lam in out["lam"][out["status"] == 3]:
        assert np.min(np.abs(w - lam.real)) < 1e-7


def test_lanczos_bar():
    """The Lanczos branch (N = 48 past ``eigh_max_n`` = 32) over two replica
    ranks: ≥ 8 distinct pairs, each converged λ within 1e-6 of eigvalsh
    and its residual recomputed under 1e-6."""
    from maus_tpu_torch.problems import generators as gen

    A = gen.laplace_like_complex(48, make_hermitian=True)
    out = _run(2)["lanczos"]["got"]
    assert out["num_distinct"] >= 8
    w = np.linalg.eigvalsh(A)
    conv = out["status"] == 3
    for lam, v in zip(out["lam"][conv], out["v"][conv]):
        assert np.min(np.abs(w - lam.real)) < 1e-6
        assert np.linalg.norm(A @ v - lam * v) / np.linalg.norm(v) < 1e-6


@pytest.mark.parametrize("world", [2, 4], ids=["world2", "world4"])
def test_svd_bar(world):
    """The rank-4 48×32 operand: every converged σ within 1e-6 of LAPACK's,
    and at least its 4 triplets distinct."""
    from maus_tpu_torch.problems import generators as gen

    B = gen.low_rank_svd_matrix(48, 32, target_rank=4, noise=1e-9)
    out = _run(world)["svd"]["got"]
    assert out["num_distinct"] >= 4
    s_true = np.linalg.svd(B, compute_uv=False)
    for sig in out["lam"][out["status"] == 3].real:
        assert np.min(np.abs(s_true - sig)) < 1e-6


def test_placement_is_not_checkpointed(tmp_path):
    """A placed carry's checkpoint holds the same leaves as an unplaced
    one; loading keeps the template's placement; ``dataclasses.replace``
    keeps ``slots``; a 1-wide replica axis places nothing."""
    from maus_tpu_torch import ProblemKnowledge, ProblemType, SolverConfig
    from maus_tpu_torch.parallel.mesh import Mesh
    from maus_tpu_torch.parallel.placement import place_population
    from maus_tpu_torch.solver import evolve as ev
    from maus_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = SolverConfig(problem_type=ProblemType.EIGENVALUE, num_candidates=8,
                       dtype=torch.complex128)
    kn = ProblemKnowledge(shape=(16, 16))
    A = torch.eye(16, dtype=torch.complex128)
    mesh = Mesh(replica=2, model=1, rank=1, device=torch.device("cpu"), groups={})
    carry = ev.init_carry(cfg, kn, A, 0)
    carry.pop = place_population(mesh, carry.pop)
    assert (carry.pop.slots.lo, carry.pop.slots.hi) == (4, 8)
    assert dataclasses.replace(carry.pop, residual=carry.pop.residual * 2).slots \
        is carry.pop.slots
    n = save_state(str(tmp_path / "c.npz"), carry)
    assert n == save_state(str(tmp_path / "u.npz"), ev.init_carry(cfg, kn, A, 0))
    loaded = load_state(str(tmp_path / "c.npz"), ev.init_carry(cfg, kn, A, 0))
    assert loaded.pop.slots is None
    assert torch.equal(loaded.pop.v, carry.pop.v)
    one = Mesh(replica=1, model=1, rank=0, device=torch.device("cpu"), groups={})
    assert place_population(one, loaded.pop).slots is None
