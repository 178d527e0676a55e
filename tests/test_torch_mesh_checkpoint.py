"""Checkpoint/resume, metrics and operand swaps of the port's mesh paths
(``solve/eig/svd(mesh=)``, ``MeshSolver``, ``utils/checkpoint`` with a
mesh) on gloo ranks on the CPU, world sizes 2 and 4: the cases of the JAX
package's ``tests/test_mesh_checkpoint.py`` (same seeds and sizes).

A resumed run equals the uninterrupted one bit for bit; the carried DistQR
factors and a DistHess come back as (N, N/m) shards equal to the saved
ones; the loader refuses a file of another model size and the
single-device format (both ways); ``MeshSolver`` keeps the user's
full-precision data across swaps and reopens a resumed carry iff the
operand changed since its checkpoint. One divergence from the JAX package
is recorded (ROADMAP Queue 3): chunked metrics have one row per iteration
up to ``max_iterations``, as on the port's single-device path.
"""
import dataclasses

import numpy as np
import pytest
import torch

from maus_tpu_torch.parallel import launch

torch.set_num_threads(1)

N = 32


def _linear(seed, cond=1e3, n=N):
    from maus_tpu_torch.problems import generators as gen

    return gen.ill_conditioned_system(n, cond=cond, seed=seed)


def _dyn(t_step):
    from maus_tpu_torch.problems import generators as gen

    return gen.dynamic_solve_system(N, t_step=t_step)


def _rand(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rank_cases(mesh, tmp):
    import maus_tpu_torch as mt
    from maus_tpu_torch import (MeshSolver, ProblemKnowledge, ProblemType,
                                SolverConfig)
    from maus_tpu_torch.parallel.dist_hessenberg import DistHess, dist_hessenberg
    from maus_tpu_torch.parallel.dist_qr import stage_A, stage_b, stage_operands
    from maus_tpu_torch.parallel.mesh import column_range
    from maus_tpu_torch.parallel.placement import ColumnSharded
    from maus_tpu_torch.solver import evolve
    from maus_tpu_torch.utils import checkpoint

    torch.set_num_threads(1)
    LIN, EIG = ProblemType.SOLVE_LINEAR_SYSTEM, ProblemType.EIGENVALUE
    out = {}

    def rep_of(r):
        return dict(iterations=r.iterations, residuals=r.residuals,
                    num_distinct=r.num_distinct, solutions=r.solutions,
                    converged=r.converged, metrics=r.metrics)

    def path(name):
        return f"{tmp}/{name}.npz"

    # solve: kill mid-way, resume from the periodic checkpoint
    A, b = _linear(3)
    common = dict(tol=1e-10, num_candidates=6, seed=5, mesh=mesh)
    ref = mt.solve(A, b, max_iterations=6, **common)
    mt.solve(A, b, max_iterations=4, checkpoint_path=path("periodic"),
             checkpoint_every=2, **common)
    out["solve_resume"] = (rep_of(ref), rep_of(mt.solve(
        A, b, max_iterations=6, resume_from=path("periodic"), **common)))
    with pytest.raises(ValueError, match="checkpoint_path"):
        mt.solve(A, b, mesh=mesh, checkpoint_every=2)

    # the carried DistQR factors save and restore as shards
    A, b = _linear(4)
    A_loc, b_work, _, _ = stage_operands(mesh, A, b)
    cfg = SolverConfig(num_candidates=6, tol=1e-10, dtype=A_loc.dtype,
                       convergence_floor=50 * float(np.finfo(np.float64).eps))
    kn = ProblemKnowledge(shape=(N, N))
    op = ColumnSharded(mesh, A_loc)
    carry = evolve.init_carry(cfg, kn, op, 0)
    checkpoint.save_state(path("carry"), carry, mesh=mesh)
    template = evolve.init_carry(cfg, kn, op, 0, template=True)
    loaded = checkpoint.load_state(path("carry"), template, mesh=mesh)
    out["carry_shards"] = dict(
        shapes=[tuple(loaded.fac.q.shape), tuple(loaded.fac.r.shape)],
        meta=template.fac.q.is_meta,
        equal=bool(torch.equal(loaded.fac.q, carry.fac.q) and
                   torch.equal(loaded.fac.r, carry.fac.r) and
                   torch.equal(loaded.pop.v, carry.pop.v)),
        files=sorted(p.split("/")[-1] for p in
                     [path("carry")] + [checkpoint.shard_path(path("carry"), i)
                                        for i in range(mesh.model)]))
    # the loader's refusals: another model size, the single-device format
    # given to a mesh load, a mesh file given to a single-device load
    refusals = []
    if mesh.index("model") == 0:
        with np.load(path("carry")) as data:
            arrays = {k: data[k] for k in data.files}
        arrays[checkpoint.MESH_KEY] = np.asarray(2 * mesh.model)
        np.savez(path("other_size"), **arrays)
        checkpoint.save_state(path("single"), carry.pop)
    from maus_tpu_torch.parallel import comm
    comm.barrier(mesh)
    for fn in (lambda: checkpoint.load_state(path("other_size"), template, mesh=mesh),
               lambda: checkpoint.load_state(path("single"), carry.pop, mesh=mesh),
               lambda: checkpoint.load_state(path("carry"), template)):
        try:
            fn()
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals

    # a DistHess round trip, against a template of meta shards
    H_loc = stage_A(mesh, _rand(5, (N, N)))[0]
    hess = dist_hessenberg(mesh, H_loc)
    checkpoint.save_state(path("hess"), hess, mesh=mesh)
    meta = DistHess(*(torch.empty(hess.h.shape, dtype=hess.h.dtype, device="meta")
                      for _ in range(2)))
    got = checkpoint.load_state(path("hess"), meta, device=mesh.device, mesh=mesh)
    out["hess_roundtrip"] = dict(shape=tuple(got.h.shape),
                                 equal=bool(torch.equal(got.h, hess.h) and
                                            torch.equal(got.q, hess.q)))

    # eig and SVD resumes
    A = _rand(7, (N, N))
    ce = dict(tol=1e-8, num_candidates=8, seed=2, mesh=mesh)
    ref = mt.eig(A, max_iterations=30, **ce)
    mt.eig(A, max_iterations=10, checkpoint_path=path("eig"), checkpoint_every=5, **ce)
    out["eig_resume"] = (rep_of(ref), rep_of(mt.eig(
        A, max_iterations=30, resume_from=path("eig"), **ce)))
    B = _rand(8, (24, N))
    cs = dict(tol=1e-8, num_candidates=6, seed=3, mesh=mesh)
    ref = mt.svd(B, max_iterations=60, **cs)
    mt.svd(B, max_iterations=20, checkpoint_path=path("svd"), checkpoint_every=10, **cs)
    out["svd_resume"] = (rep_of(ref), rep_of(mt.svd(
        B, max_iterations=60, resume_from=path("svd"), **cs)))

    # metrics
    A, b = _linear(13)
    s = MeshSolver(A, LIN, mesh, b_vector=b, initial_num_candidates=6)
    out["metrics"] = rep_of(s.evolve(max_iterations=10, collect_metrics=True))["metrics"]
    A, b = _linear(14)
    s = MeshSolver(A, LIN, mesh, b_vector=b, initial_num_candidates=6)
    out["metrics_chunked"] = rep_of(s.evolve(
        max_iterations=12, collect_metrics=True, checkpoint_path=path("mm"),
        checkpoint_every=4))["metrics"]

    # staging keeps the user's data exactly, across swaps
    lo, hi = column_range(N, mesh)
    A1, A2 = _rand(11, (N, N)), _rand(12, (N, N))
    eps32 = float(np.finfo(np.float32).eps)
    ecfg = SolverConfig(problem_type=EIG, num_candidates=8, tol=1e-8,
                        dtype=torch.complex64, convergence_floor=50 * eps32)
    s = MeshSolver(A1, EIG, mesh, config=ecfg)
    staged = [s._stA[0].dtype == torch.complex64,
              np.array_equal(s._stA[1].numpy(), A1[:, lo:hi])]
    s.update_problem(matrix=A2)
    staged.append(np.array_equal(s._stA[1].numpy(), A2[:, lo:hi]))
    At, bt = torch.from_numpy(_rand(12, (N, N))), torch.from_numpy(_rand(13, N))
    A_loc, A_true = stage_A(mesh, At)
    b_work, b_true = stage_b(mesh, bt, N)
    staged += [torch.equal(A_true, At[:, lo:hi]), torch.equal(b_true, bt),
               tuple(A_loc.shape) == (N, N // mesh.model)]
    out["staging"] = staged
    with pytest.raises(ValueError, match="b_vector"):
        s.update_problem(b_vector=np.ones(N))
    out["eig_mesh_solver"] = rep_of(MeshSolver(_rand(10, (N, N)), EIG, mesh,
                                               initial_num_candidates=8
                                               ).evolve(max_iterations=30))

    # swaps
    A1, b1 = _dyn(0)
    A2, b2 = _dyn(25)
    kw = dict(b_vector=b1, initial_num_candidates=6, global_convergence_tol=1e-8)
    s = MeshSolver(A1, LIN, mesh, **kw)
    r1 = s.evolve(max_iterations=30)
    s.update_problem(matrix=A2, b_vector=b2)
    out["swap"] = (rep_of(r1), rep_of(s.evolve(max_iterations=30)))
    A2n, b2n = _dyn(1)
    s = MeshSolver(A1, LIN, mesh, **kw)
    pre = s.evolve(max_iterations=4, checkpoint_path=path("swap"), checkpoint_every=4)
    s.update_problem(matrix=A2n, b_vector=b2n)
    out["carryover"] = (rep_of(pre), rep_of(s.evolve(max_iterations=40,
                                                     resume_from=path("swap"))))
    s = MeshSolver(A1, LIN, mesh, **kw)
    s.update_problem(matrix=A2, b_vector=b2)
    r = s.evolve(max_iterations=30, checkpoint_path=path("post"))
    out["post_swap"] = (rep_of(r), rep_of(s.evolve(max_iterations=60,
                                                   resume_from=path("post"))))
    s = MeshSolver(A1, LIN, mesh, **kw)
    pre = s.evolve(max_iterations=30, checkpoint_path=path("pre"))
    s.update_problem(matrix=A2, b_vector=b2)
    s.evolve(max_iterations=5)
    out["pre_swap"] = (rep_of(pre), rep_of(s.evolve(max_iterations=60,
                                                    resume_from=path("pre"))))
    A, b = _linear(5)
    s = MeshSolver(A, LIN, mesh, b_vector=b, initial_num_candidates=6,
                   global_convergence_tol=1e-8)
    r = s.evolve(max_iterations=30, checkpoint_path=path("noop"))
    s.update_problem()
    out["noop"] = (rep_of(r), rep_of(s.evolve(max_iterations=60,
                                              resume_from=path("noop"))))
    A, b = _linear(6)
    s = MeshSolver(A, LIN, mesh, b_vector=b, initial_num_candidates=6,
                   global_convergence_tol=1e-8)
    r = s.evolve(max_iterations=30, checkpoint_path=path("explicit"))
    out["explicit"] = (rep_of(r), rep_of(s.evolve(
        max_iterations=60, resume_from=path("explicit"), reopen=True)))
    A, b1 = _dyn(0)
    b2 = _rand(9, N)
    s = MeshSolver(A, LIN, mesh, b_vector=b1, initial_num_candidates=6)
    s.update_problem(b_vector=b2)
    out["b_only"] = rep_of(s.evolve(max_iterations=30))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"mesh_ckpt_{request.param}")
    res = launch.run(_rank_cases, request.param, str(tmp), backend="gloo",
                     device="cpu")
    return dict(m=request.param, res=res)


def _same(a, b):
    assert a["iterations"] == b["iterations"]
    assert a["num_distinct"] == b["num_distinct"]
    assert a["residuals"] == b["residuals"]
    for sa, sb in zip(a["solutions"], b["solutions"]):
        for xa, xb in zip(sa, sb):
            np.testing.assert_array_equal(xa, xb)


def test_solve_resume_bit_exact(world):
    ref, resumed = world["res"]["solve_resume"]
    _same(ref, resumed)


def test_restored_factors_keep_sharding(world):
    """The DistQR leaves come back as (N, N/m) shards equal to the saved
    ones; the template's factors are meta tensors; the files are the
    manifest and one shard a model index."""
    c = world["res"]["carry_shards"]
    m = world["m"]
    assert c["shapes"] == [(N, N // m)] * 2 and c["meta"] and c["equal"]
    assert c["files"] == sorted(["carry.npz"] + [f"carry.npz.shard{i}"
                                                  for i in range(m)])


@pytest.mark.parametrize("which, match", [
    (0, "model axis of"), (1, "single-device"), (2, "mesh")])
def test_loader_refuses_other_formats(world, which, match):
    """A file of another model size, a single-device file given to a mesh
    load and a mesh file given to a single-device load raise ValueError."""
    msg = world["res"]["refusals"][which]
    assert msg is not None and match in msg


def test_disthess_roundtrip_keeps_sharding(world):
    h = world["res"]["hess_roundtrip"]
    assert h["shape"] == (N, N // world["m"]) and h["equal"]


def test_eig_resume_matches_uninterrupted(world):
    ref, resumed = world["res"]["eig_resume"]
    _same(ref, resumed)


def test_svd_resume_matches_uninterrupted(world):
    ref, resumed = world["res"]["svd_resume"]
    _same(ref, resumed)


def test_collect_metrics_rows(world):
    m = world["res"]["metrics"]
    assert m["landscape_energy"].shape == (10,)
    assert np.all(np.isfinite(m["landscape_energy"]))
    assert m["candidate_residuals"].shape[0] == 10


def test_collect_metrics_with_checkpointing(world):
    """Chunked runs return one row per iteration up to max_iterations, as
    the port's single-device path does (the JAX mesh path ends with the
    chunk that stopped; ROADMAP Queue 3)."""
    assert world["res"]["metrics_chunked"]["landscape_energy"].shape == (12,)


@pytest.mark.parametrize("check", range(6))
def test_staging_keeps_the_users_data(world, check):
    """MeshSolver's complex64 eig stages a complex64 working copy and the
    user's complex128 data exactly, before and after a swap; stage_A and
    stage_b take tensors and keep their data exactly; shards are
    (N, N/m)."""
    assert world["res"]["staging"][check]


def test_swap_solves_new_system(world):
    (r1, r2), (A1, b1), (A2, b2) = world["res"]["swap"], _dyn(0), _dyn(25)
    for rep, A, b in ((r1, A1, b1), (r2, A2, b2)):
        assert rep["converged"]
        x = rep["solutions"][0][0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-8
    x1 = r1["solutions"][0][0]
    assert np.linalg.norm(A2 @ x1 - b2) / np.linalg.norm(b2) > 1e-6


def test_swap_with_population_carryover(world):
    pre, rep = world["res"]["carryover"]
    A2, b2 = _dyn(1)
    assert rep["iterations"] > pre["iterations"]
    x = rep["solutions"][0][0]
    assert np.linalg.norm(A2 @ x - b2) / np.linalg.norm(b2) <= 1e-8


def test_post_swap_checkpoint_resume_stays_closed(world):
    rep, rep2 = world["res"]["post_swap"]
    assert rep["converged"] and rep2["converged"]
    assert rep2["iterations"] == rep["iterations"]


def test_pre_swap_resume_reopens_despite_interleaved_evolve(world):
    pre, rep = world["res"]["pre_swap"]
    A2, b2 = _dyn(25)
    assert pre["converged"] and rep["iterations"] > pre["iterations"]
    x = rep["solutions"][0][0]
    assert np.linalg.norm(A2 @ x - b2) / np.linalg.norm(b2) <= 1e-8


def test_noop_update_does_not_reopen(world):
    rep, rep2 = world["res"]["noop"]
    assert rep["converged"] and rep2["iterations"] == rep["iterations"]


def test_explicit_reopen_override(world):
    rep, rep2 = world["res"]["explicit"]
    assert rep["converged"] and rep2["converged"]
    assert rep2["iterations"] > rep["iterations"]


def test_b_only_swap(world):
    A, _ = _dyn(0)
    b2 = _rand(9, N)
    x = world["res"]["b_only"]["solutions"][0][0]
    assert np.linalg.norm(A @ x - b2) / np.linalg.norm(b2) <= 1e-8


def test_eig_mesh_solver(world):
    rep = world["res"]["eig_mesh_solver"]
    lam_true = np.linalg.eigvals(_rand(10, (N, N)))
    assert rep["num_distinct"] >= 1
    for lam, _ in rep["solutions"]:
        assert np.min(np.abs(lam_true - lam)) < 1e-6


def test_requires_model_axis():
    from maus_tpu_torch import MeshSolver, ProblemType
    from maus_tpu_torch.parallel.mesh import single_device_mesh

    A, b = _linear(0)
    with pytest.raises(ValueError, match="model"):
        MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM,
                   single_device_mesh("cpu"), b_vector=b)
