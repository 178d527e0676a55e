"""Checkpoint and resume of the port (``utils/checkpoint.py``,
``MausSolver.evolve``'s checkpoint arguments) on the CPU.

A run saved part-way and resumed in a fresh solver reproduces the
uninterrupted run bit for bit (iterations, residuals, solutions; the
metrics rows too), on every problem path: linear in complex128 and
complex64, general eig, Hermitian eig through the shared eigh and through
Lanczos, and SVD. The port's random state is per-slot (seed, counter)
pairs inside the carry, so nothing outside the file feeds the resumed run.
The loader refuses any difference in leaves, shapes or dtypes, and pickled
content. ``reopen`` is held to the JAX package's ``_reopen_carry`` on the
same carry. The tests need no tolerance: every comparison is exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import maus_tpu
from maus_tpu.problems import generators as gen
from maus_tpu.solver import api as api_j
from maus_tpu.solver import evolve as evolve_j
from maus_tpu_torch import MausSolver, ProblemType, SolverConfig
from maus_tpu_torch.solver import evolve as evolve_t
from maus_tpu_torch.solver.api import _reopen_carry, convergence_floor
from maus_tpu_torch.utils import checkpoint
from maus_tpu_torch.utils.convert import carry_from_numpy

torch.set_num_threads(1)

LINEAR, EIG, SVD = (ProblemType.SOLVE_LINEAR_SYSTEM, ProblemType.EIGENVALUE,
                    ProblemType.SVD)


def _linear(dtype):
    A, b = gen.ill_conditioned_system(24, cond=1e4, seed=3)
    cfg = None if dtype == torch.complex128 else SolverConfig(
        dtype=dtype, num_candidates=6,
        convergence_floor=convergence_floor(dtype, 1e4))
    return dict(matrix=A, problem_type=LINEAR, b_vector=b, config=cfg,
                initial_num_candidates=6)


# (solver arguments, iterations before the save, iteration bound)
CASES = {
    "linear-c128": (lambda: _linear(torch.complex128), 1, 8),
    "linear-c64": (lambda: _linear(torch.complex64), 1, 8),
    "eig-general": (lambda: dict(
        matrix=gen.laplace_like_complex(8, make_hermitian=False),
        problem_type=EIG, initial_num_candidates=30), 4, 60),
    "eig-hermitian": (lambda: dict(
        matrix=gen.laplace_like_complex(8, make_hermitian=True),
        problem_type=EIG, initial_num_candidates=30), 1, 50),
    "eig-hermitian-lanczos": (lambda: dict(
        matrix=gen.laplace_like_complex(12, make_hermitian=True),
        problem_type=EIG, initial_num_candidates=16,
        config=SolverConfig(dtype=torch.complex128, num_candidates=16,
                            eigh_max_n=8)), 2, 40),
    "svd": (lambda: dict(matrix=gen.low_rank_svd_matrix(24, 16, 6, 0, 1e-4),
                         problem_type=SVD, initial_num_candidates=10), 7, 40),
}


def _solver(case):
    return MausSolver(**CASES[case][0](), device="cpu")


def _assert_same_report(got, want):
    assert got.iterations == want.iterations
    assert got.num_distinct == want.num_distinct
    assert got.residuals == want.residuals
    for s_got, s_want in zip(got.solutions, want.solutions):
        for x, y in zip(s_got, s_want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_load_continue_is_bit_exact(case, tmp_path):
    _, k, bound = CASES[case]
    path = str(tmp_path / "carry.npz")
    want = _solver(case).evolve(bound)
    assert want.iterations > k, "the run must go on past the save"
    part = _solver(case).evolve(k, checkpoint_path=path)
    assert part.iterations == k
    got = _solver(case).evolve(bound, resume_from=path)
    _assert_same_report(got, want)


@pytest.mark.parametrize("case", ["linear-c128", "svd"])
def test_checkpoint_every_then_resume_matches_evolve(case, tmp_path):
    """Periodic saves, a run cut short, and a resume from the last save:
    the uninterrupted run bit for bit, metrics rows included; a chunked run
    stops where the uninterrupted one stops (SVD: at its dynamic
    target)."""
    _, k, bound = CASES[case]
    path = str(tmp_path / "periodic.npz")
    want = _solver(case).evolve(bound, collect_metrics=True)
    chunked = _solver(case).evolve(bound, collect_metrics=True,
                                   checkpoint_path=str(tmp_path / "all.npz"),
                                   checkpoint_every=2)
    _assert_same_report(chunked, want)
    for name, rows in want.metrics.items():
        np.testing.assert_array_equal(chunked.metrics[name], rows, err_msg=name)
    _solver(case).evolve(k + 1, checkpoint_path=path, checkpoint_every=2)
    got = _solver(case).evolve(bound, resume_from=path)
    _assert_same_report(got, want)


def test_checkpoint_every_requires_a_path_and_a_positive_period(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_path"):
        _solver("linear-c128").evolve(4, checkpoint_every=2)
    with pytest.raises(ValueError, match=">= 1"):
        _solver("linear-c128").evolve(4, checkpoint_every=0,
                                      checkpoint_path=str(tmp_path / "c.npz"))


def _saved(tmp_path, case="linear-c128"):
    s = _solver(case)
    path = str(tmp_path / "carry.npz")
    s.evolve(1, checkpoint_path=path)
    template = evolve_t.init_carry(s.config, s.knowledge, s.A, 0, template=True)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return path, template, arrays


@pytest.mark.parametrize("change", ["shape", "dtype", "missing", "extra"])
def test_load_refuses_a_mismatched_leaf(change, tmp_path):
    path, template, arrays = _saved(tmp_path)
    assert checkpoint.load_state(path, template, device="cpu").pop.v.shape == (6, 24)
    if change == "shape":
        arrays["pop.v"] = arrays["pop.v"][:, :-1]
    elif change == "dtype":
        arrays["pop.v"] = arrays["pop.v"].astype(np.complex64)
    elif change == "missing":
        del arrays["stall_count"]
    else:
        arrays["fac.q"] = arrays["fac.v"]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match={"shape": "shape", "dtype": "dtype",
                                          "missing": "stall_count",
                                          "extra": "fac.q"}[change]):
        checkpoint.load_state(path, template, device="cpu")


def test_load_refuses_pickled_content(tmp_path):
    path, template, arrays = _saved(tmp_path)
    arrays["pop.v"] = np.array([{"not": "an array"}], dtype=object)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="allow_pickle"):
        checkpoint.load_state(path, template, device="cpu")


def test_load_refuses_another_format(tmp_path):
    path, template, arrays = _saved(tmp_path)
    arrays["__version__"] = np.asarray(checkpoint.FORMAT_VERSION + 1)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="format version"):
        checkpoint.load_state(path, template, device="cpu")


@pytest.mark.parametrize("case", ["linear-c128", "eig-general", "svd"])
def test_template_matches_init_carry(case):
    """The loader's template (no factorization computed) has the leaves,
    shapes and dtypes of the real initial carry; an HPD operand's carries a
    Cholesky factor."""
    s = _solver(case)
    real = checkpoint._flatten(evolve_t.init_carry(s.config, s.knowledge, s.A, 0))
    tmpl = checkpoint._flatten(evolve_t.init_carry(s.config, s.knowledge, s.A, 0,
                                                   template=True))
    assert set(real) == set(tmpl)
    for name, leaf in real.items():
        assert (leaf.shape, leaf.dtype) == (tmpl[name].shape, tmpl[name].dtype), name
    kn = dataclasses.replace(s.knowledge, is_positive_definite=True)
    if case == "linear-c128":
        fac = evolve_t.init_carry(s.config, kn, s.A, 0, template=True).fac
        assert type(fac).__name__ == "CholFactors" and fac.L.shape == (24, 24)


def test_save_state_round_trips_a_plain_tree(tmp_path):
    path = str(tmp_path / "tree.npz")
    tree = {"a": torch.arange(3.0), "b": {"c": torch.ones(2, dtype=torch.complex64)},
            "d": None}
    assert checkpoint.save_state(path, tree) == 2
    got = checkpoint.load_state(path, tree)
    assert got["d"] is None
    torch.testing.assert_close(got["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(got["b"]["c"], tree["b"]["c"], rtol=0, atol=0)


def test_reopen_matches_jax_reopen_carry():
    """The port's ``_reopen_carry`` against the JAX package's on the same
    carry, a converged candidate included."""
    A, b = gen.ill_conditioned_system(24, cond=1e4, seed=3)
    cfg_j = maus_tpu.SolverConfig(num_candidates=6, dtype=np.complex128)
    kn_j = maus_tpu.ProblemKnowledge(shape=A.shape, cond_estimate=1e4)
    carry = evolve_j.init_carry(cfg_j, kn_j, jax.numpy.asarray(A),
                                jax.random.PRNGKey(1))
    leaves = jax.tree.map(np.asarray, carry)
    status = leaves.pop.status.copy()
    status[2] = 3                                  # CONVERGED
    leaves = leaves._replace(
        pop=dataclasses.replace(leaves.pop, status=status,
                                alpha=np.linspace(0.1, 0.6, 6)),
        stall_count=np.int32(4),
        strat=dataclasses.replace(leaves.strat, num_distinct=np.int32(1)))
    want = api_j._reopen_carry(cfg_j, jax.tree.map(jax.numpy.asarray, leaves))
    got = _reopen_carry(SolverConfig(num_candidates=6, dtype=torch.complex128),
                        carry_from_numpy(leaves, torch.device("cpu")))
    for f in ("status", "alpha", "residual", "prev_residual", "v"):
        np.testing.assert_array_equal(getattr(got.pop, f).numpy(),
                                      np.asarray(getattr(want.pop, f)), err_msg=f)
    assert int(got.strat.num_distinct) == int(want.strat.num_distinct) == 0
    assert int(got.stall_count) == int(want.stall_count) == 0
    assert float(got.best_residual) == float(want.best_residual) == np.inf


def test_reopen_after_update_problem_runs_on_the_new_operand(tmp_path):
    """Scenario-1 swap semantics: a converged carry saved against the old
    operand, reopened after ``update_problem``, takes at least one step
    against the new one and solves it."""
    path = str(tmp_path / "swap.npz")
    A, b = gen.ill_conditioned_system(24, cond=1e4, seed=3)
    A2, b2 = gen.well_conditioned_system(24, seed=8)
    s = MausSolver(A, LINEAR, b_vector=b, initial_num_candidates=6, device="cpu")
    first = s.evolve(20, checkpoint_path=path)
    assert first.converged
    s.update_problem(A2, b2)
    plain = s.evolve(first.iterations + 20, resume_from=path)
    assert plain.iterations == first.iterations   # converged carry: no step
    rep = s.evolve(first.iterations + 20, resume_from=path, reopen=True)
    assert rep.iterations > first.iterations
    assert rep.converged
    x = rep.best()[0]
    assert np.linalg.norm(A2 @ x - b2) / np.linalg.norm(b2) <= 1e-8
