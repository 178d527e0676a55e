"""KAIROSAGE in the port (``maus_tpu_torch/age``) against the JAX package's
(``maus_tpu/age``) on the CPU.

The two copies of ``tape.py`` give the same trees from the same
``random.Random`` and the same tapes. The interpreter and the diffusion
fitness agree with the JAX functions on 64 seeded random tapes, values
within 1e-5·max(1, |value|) (float32 transcendental functions differ by an
ulp between the two libraries) and validity exactly, and on the
protected-op edge cases. The reference workload (5 cycles × 20 candidates,
seed 0, ``BASELINE.md`` row 10) follows the JAX engine's trajectory cycle
by cycle: counts exactly, best fitness and Ω factors within 1e-5. The
island model keeps the JAX package's island tests, on the port."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maus_tpu.age import diffusion as diffusion_j
from maus_tpu.age import engine as engine_j
from maus_tpu.age import interp as interp_j
from maus_tpu.age import tape as tape_j
from maus_tpu_torch.age import AgeConfig, GenesisEngine, IslandAGE, diffusion, interp
from maus_tpu_torch.age import tape
from maus_tpu_torch.age import viz

torch.set_num_threads(1)

CPU = "cpu"
BASE = (0.25, 0.5, 0.25)
TOL = 1e-5


def _trees(seed, count):
    rng = random.Random(seed)
    return [tape.generate_tree(rng, 0, rng.randint(1, 4)) for _ in range(count)]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.all(np.abs(got[fin] - want[fin]) <= TOL * np.maximum(1.0, np.abs(want[fin])))


def test_tapes_identical_to_jax():
    rng_j, rng_t = random.Random(5), random.Random(5)
    for _ in range(64):
        depth = rng_j.randint(1, 4)
        assert rng_t.randint(1, 4) == depth
        tj = tape_j.generate_tree(rng_j, 0, depth)
        tt = tape.generate_tree(rng_t, 0, depth)
        assert tt.to_string() == tj.to_string()
        assert tt.complexity() == tj.complexity()
        cj, ct = tape_j.compile_tree(tj), tape.compile_tree(tt)
        assert ct.length == cj.length
        for f in ("opcode", "arg", "const"):
            np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    assert (tape.MAX_TAPE, tape.MAX_STACK) == (tape_j.MAX_TAPE, tape_j.MAX_STACK) == (64, 16)
    assert (tape.UNARY_OPS, tape.BINARY_OPS) == (tape_j.UNARY_OPS, tape_j.BINARY_OPS)


def test_eval_tape_matches_jax_on_random_tapes():
    rng = np.random.default_rng(0)
    variables = rng.uniform(-2, 2, (len(tape.VARIABLES), 16)).astype(np.float32)
    eval_j = jax.jit(interp_j.eval_tape)
    for tree in _trees(1, 64):
        t = tape.compile_tree(tree)
        vj, okj = eval_j(jnp.asarray(t.opcode), jnp.asarray(t.arg),
                         jnp.asarray(t.const), jnp.asarray(variables))
        vt, okt = interp.eval_tape(t.opcode, t.arg, t.const,
                                   torch.from_numpy(variables))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj), tree.to_string())
        ok = np.asarray(okj)
        _close(vt.numpy()[ok], np.asarray(vj)[ok])


def test_eval_population_matches_per_tape():
    """The batched interpreter on 64 tapes of mixed lengths equals each tape
    run alone (members never see each other's stack pointer)."""
    rng = np.random.default_rng(1)
    variables = torch.from_numpy(rng.uniform(-2, 2, (5, 16)).astype(np.float32))
    tapes = [tape.compile_tree(t) for t in _trees(2, 64)]
    val, valid = interp.eval_population(tape.stack_tapes(tapes), variables)
    for p, t in enumerate(tapes):
        v1, ok1 = interp.eval_tape(t.opcode, t.arg, t.const, variables)
        np.testing.assert_array_equal(valid[p].numpy(), ok1.numpy())
        np.testing.assert_array_equal(val[p].numpy()[ok1.numpy()], v1.numpy()[ok1.numpy()])


def _node(kind, name="", value=0.0, *children):
    return tape.Node(kind, value=value, name=name, children=tuple(children))


def _const(v):
    return _node("const", "", v)


EDGE_TREES = {
    "0/0": _node("binary", "/", 0.0, _const(0.0), _const(0.0)),
    "1/0": _node("binary", "/", 0.0, _const(1.0), _const(0.0)),
    "(-2)^0.5": _node("binary", "^", 0.0, _const(-2.0), _const(0.5)),
    "0^-1": _node("binary", "^", 0.0, _const(0.0), _const(-1.0)),
    "2^9 (clipped to 2^5)": _node("binary", "^", 0.0, _const(2.0), _const(9.0)),
    "exp(1000)": _node("unary", "exp", 0.0, _const(1000.0)),
    "sig(-1000)": _node("unary", "sig", 0.0, _const(-1000.0)),
    "log(0)": _node("unary", "log", 0.0, _const(0.0)),
    "sqrt(-4)": _node("unary", "sqrt", 0.0, _const(-4.0)),
    "m_i/delta_m": _node("binary", "/", 0.0, _node("var", "m_i"),
                         _node("var", "delta_m")),
}


@pytest.mark.parametrize("name", sorted(EDGE_TREES))
def test_protected_ops_match_jax(name):
    t = tape.compile_tree(EDGE_TREES[name])
    variables = np.zeros((5, 4), np.float32)
    variables[0] = [0.0, 1.0, -1.0, 3.0]
    variables[2] = [0.0, 0.0, 2.0, 1e-12]
    vj, okj = interp_j.eval_tape(jnp.asarray(t.opcode), jnp.asarray(t.arg),
                                 jnp.asarray(t.const), jnp.asarray(variables))
    vt, okt = interp.eval_tape(t.opcode, t.arg, t.const, torch.from_numpy(variables))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    _close(vt.numpy()[ok], np.asarray(vj)[ok])
    expect_valid = {"0/0": False, "1/0": False, "(-2)^0.5": False, "0^-1": False,
                    "log(0)": True, "m_i/delta_m": None}.get(name, True)
    if expect_valid is not None:
        assert bool(okt.all()) is expect_valid and bool(okt.any()) is expect_valid
    if name == "2^9 (clipped to 2^5)":
        assert float(vt[0]) == 32.0
    if name == "exp(1000)":
        assert float(vt[0]) == pytest.approx(np.exp(10.0), rel=1e-6)
    if name == "m_i/delta_m":   # 0/0 invalid, finite quotients valid, 2/1e-12 → ±inf
        assert okt.tolist() == [False, False, True, False]


def _fitness_both(tapes, n=50, t=50):
    fj = diffusion_j.population_fitness({k: jnp.asarray(v) for k, v in tapes.items()},
                                        n, t, jnp.asarray(BASE, jnp.float32))
    final, ok = diffusion_j.run_diffusion_population(
        {k: jnp.asarray(v) for k, v in tapes.items()}, n, t,
        jnp.asarray(BASE, jnp.float32))
    base = torch.tensor(BASE, dtype=torch.float32)
    ft = diffusion.population_fitness(tapes, n, t, base)
    final_t, ok_t = diffusion.run_diffusion_population(tapes, n, t, base)
    return (np.asarray(fj), np.asarray(final), np.asarray(ok)), \
        (ft.numpy(), final_t.numpy(), ok_t.numpy())


def test_population_fitness_matches_jax_on_random_tapes():
    tapes = tape.stack_tapes([tape.compile_tree(t) for t in _trees(3, 64)])
    (fj, final_j, ok_j), (ft, final_t, ok_t) = _fitness_both(tapes)
    np.testing.assert_array_equal(ok_t, ok_j)
    _close(ft, fj)
    _close(final_t[ok_j], final_j[ok_j])
    assert len(np.unique(fj)) > 8, "the members must differ"


def test_diffusion_edge_cases_match_jax():
    """A tape whose weights all die (0/0 everywhere: the uniform 0.5
    fallback, the constant-0 expression's spread), the constant-0 tape, and
    a tape that overflows every cell."""
    trees = [EDGE_TREES["0/0"], _const(0.0), EDGE_TREES["exp(1000)"],
             _node("binary", "*", 0.0, _const(1e30), _const(1e30))]
    tapes = tape.stack_tapes([tape.compile_tree(t) for t in trees])
    (fj, _, ok_j), (ft, _, ok_t) = _fitness_both(tapes)
    np.testing.assert_array_equal(ok_t, ok_j)
    _close(ft, fj)
    assert ft[0] == ft[1] and 0.4 < ft[0] <= 1.0


def test_conv_same_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.random((3, 11)).astype(np.float32)
    k = rng.random((3, 11)).astype(np.float32)
    out = diffusion._conv_same_batched(torch.from_numpy(x), torch.from_numpy(k))
    out3 = diffusion._conv_same_batched(torch.from_numpy(x), torch.tensor(BASE))
    for p in range(3):
        np.testing.assert_allclose(out[p].numpy(), np.convolve(x[p], k[p], "same"),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out3[p].numpy(), np.convolve(x[p], BASE, "same"),
                                   rtol=1e-5, atol=1e-6)


def test_reference_workload_matches_jax_engine_per_cycle():
    """BASELINE.md row 10: GenesisEngine(AgeConfig(candidates_per_cycle=20),
    seed=0).run(5): library 20/39/55/72/90, best 0.6603 in cycle 2."""
    want = engine_j.GenesisEngine(engine_j.AgeConfig(candidates_per_cycle=20),
                                  seed=0).run(5)
    got = GenesisEngine(AgeConfig(candidates_per_cycle=20), seed=0,
                        device=CPU).run(5)
    for g, w in zip(got, want):
        for key in ("cycle", "candidates", "survivors", "archived", "library_size"):
            assert g[key] == w[key], (g["cycle"], key)
        assert abs(g["best_fitness"] - w["best_fitness"]) <= TOL
        for f, v in w["omega_factors"].items():
            assert abs(g["omega_factors"][f] - v) <= TOL, f
        assert abs(g["omega_integral"] - w["omega_integral"]) <= TOL
    assert [g["library_size"] for g in got] == [20, 39, 55, 72, 90]
    assert round(got[1]["best_fitness"], 4) == 0.6603


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        GenesisEngine(AgeConfig(candidates_per_cycle=2))


# the island tests of tests/test_age_islands.py, on the port (the mesh one
# waits for the port's mesh paths)
CFG = AgeConfig(max_cycles=4, candidates_per_cycle=10, diffusion_n=32,
                diffusion_t=20)


def test_islands_are_independent_streams():
    out = IslandAGE(n_islands=2, config=CFG, seed=1, migrate_every=0,
                    device=CPU).run(2)
    s0, s1 = out[-1]["islands"]
    assert s0["best_fitness"] != s1["best_fitness"] or \
        s0["library_size"] != s1["library_size"]


def test_migration_injects_neighbors_genomes():
    a = IslandAGE(n_islands=2, config=CFG, seed=2, migrate_every=1,
                  migrate_top_k=2, device=CPU)
    a.run(1)
    assert any(a._pending), "no migrants staged after a migration cycle"
    pool_sizes = [len(p) for p in a._pending]
    out2 = a.run_cycle()
    for size, s in zip(pool_sizes, out2["islands"]):
        assert s["candidates"] == CFG.candidates_per_cycle + size


def test_no_migration_when_disabled():
    a = IslandAGE(n_islands=2, config=CFG, seed=2, migrate_every=0, device=CPU)
    a.run(3)
    assert all(len(p) == 0 for p in a._pending)


def test_single_island_matches_reference_engine():
    isl = IslandAGE(n_islands=1, config=CFG, seed=11, migrate_every=0, device=CPU)
    ref = GenesisEngine(CFG, seed=11, device=CPU)
    oi = isl.run(3)
    orf = [ref.run_genesis_cycle() for _ in range(3)]
    assert [o["islands"][0]["best_fitness"] for o in oi] == \
        [o["best_fitness"] for o in orf]


def test_islands_match_jax_islands():
    from maus_tpu.age import IslandAGE as IslandAGE_j
    cfg_j = engine_j.AgeConfig(max_cycles=4, candidates_per_cycle=10,
                               diffusion_n=32, diffusion_t=20)
    want = IslandAGE_j(n_islands=2, config=cfg_j, seed=4, migrate_every=1).run(2)
    got = IslandAGE(n_islands=2, config=CFG, seed=4, migrate_every=1,
                    device=CPU).run(2)
    for g, w in zip(got, want):
        assert g["library_total"] == w["library_total"]
        assert abs(g["best_fitness"] - w["best_fitness"]) <= TOL
        assert [s["candidates"] for s in g["islands"]] == \
            [s["candidates"] for s in w["islands"]]


def test_capture_full_grid_and_plot(tmp_path):
    eng = GenesisEngine(AgeConfig(candidates_per_cycle=4, diffusion_n=16,
                                  diffusion_t=12), seed=1, device=CPU)
    eng.run(1)
    assert eng.harmonic_library
    best = max(eng.harmonic_library, key=lambda g: g.stability)
    grid = viz.capture_full_grid(best, eng.conf, device=CPU)
    assert grid.shape == (12, 16) and np.isfinite(grid).all()
    final, _ = diffusion.run_diffusion_population(
        tape.stack_tapes([tape.compile_tree(best.tree)]), 16, 12,
        torch.tensor(BASE))
    np.testing.assert_array_equal(grid[-1], final[0].numpy())
    path = viz.plot_best(eng, path=str(tmp_path / "heat.png"))
    assert path is not None and (tmp_path / "heat.png").stat().st_size > 1000
