"""The solver's named spans (``maus_tpu_torch.utils.metrics.span``) under
``torch.profiler`` on the CPU.

A tiny complex64 linear solve (the public ``solve``, whose tensor operand
takes the on-device condition probe, and a ``MausSolver`` given κ, which
skips it), a tiny general eig, one large enough for the blocked Hessenberg
reduction's panels, a Hermitian eig and an SVD each run once
without and once inside a CPU profile. The spans must be plain CPU
operations (not user annotations, which the profiler mirrors on the device
timeline), nest as their layers do, count the engine's iterations, the
linear path's factorizations, the Hessenberg panels and the eigenpair
finisher's chunks, the SVD's block rounds and its finisher's chunks, and
leave every answer bit-equal; with no profiler running ``span`` is one
shared null context. An evolve cut by ``max_iterations`` with its stop
condition unmet opens ``maus.engine.capped`` once, on every path.
"""
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import maus_tpu_torch as maus
from maus_tpu_torch.problems import generators as gen
from maus_tpu_torch.solver.api import convergence_floor, eig_convergence_floor
from maus_tpu_torch.utils import metrics

torch.set_num_threads(1)

C64 = torch.complex64
COND = 1e4


def _linear_operands():
    A, b = gen.ill_conditioned_system(48, COND)
    return torch.as_tensor(A).to(C64), torch.as_tensor(b).to(C64)


def _linear_config():
    return maus.SolverConfig(dtype=C64, convergence_floor=convergence_floor(C64, COND))


def _solve():
    A, b = _linear_operands()
    return maus.solve(A, b, tol=1e-8, num_candidates=8, config=_linear_config(),
                      device="cpu")


def _known_cond():
    A, b = _linear_operands()
    kn = maus.ProblemKnowledge(shape=tuple(A.shape), cond_estimate=COND)
    return maus.MausSolver(A, maus.ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           initial_num_candidates=8, config=_linear_config(), seed=3,
                           knowledge=kn, device="cpu").evolve(50)


def _restaged():
    A, b = _linear_operands()
    s = maus.MausSolver(A, maus.ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                        initial_num_candidates=8, config=_linear_config(), device="cpu")
    s.update_problem(b_vector=2 * b)
    return s.evolve(50)


def _eig():
    E = torch.as_tensor(gen.laplace_like_complex(8, make_hermitian=False)).to(C64)
    cfg = maus.SolverConfig(dtype=C64, convergence_floor=eig_convergence_floor(C64, 8))
    return maus.eig(E, tol=1e-7, num_candidates=30, config=cfg, device="cpu")


def _eig_panels():
    """A general eig past 2·64 + 2, where the Hessenberg reduction runs in
    compact-WY panels of 64 reflectors (``reduce_hessenberg_auto``)."""
    g = torch.Generator().manual_seed(0)
    n = 160
    E = torch.complex(torch.randn(n, n, generator=g), torch.randn(n, n, generator=g)) / n ** 0.5
    cfg = maus.SolverConfig(dtype=C64, convergence_floor=eig_convergence_floor(C64, n))
    return maus.eig(E, tol=1e-8, num_candidates=8, target_solutions=4, config=cfg,
                    device="cpu")


def _eig_hermitian():
    H = gen.laplace_like_complex(8, make_hermitian=True)
    return maus.eig(H, tol=1e-7, num_candidates=30, device="cpu")


def _svd(**kw):
    return maus.svd(gen.low_rank_svd_matrix(5, 4), tol=1e-6, device="cpu", **kw)


def _separated_svd_operand(m, n, top, seed=0):
    """U·diag(σ)·Vᴴ, complex128, Haar U (m×n) and V: σ = 0.8^k for k < top,
    then a clustered logspace(−2, −4) tail."""
    g = torch.Generator().manual_seed(seed)

    def haar(rows, cols):
        G = torch.complex(torch.randn(rows, cols, generator=g, dtype=torch.float64),
                          torch.randn(rows, cols, generator=g, dtype=torch.float64))
        q, r = torch.linalg.qr(G)
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    U, V = haar(m, n), haar(n, n)
    sig = torch.cat([0.8 ** torch.arange(top, dtype=torch.float64),
                     torch.logspace(-2.0, -4.0, n - top, dtype=torch.float64)])
    return (U * sig[None, :]) @ V.mH


def _svd_chunks():
    """An SVD with more leaders than one finisher chunk of 8, whose
    clustered tail keeps the dynamic target out of reach: it runs to
    ``max_iterations``."""
    return maus.svd(_separated_svd_operand(96, 48, 12), tol=1e-8, max_iterations=30,
                    num_candidates=24, target_solutions=12, seed=1, device="cpu")


RUNS = {"solve": _solve, "known_cond": _known_cond, "update_problem": _restaged,
        "eig": _eig, "eig_panels": _eig_panels, "eig_hermitian": _eig_hermitian,
        "svd": _svd, "svd_chunks": _svd_chunks}
LINEAR = ("solve", "known_cond", "update_problem")

# the spans each path runs (the GMRES-IR fallback is not expected on any)
SHARED = {"maus.entry", "maus.setup", "maus.engine", "maus.engine.init",
          "maus.engine.iteration", "maus.finish"}
PROBE = {"maus.diagnose.cond", "maus.diagnose.cond.power", "maus.diagnose.cond.qr",
         "maus.diagnose.cond.rinv", "maus.diagnose.cond.inverse"}
LINEAR_ONLY = {"maus.factor", "maus.factor.implicit_q", "maus.refine.step"}
# the eigenpair finisher's chunks and its solves; the straggler round is not
# expected
EIG_FINISH = {"maus.refine_eig.round", "maus.refine_eig.solve"}
# the SVD's block rounds, its finisher's chunks and their solves
SVD_PATH = {"maus.svd.block_round", "maus.refine_svd.round", "maus.refine_eig.solve"}
EXPECTED = {"solve": SHARED | PROBE | LINEAR_ONLY,
            "known_cond": SHARED | LINEAR_ONLY,
            "update_problem": SHARED | PROBE | LINEAR_ONLY,
            "eig": SHARED | PROBE | EIG_FINISH,
            "eig_panels": SHARED | PROBE | EIG_FINISH | {"maus.hessenberg.panel"},
            "eig_hermitian": SHARED | EIG_FINISH,
            "svd": SHARED | SVD_PATH,
            "svd_chunks": SHARED | SVD_PATH | {"maus.engine.capped"}}

_CACHE = {}


def _traced(name):
    """(quiet report, traced report, the traced run's ``maus.*`` events as
    (name, start ns, end ns, is CPU, is a user annotation))."""
    if name not in _CACHE:
        quiet = RUNS[name]()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = RUNS[name]()
        events = sorted(
            ((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
              ev.device_type() == torch.autograd.DeviceType.CPU,
              ev.is_user_annotation())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("maus.")), key=lambda e: e[1])
        _CACHE[name] = (quiet, traced, events)
    return _CACHE[name]


def _spans(events, name):
    return [(s, e) for n, s, e, _, _ in events if n == name]


def _inside(inner, outer) -> bool:
    return any(s <= inner[0] and inner[1] <= e for s, e in outer)


@pytest.mark.parametrize("run", list(RUNS))
def test_spans_are_cpu_operations_not_user_annotations(run):
    events = _traced(run)[2]
    assert events
    for name, _, _, on_cpu, annotation in events:
        assert on_cpu and not annotation, name


@pytest.mark.parametrize("run", list(RUNS))
def test_each_span_of_the_path_is_emitted(run):
    emitted = {e[0] for e in _traced(run)[2]}
    assert emitted == EXPECTED[run]


@pytest.mark.parametrize("run", list(RUNS))
def test_spans_nest_as_the_layers_do(run):
    events = _traced(run)[2]
    sp = {n: _spans(events, n) for n in {e[0] for e in events}}
    (engine,), (init,) = sp["maus.engine"], sp["maus.engine.init"]
    (setup,), (finish,) = sp["maus.setup"], sp["maus.finish"]
    assert setup[1] <= engine[0] and engine[1] <= finish[0]
    assert _inside(init, [engine])
    for it in sp["maus.engine.iteration"]:
        assert _inside(it, [engine]) and init[1] <= it[0]
    for entry in sp["maus.entry"]:
        assert entry[1] <= setup[0]
    for probe in sp.get("maus.diagnose.cond", []):
        assert _inside(probe, sp["maus.entry"])
    for stage in PROBE - {"maus.diagnose.cond"}:
        for s in sp.get(stage, []):
            assert _inside(s, sp["maus.diagnose.cond"])
    for step in sp.get("maus.refine.step", []):
        assert _inside(step, [finish])
    for fac in sp.get("maus.factor", []):
        assert _inside(fac, [init] + sp["maus.engine.iteration"] + [finish])
    for qr in sp.get("maus.factor.implicit_q", []):
        assert _inside(qr, sp["maus.factor"])
    for panel in sp.get("maus.hessenberg.panel", []):
        assert _inside(panel, [setup])
    for rnd in sp.get("maus.refine_eig.round", []) + sp.get("maus.eig.straggler", []) \
            + sp.get("maus.refine_svd.round", []):
        assert _inside(rnd, [finish])
    for solve in sp.get("maus.refine_eig.solve", []):
        assert _inside(solve, sp.get("maus.refine_eig.round", [])
                       + sp.get("maus.refine_svd.round", []))
    for rnd in sp.get("maus.svd.block_round", []):
        assert _inside(rnd, sp["maus.engine.iteration"])
    for capped in sp.get("maus.engine.capped", []):
        assert _inside(capped, [engine])
        assert capped[0] >= max(e for _, e in sp["maus.engine.iteration"])


@pytest.mark.parametrize("run", list(RUNS))
def test_iteration_spans_count_the_iterations(run):
    _, report, events = _traced(run)
    assert len(_spans(events, "maus.engine.iteration")) == report.iterations >= 1
    assert len(_spans(events, "maus.engine.init")) == 1
    if run in LINEAR:
        # every shared factorization, on the CPU too, is the one QR form
        assert len(_spans(events, "maus.factor")) == \
            len(_spans(events, "maus.factor.implicit_q")) >= 1
        assert len(_spans(events, "maus.refine.step")) >= 1
    if run == "update_problem":
        assert len(_spans(events, "maus.entry")) == 2
    if run == "eig_panels":
        # (160 − 2) // 64 = 2 panels, the 30 reflectors past them one by one
        assert len(_spans(events, "maus.hessenberg.panel")) == 2
    if run in ("eig", "eig_panels", "eig_hermitian"):
        assert len(_spans(events, "maus.refine_eig.round")) >= 1
        assert not _spans(events, "maus.eig.straggler")
        # a finisher call reads its factors 14 times: 2 rounds of 2
        # pre-sweeps and 5 Newton steps, each step's two columns in one solve
        assert len(_spans(events, "maus.refine_eig.solve")) == \
            14 * len(_spans(events, "maus.refine_eig.round"))
    if run in ("svd", "svd_chunks"):
        # one block round an iteration; a triplet finisher call reads its
        # factors 7 times: 2 pre-sweeps and 5 Newton steps
        assert len(_spans(events, "maus.svd.block_round")) == report.iterations
        assert len(_spans(events, "maus.refine_svd.round")) >= 1
        assert len(_spans(events, "maus.refine_eig.solve")) == \
            7 * len(_spans(events, "maus.refine_svd.round"))


@pytest.mark.parametrize("run", list(RUNS))
def test_answers_bit_equal_with_and_without_the_profiler(run):
    quiet, traced, _ = _traced(run)
    assert quiet.iterations == traced.iterations
    assert quiet.residuals == traced.residuals
    assert len(quiet.solutions) == len(traced.solutions) >= 1
    for a, b in zip(quiet.solutions, traced.solutions):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("run", list(RUNS))
def test_spans_lists_every_name_emitted(run):
    named = {name for name, _ in metrics.SPANS}
    assert {e[0] for e in _traced(run)[2]} <= named
    assert all(doc and "\n" not in doc for _, doc in metrics.SPANS)


def _names(run):
    """The ``maus.*`` spans that ``run()`` opens, in time order, and its
    report."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        report = run()
    events = sorted((ev.start_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith("maus."))
    return [n for _, n in events], report


def test_svd_finisher_opens_one_round_span_a_chunk(monkeypatch):
    """``maus.refine_svd.round`` is one ``refine_svd_triplets`` call over a
    chunk of at most 8 leaders; more leaders than a chunk take several."""
    import maus_tpu_torch.solver.api as api

    chunks, call = [], api.refine_svd_triplets

    def counted(A64, sig0, *args, **kw):
        chunks.append(int(sig0.shape[0]))
        return call(A64, sig0, *args, **kw)

    monkeypatch.setattr(api, "refine_svd_triplets", counted)
    names, report = _names(_svd_chunks)
    assert names.count("maus.refine_svd.round") == len(chunks) >= 2
    assert max(chunks) == 8 and sum(chunks) >= len(report.solutions)


def _solve_capped(iters):
    A, b = _linear_operands()
    return maus.solve(A, b, tol=1e-8, num_candidates=8, max_iterations=iters,
                      config=_linear_config(), device="cpu")


def _eig_capped(iters):
    E = torch.as_tensor(gen.laplace_like_complex(8, make_hermitian=False)).to(C64)
    cfg = maus.SolverConfig(dtype=C64, convergence_floor=eig_convergence_floor(C64, 8))
    return maus.eig(E, tol=1e-7, num_candidates=30, max_iterations=iters, config=cfg,
                    device="cpu")


def _svd_capped_chunked(tmp_path):
    return _svd(max_iterations=2, checkpoint_every=1,
                checkpoint_path=str(tmp_path / "svd.ckpt"))


# (run, whether its stop condition is unmet at max_iterations)
CAPPED = {"svd_cut": (lambda tmp: _svd(max_iterations=2), True),
          "svd_cut_in_chunks": (_svd_capped_chunked, True),
          "svd_met": (lambda tmp: _svd(max_iterations=50), False),
          "linear_cut": (lambda tmp: _solve_capped(1), True),
          "linear_met": (lambda tmp: _solve_capped(100), False),
          "eig_cut": (lambda tmp: _eig_capped(1), True),
          "eig_met": (lambda tmp: _eig_capped(200), False)}


@pytest.mark.parametrize("case", list(CAPPED))
def test_capped_counts_an_evolve_cut_by_max_iterations_once(tmp_path, case):
    run, cut = CAPPED[case]
    names, report = _names(lambda: run(tmp_path))
    assert names.count("maus.engine.capped") == (1 if cut else 0)
    assert names.count("maus.engine.iteration") == report.iterations
    if cut:
        assert names[-1] != "maus.engine.capped"
        assert names.index("maus.engine.capped") > max(
            i for i, n in enumerate(names) if n == "maus.engine.iteration")


def test_probe_opens_the_rinv_span_in_its_rinv_form_only():
    """The probe's QR builds the R⁻¹ that all its solves go through, in one
    declared span ``maus.diagnose.cond.rinv`` inside
    ``maus.diagnose.cond.qr``, before the inverse iteration. The probe never
    opens the engine's ``maus.factor`` or ``maus.factor.implicit_q``."""
    from maus_tpu_torch.solver import diagnose

    A, _ = _linear_operands()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("maus.diagnose.cond"):
            diagnose._cond_probe_device(A)
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("maus.")]
    sp = {n: [(s, e) for m, s, e in events if m == n] for n, _, _ in events}
    assert "maus.diagnose.cond.rinv" in {n for n, _ in metrics.SPANS}
    assert "maus.factor" not in sp and "maus.factor.implicit_q" not in sp
    rinv = sp.get("maus.diagnose.cond.rinv", [])
    assert len(rinv) == len(sp["maus.diagnose.cond.qr"]) == 1
    for s, e in rinv:
        assert _inside((s, e), sp["maus.diagnose.cond"])
        assert _inside((s, e), sp["maus.diagnose.cond.qr"])
        assert e <= sp["maus.diagnose.cond.inverse"][0][0]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    first = metrics.span("maus.engine")
    assert first is metrics.span("maus.factor")
    with first:
        pass


def test_span_without_the_fast_record_is_a_no_op_with_one_warning(monkeypatch, caplog):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    metrics._fast_record.cache_clear()
    try:
        with caplog.at_level(logging.WARNING, logger="maus_tpu_torch"), \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with metrics.span("maus.engine"):
                    torch.ones(2).sum()
    finally:
        metrics._fast_record.cache_clear()
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.startswith("maus.")}
    assert len([r for r in caplog.records if "_RecordFunctionFast" in r.message]) == 1
