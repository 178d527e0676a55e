"""The window, percentile, idle-share and roofline arithmetic on synthetic
inputs, and the frozen work counts against the bounds PERF.md's kernel table
gives."""
from __future__ import annotations

import pytest
import torch

from port_bench import readers, trace, work
from port_bench.run import Run

MS = 1_000_000   # ns


def _run(records, window_s=10.0, tr=None):
    return Run({}, {}, {}, 1.0, window_s, records, tr)


def _rec(latency, failed=False, traced=False, timings=None, iterations=3):
    return {"latency_s": latency, "failed": failed, "traced": traced, "peak_bytes": 0,
            "report": {"timings": timings or {"setup_s": 0.1, "engine_s": 0.2,
                                              "finish_s": 0.3},
                       "iterations": iterations}}


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert readers.percentile(vals, 95) == 95
    assert readers.percentile([5.0], 95) == 5.0
    assert readers.percentile(list(range(1, 21)), 95) == 19
    assert readers.percentile([], 95) is None


def test_seconds_per_answer_counts_completed_answers_only():
    run = _run([_rec(1.0), _rec(2.0, failed=True), _rec(1.0)], window_s=6.0)
    assert readers.seconds_per_answer(run) == 3.0
    assert readers.seconds_per_answer(_run([_rec(1.0, failed=True)])) is None


def test_means_leave_out_traced_requests():
    run = _run([_rec(1.0), _rec(3.0, traced=True, iterations=9)])
    assert readers.mean_entry(run) == pytest.approx(0.4)
    assert readers.mean_iterations(run) == 3
    assert readers.mean_timing(run, "engine_s") == pytest.approx(0.2)
    only_traced = _run([_rec(2.0, traced=True)])
    assert readers.mean_entry(only_traced) == pytest.approx(1.4)


def _trace(device, host=(), calls=None, start=0, end=100 * MS):
    return trace.Trace(sorted(device, key=lambda op: op[1]), sorted(host, key=lambda op: op[1]),
                       start, end, calls or {})


def test_busy_idle_and_gaps():
    tr = _trace([("k1", 10 * MS, 30 * MS), ("k2", 20 * MS, 40 * MS), ("k3", 60 * MS, 70 * MS)],
                host=[("aten::mm", 0, 12 * MS), ("aten::item", 41 * MS, 59 * MS)])
    assert tr.busy_s == pytest.approx(0.040)
    assert readers.device_idle(_run([], tr=tr)) == pytest.approx(60.0)
    gaps = dict(tr.idle_gaps())
    # [0,10) under aten::mm, [40,60) under aten::item, [70,100) under nothing
    assert gaps == pytest.approx({"aten::mm": 0.010, "aten::item": 0.020, "python": 0.030})
    assert tr.top_device_ops()[0] == ["k1", pytest.approx(0.020)]


def test_roofline_share_from_calls_and_kernel_time():
    call = {"A": trace.TensorArg((4096, 4096), torch.complex64)}
    nbytes, flops = work.k1_work(4096, 4096, torch.complex64)
    bound = work.bound_ms(nbytes, flops, work.FP64_FLOPS)[0] / 1e3
    tr = _trace([("void residual_c64(float2 const*)", 0, 80_000),
                 ("void residual_c64(float2 const*)", 100_000, 180_000),
                 ("other", 200_000, 900_000)],
                calls={"mod:fn": [call, call]})
    share = readers.roofline(_run([], tr=tr), ("residual_c64",), "mod:fn", lambda c: bound)
    assert share == pytest.approx(100 * 2 * bound / 160e-6)
    assert readers.roofline(_run([], tr=tr), ("absent",), "mod:fn", lambda c: bound) is None
    assert readers.roofline(_run([], tr=None), ("residual_c64",), "mod:fn", lambda c: bound) is None


def test_work_matches_the_kernel_table():
    k1 = work.bound_ms(*work.k1_work(4096, 4096, torch.complex64), work.FP64_FLOPS)
    assert k1[1] == "bytes" and k1[0] == pytest.approx(0.0401, abs=5e-5)
    k2 = work.bound_ms(*work.k2_work(32, 4096), work.FP32_FLOPS)
    assert k2[1] == "operations" and k2[0] == pytest.approx(0.112, abs=5e-4)
    p4 = work.bound_ms(*work.p4_work(8, 4096, torch.complex64), work.p4_peak(torch.complex64))
    assert p4[1] == "operations" and p4[0] == pytest.approx(8.885, abs=5e-3)


def test_kernel_name_drops_return_type_and_arguments():
    assert trace.kernel_name("void k<float, 8>(float2 const*, int)") == "k<float, 8>"
    assert trace.kernel_name("std::enable_if<!(a), void>::type g<int>(int)") \
        == "std::enable_if<!(a), void>::type g<int>"
    assert trace.kernel_name("(anonymous namespace)::h(int)") == "(anonymous namespace)::h"


def test_call_recorder_sees_shapes_however_imported():
    from port_bench.tests import _target

    fn = _target.solve_like
    with trace.CallRecorder(["port_bench.tests._target:solve_like",
                             "no.such.module:fn"]) as rec:
        fn(torch.zeros(3, 5), k=2)
        _target.solve_like(torch.zeros(1, dtype=torch.complex64))
    _target.solve_like(torch.zeros(7))
    got = rec.calls["port_bench.tests._target:solve_like"]
    assert [c["H"].shape for c in got] == [(3, 5), (1,)]
    assert got[0]["k"] == 2 and got[1]["H"].dtype == torch.complex64
    assert rec.calls["no.such.module:fn"] == []
