"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name under ``port_bench/``: its
configuration in the file its ``configs`` entry names, its traffic mix in
``traffic/<mix>.json`` with the input kind and the call that the mix names
(``mix.py``), the reference that the configuration names, and each of its
metrics in ``metrics/<metric>.py`` (a module whose ``read(run)`` returns the
number, or None). A cell, a configuration, a mix, an input kind, a call, a
reference or a metric is added with new files and entries alone.

The loop is closed, with one caller: requests run back to back, each made
(operand, b) before its clock starts and timed on the host clock from the
call to a synchronise after it. The window runs ``--seconds``; the request
in flight when they run out is finished, and the window closes at its end.
Set-up, timed as ``setup_s`` from the start of the process, builds the
kernels (the first run in a checkout compiles them into
``maus_tpu_torch/_build/``), the operand pool, and serves one request of
the cell's shapes. With ``--trace 1`` the profiler starts ``TRACE_SECONDS``
before the window's end and watches the requests from there for at least
``TRACE_SECONDS`` after its own start, the window running on if need be,
and those requests' calls of the kernels the readers name; the result then carries the per-layer metrics in place of the
end-to-end ones. The traced requests are the last of the window, so that
the profiler's cost, which lingers after it stops, stays out of the
untraced ones.

After the window, with the program's state freed, every answer is judged by
the plain reference (``check.py``). The last line of stdout is one JSON
object; the numbers compared, each beside its limit, end stderr and the
object. Exit 0 with a result; without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, non-zero and no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

from . import check, mix as mix_mod
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "maus_tpu")
ROOT = Path(__file__).resolve().parent.parent
TRACE_SECONDS = 5.0


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell and its files, the set-up and
    window seconds, one record per request, and the trace (None without
    ``--trace 1``)."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    records: list
    trace: object = None


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, whatever
    the environment says (the program's own kernels build into
    ``maus_tpu_torch/_build/``, also inside it)."""
    base = root / ".port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")
    os.environ["USE_FLAX"] = "0"


def load_cell(root: Path, workload: str):
    """(benchmark, cell, configuration, traffic mix) of ``workload``, each as
    read from its file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "port_bench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (a per-layer metric without ``workloads``
    goes to every cell that reports the end-to-end metric it moves)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def load_reader(root: Path, metric: str):
    return mix_mod.load_module(root, f"port_bench/metrics/{metric}.py")


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _summary(report) -> dict:
    return {"timings": dict(report.timings or {}), "iterations": int(report.iterations)}


def _finite(x: float) -> float:
    """JSON has no infinity: the largest double stands for it."""
    return x if math.isfinite(x) else math.copysign(sys.float_info.max, x)


def _start_trace(torch, cuda: bool, readers: dict):
    """A running profiler, and a call recorder on every function that the
    cell's readers name in their ``CALLS``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    recorder = trace_mod.CallRecorder(
        [c for mod in readers.values() for c in getattr(mod, "CALLS", ())])
    prof.__enter__()
    recorder.__enter__()
    return prof, recorder


def _reduce_trace(prof, recorder):
    """The reduced trace of a stopped profiler."""
    t = time.perf_counter()
    trace = trace_mod.Trace.from_profiler(prof, recorder.calls)
    print(f"trace: {len(trace.device_ops)} device and {len(trace.host_ops)} host "
          f"operations over {trace.window_s:.3f} s, reduced in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    return trace


def main(argv=None, t0: float | None = None, root=None, device=None,
         control: bool = False) -> int:
    """One run; the exit code. ``device`` (tests only) skips the look for a
    card and runs where it says; ``control`` serves every request on the
    program's lower-precision path (``mix.Mix.serve``)."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m port_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = ROOT if root is None else Path(root)
    bench, cell, config, traffic = load_cell(root, args.workload)
    cache_env(root)
    metrics = cell_metrics(bench, cell, bool(args.trace))
    readers = {m["name"]: load_reader(root, m["name"]) for m in metrics}

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"port_bench: the cell needs {cell['chips']} CUDA card(s); "
                  f"{found} found", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    cuda = device.type == "cuda"
    import maus_tpu_torch  # noqa: F401  (the program; without it there is no run)

    mix = mix_mod.Mix(root, config, traffic, args.seed, device)
    mix.setup()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def serve(i: int, traced: bool) -> dict:
        req = mix.request(i)
        sync()
        base = torch.cuda.memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        span = torch.profiler.record_function(trace_mod.REQUEST_SPAN) if traced \
            else contextlib.nullcontext()
        ts = time.perf_counter()
        report, answer = None, None
        try:
            with span:
                report = mix.serve(req, control=control)
                sync()
        except Exception:                    # a request that raises is a failed one
            traceback.print_exc(file=sys.stderr)
        latency = time.perf_counter() - ts
        peak = torch.cuda.max_memory_allocated(device) - base if cuda else 0
        if report is not None:
            answer = mix.answer(report)
        rec = {"index": i, "latency_s": latency, "traced": traced, "peak_bytes": peak,
               "failed": report is None or not mix.reached_target(report),
               "report": None if report is None else _summary(report),
               "answer": answer, "fingerprint": req.fingerprint}
        del req, report
        return rec

    process_peak = 0
    warm = serve(-1, False)                  # every kernel and shape of the mix
    if warm["report"] is None:
        print("port_bench: the warm-up request raised; no result", file=sys.stderr)
        return 4
    if cuda:
        process_peak = torch.cuda.max_memory_allocated(device)
    setup_s = time.perf_counter() - t0
    del warm

    records, prof, recorder, trace = [], None, None, None
    trace_s = min(TRACE_SECONDS, args.seconds)
    w0 = time.perf_counter()
    i = 0
    while True:
        if args.trace and prof is None and time.perf_counter() - w0 >= args.seconds - trace_s:
            prof, recorder = _start_trace(torch, cuda, readers)
            t0_trace = time.perf_counter()
        records.append(serve(i, prof is not None))
        if cuda:
            process_peak = max(process_peak, torch.cuda.max_memory_allocated(device))
        i += 1
        now = time.perf_counter()
        if now - w0 >= args.seconds and (prof is None or now - t0_trace >= trace_s):
            break
    window_s = time.perf_counter() - w0
    if prof is not None:
        recorder.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        trace = _reduce_trace(prof, recorder)
        del prof

    lat = sorted(r["latency_s"] for r in records)
    print(f"setup {setup_s:.3f} s; window {window_s:.3f} s, {len(records)} requests, "
          f"latency min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s",
          file=sys.stderr)
    run = Run(cell, config, traffic, setup_s, window_s, records, trace)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if cuda:
        torch.cuda.empty_cache()
    checks = check.judge(mix, records)
    correct = check.passed(checks) and len(records) > 0

    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]) if cuda else 1,
           "memory_peak_bytes": int(process_peak)}
    line = {"correct": bool(correct), "attempted": len(records),
            "failed": sum(1 for r in records if r["failed"]),
            "metrics": values, "device": dev}
    if args.trace and trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
