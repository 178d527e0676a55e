"""Structured metrics and logging.

Counterpart of ``maus_tpu/utils/metrics.py``. The evolve loop returns its
per-iteration metrics as stacked arrays (``SolutionReport.metrics`` with
``collect_metrics=True``; the names of the JAX package's ``Metrics``); this
module is the host side: a JSONL sink, a stdlib-logging setup under the
``maus_tpu_torch`` logger, a wall-clock scope timer, a device profile
of a scope through ``torch.profiler``, written as a Chrome trace, and the
named spans (:func:`span`, :data:`SPANS`) that the solver opens at its layer
boundaries, which that trace shows.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from contextlib import contextmanager
from typing import IO, Optional

import numpy as np
import torch

logger = logging.getLogger("maus_tpu_torch")


def configure_logging(level: int = logging.INFO) -> None:
    """Standard logging setup (replaces the reference's prints)."""
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s "
                                     "%(message)s"))
    logger.handlers[:] = [h]
    logger.setLevel(level)


class MetricsSink:
    """Append-only JSONL metrics writer, to a path (opened and closed here)
    or to an open file."""

    def __init__(self, path_or_file):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self._f: IO = open(path_or_file, "a") if self._own else path_or_file

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=_jsonify) + "\n")
        self._f.flush()

    def write_trace(self, metrics: dict, prefix: Optional[dict] = None) -> int:
        """One record per iteration from ``SolutionReport.metrics`` (a dict
        of stacked numpy arrays); returns the record count."""
        fields = list(metrics)
        n = len(metrics[fields[0]]) if fields else 0
        for i in range(n):
            rec = dict(prefix or {})
            rec["iteration"] = i
            rec.update({f: metrics[f][i] for f in fields})
            self.write(rec)
        return n

    def close(self):
        if self._own:
            self._f.close()


def _jsonify(x):
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, (np.complexfloating, complex)):
        return [float(x.real), float(x.imag)]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


@contextmanager
def timed(name: str, sink: Optional[MetricsSink] = None):
    """Wall-clock scope timer; logs and optionally records the duration."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    logger.info("%s: %.4fs", name, dt)
    if sink is not None:
        sink.write({"timer": name, "seconds": dt})


@contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed scope with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto); the solver's
    spans (:data:`SPANS`) appear in it as CPU operations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: Every span the solver opens, with what it covers. A span that ends where
#: the host already waits for the device (a synchronisation or a host read)
#: holds its device work; the others cover the enqueueing alone and serve to
#: name the device's idle gaps.
SPANS = (
    ("maus.entry", "staging, diagnosis and configuration in MausSolver's "
     "constructor, and update_problem's re-staging; ends at the last "
     "finiteness read"),
    ("maus.diagnose.cond", "the on-device condition probe, through its host "
     "read"),
    ("maus.diagnose.cond.power", "the probe's power iteration (enqueue only)"),
    ("maus.diagnose.cond.qr", "the probe's working-dtype QR, "
     "ops/batched_solve.factor_qr (enqueue only)"),
    ("maus.diagnose.cond.rinv", "the same QR, inside maus.diagnose.cond.qr: "
     "it builds the R⁻¹ that every probe solve goes through (a count, once "
     "a probe)"),
    ("maus.diagnose.cond.inverse", "the probe's inverse iteration with its "
     "refinement solves (enqueue only)"),
    ("maus.setup", "evolve's shared Hessenberg form or eigh "
     "(timings['setup_s'])"),
    ("maus.hessenberg.panel", "one compact-WY panel of the blocked "
     "Hessenberg reduction (enqueue only)"),
    ("maus.engine", "evolve's engine phase (timings['engine_s'])"),
    ("maus.engine.init", "the step, the carry (population, first Psi, the "
     "shared factorization) and the first stop check"),
    ("maus.engine.iteration", "one step and the stop check after it"),
    ("maus.engine.capped", "once an evolve (MausSolver.evolve, the mesh paths' "
     "drive) whose iterations reached max_iterations with its stop condition "
     "unmet (a count)"),
    ("maus.svd.block_round", "one block round of the SVD step: the thin QR of "
     "A·Vᵀ, the projection, the thin QR of its adjoint, the small SVD and the "
     "Ritz products (enqueue, but torch.linalg.svd waits for a card's work)"),
    ("maus.factor", "one shared factorization of the linear path: the "
     "engine's at init and on a Psi rung, or refinement's fresh QR (enqueue "
     "only)"),
    ("maus.factor.implicit_q", "the QR of one shared factorization, inside "
     "maus.factor: geqrf in place, R⁻¹ from its upper triangle, the blocks' "
     "compact-WY factors; every QR of the engine and of refinement keeps Q "
     "implicit (a count, enqueue only)"),
    ("maus.finish", "evolve's finish phase: leaders, finishers, host copies "
     "(timings['finish_s'])"),
    ("maus.refine.step", "one correction solve of plain refinement, through "
     "its residual norm's host read"),
    ("maus.refine.gmres", "the GMRES-IR fallback of linear refinement"),
    ("maus.refine_eig.round", "one eigenpair finisher call over a chunk of "
     "leaders (a batched LU, Newton steps), through its host read"),
    ("maus.refine_svd.round", "one SVD triplet finisher call over a chunk of "
     "leaders (the Gram's batched LU, Newton steps), through its host read"),
    ("maus.refine_eig.solve", "one solve of a finisher (eigenpairs or "
     "triplets) against its chunk's LU factors, one or two columns in one "
     "read of the factors (a count, enqueue only)"),
    ("maus.eig.straggler", "one leader that the working-dtype finisher "
     "rounds left above tol, taken on by the complex128 round (a count)"),
)

_NULL_SPAN = contextlib.nullcontext()


@functools.cache
def _fast_record():
    """torch's ``_RecordFunctionFast``, or None (with one warning) where the
    installed torch lacks it."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        logger.warning("torch %s has no _RecordFunctionFast; the solver's spans "
                       "are not recorded", torch.__version__)
    return fast


def span(name: str):
    """A named span around the enclosed scope while a ``torch.profiler``
    runs: a plain CPU operation on the profiler's clock
    (``_RecordFunctionFast``), so that no device-side event of the name is
    made, as ``record_function``'s user annotations make one. With no
    profiler running it is one shared null context: nothing is allocated,
    recorded or synchronised. ``name`` is one of :data:`SPANS`."""
    if not torch.autograd._profiler_enabled():
        return _NULL_SPAN
    fast = _fast_record()
    return _NULL_SPAN if fast is None else fast(name)
