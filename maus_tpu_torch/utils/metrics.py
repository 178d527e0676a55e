"""Structured metrics and logging.

Counterpart of ``maus_tpu/utils/metrics.py``. The evolve loop returns its
per-iteration metrics as stacked arrays (``SolutionReport.metrics`` with
``collect_metrics=True``; the names of the JAX package's ``Metrics``); this
module is the host side: a JSONL sink, a stdlib-logging setup under the
``maus_tpu_torch`` logger, a wall-clock scope timer, and a device profile
of a scope through ``torch.profiler``, written as a Chrome trace.
"""
from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from typing import IO, Optional

import numpy as np

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
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
