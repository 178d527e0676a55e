"""The traced part of a ``--trace 1`` window: a ``torch.profiler`` run over
whole requests, the shapes of the program's kernel calls made meanwhile,
and the reduction of both to what the per-layer readers and the result line
need.

Calls are seen with ``sys.monitoring`` on the code object of each function a
reader names (``"module:function"``), so a call is seen however its caller
imported it; only the argument shapes and dtypes are kept. A name that no
longer resolves is skipped, and its reader then finds nothing to read.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import sys

import torch

REQUEST_SPAN = "port_bench.request"


@dataclasses.dataclass(frozen=True)
class TensorArg:
    shape: tuple
    dtype: torch.dtype


def _describe(value):
    if isinstance(value, torch.Tensor):
        return TensorArg(tuple(value.shape), value.dtype)
    if isinstance(value, (int, float, bool, str)) or value is None:
        return value
    return type(value).__name__


class CallRecorder:
    """Records ``{argument: shape and dtype, or plain value}`` for each call of
    the named functions while it is entered."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.calls = {t: [] for t in self.targets}
        self._codes = {}
        self._tool = None

    def __enter__(self):
        mon = sys.monitoring
        for tool in range(6):
            if mon.get_tool(tool) is None:
                mon.use_tool_id(tool, "port_bench")
                self._tool = tool
                break
        if self._tool is None:
            return self
        for t in self.targets:
            mod, _, name = t.partition(":")
            try:
                fn = getattr(importlib.import_module(mod), name)
            except (ImportError, AttributeError):
                continue
            code = getattr(fn, "__code__", None)
            if code is not None:
                self._codes[code] = t
                mon.set_local_events(self._tool, code, mon.events.PY_START)
        mon.register_callback(self._tool, mon.events.PY_START, self._on_start)
        return self

    def _on_start(self, code, offset):
        target = self._codes.get(code)
        if target is not None:
            frame = sys._getframe(1)
            self.calls[target].append({k: _describe(v) for k, v in frame.f_locals.items()})

    def __exit__(self, *exc):
        if self._tool is None:
            return False
        mon = sys.monitoring
        for code in self._codes:
            mon.set_local_events(self._tool, code, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.free_tool_id(self._tool)
        self._tool = None
        return False


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def kernel_name(name: str) -> str:
    """A device operation's name without ``void`` and its argument list, at
    most 160 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    name = name[5:] if name.startswith("void ") else name
    return name[:160].rstrip()


@dataclasses.dataclass
class Trace:
    """The traced window's device operations ``(name, start_ns, end_ns)``,
    host operations (the same), the window's bounds, and the calls seen."""

    device_ops: list
    host_ops: list
    start_ns: int
    end_ns: int
    calls: dict

    @classmethod
    def from_profiler(cls, prof, calls: dict) -> "Trace":
        from torch.autograd import DeviceType

        device, host, spans = [], [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if name == REQUEST_SPAN:
                if ev.device_type() == DeviceType.CPU:
                    spans.append((start, end))
                continue
            if ev.device_type() == DeviceType.CUDA:
                device.append((name, start, end))
            elif ev.device_type() == DeviceType.CPU:
                host.append((name, start, end))
        if not spans:
            return cls([], [], 0, 0, calls)
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        device = sorted(((n, max(s, lo), min(e, hi)) for n, s, e in device
                         if e > lo and s < hi), key=lambda op: op[1])
        host.sort(key=lambda op: op[1])
        return cls(device, host, lo, hi, calls)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in time order."""
        merged = []
        for _, s, e in self.device_ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, names) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds one
        of ``names``."""
        secs, count = 0, 0
        for n, s, e in self.device_ops:
            if any(k in n for k in names):
                secs += e - s
                count += 1
        return secs / 1e9, count

    def top_device_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.device_ops:
            key = kernel_name(n)
            by[key] = by.get(key, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the window, summed by the innermost host
        operation running at each gap's midpoint (``python`` where none ran:
        the interpreter between operations)."""
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        starts = [op[1] for op in self.host_ops]
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            label = "python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4096, -1), -1):
                if self.host_ops[j][2] >= mid:
                    label = self.host_ops[j][0]
                    break
            by[label] = by.get(label, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
