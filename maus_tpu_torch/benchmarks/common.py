"""What the measuring programs share: the device they run on and its record,
the clocks, peak memory, the seeded operands and the bound arithmetic.

Counterpart of the helpers that ``bench.py`` and ``benchmarks/`` keep beside
each JAX program (``bench.py:_device_problem``, ``mfu.py``'s fences and chip
peaks, ``spectral_large_probe.py``'s operands). ``chip_smoke.py`` builds its
operands and bounds from here too, so a program and the smoke measure the
same inputs the same way.

Device rule: every program runs on the CUDA card unless its caller asks for
the CPU (``device="cpu"``, the CLI's ``--cpu``); without a card and without
that request :func:`resolve_device` raises. Nothing falls back.
"""
from __future__ import annotations

import argparse
import math
import os
import platform
import statistics
import subprocess
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit):
# HBM rate; FP64 and FP32 outside the tensor cores; the TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# the unit that does a row's operations: (name, peak operations a second).
# Split-TF32 products (K3, and P4 through it) take three tensor-core passes
# for each product they deliver.
UNITS = {
    "fp64": ("FP64, CUDA cores", FP64_FLOPS),
    "fp32": ("FP32, CUDA cores", FP32_FLOPS),
    "tf32x3": ("TF32 tensor cores, 3 passes a product", TF32_FLOPS / 3),
}


def resolve_device(device=None) -> torch.device:
    """``device`` as given; without one, the card. No card and no request
    for the CPU raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the measuring programs run on a CUDA card and none "
                           "is available; pass device='cpu' (the CLI's --cpu) "
                           "to run on the CPU")
    return torch.device("cuda")


def arg_parser(module: str) -> argparse.ArgumentParser:
    """A program's parser, with ``--cpu``: the command line's request for
    the CPU (``main(argv, device="cpu")`` from Python)."""
    ap = argparse.ArgumentParser(prog=f"python -m maus_tpu_torch.benchmarks.{module}")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap


def run_device(args, device=None) -> torch.device:
    """The device of a program's run: the CPU on ``--cpu``, else
    :func:`resolve_device` of the caller's ``device``."""
    return resolve_device("cpu" if args.cpu else device)


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def host_cpu() -> str:
    """The host CPU's model name (its architecture where the system does
    not say) and its logical core count."""
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if name in (None, "", "unknown"):
        proc = platform.processor()
        name = proc if proc not in ("", "unknown") else platform.machine()
    return f"{name}, {os.cpu_count()} logical cores"


def device_record(device: torch.device) -> dict:
    """What every output line says of the device it ran on: on the card
    ``torch.cuda.get_device_name``, the device count and nvidia-smi's power
    limit; on the CPU the host's model."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count(),
                "power_limit": card_line().split(",")[-1].strip()}
    return {"platform": "cpu", "kind": host_cpu(), "count": 1, "power_limit": None}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_seconds(fn, device: torch.device):
    """``(fn(), seconds)`` on the host clock, ending in a synchronise of
    the card."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


class Stamps:
    """Marks between the phases of one run: CUDA events on the card (the
    device's own clock, read after one synchronise), the host clock on the
    CPU. ``seconds()`` gives the intervals between consecutive marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def time_ms(fn, reps: int = 20, device="cuda") -> float:
    """Median time of ``reps`` synchronised calls after one warm-up. On the
    card: CUDA events, with the card kept busy for about a millisecond
    before each call (``torch.cuda._sleep``), so that the host's launch
    overhead is spent while the card is busy and the events bracket device
    work only. On the CPU: the host clock."""
    device = torch.device(device)
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device):
    """Peak device memory since :func:`reset_peak`, GiB; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from ..ops.kernels import cgemm, hess_solve, lu, residual

    return {"K1": residual.LAUNCHES, "K2": hess_solve.LAUNCHES,
            "K3": cgemm.LAUNCHES, "P3": lu.CLUSTER_PANEL_LAUNCHES + lu.PANEL_LAUNCHES,
            "P4": lu.LAUNCHES}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


# ---------------------------------------------------------------------------
# Operands, from a seeded torch.Generator on the run's device
# ---------------------------------------------------------------------------

def cnormal(gen, shape, dtype, device):
    """Standard complex normal entries (unit variance per plane) drawn from
    ``gen``."""
    rdt = dtype.to_real()
    return torch.complex(torch.randn(*shape, generator=gen, dtype=rdt, device=device),
                         torch.randn(*shape, generator=gen, dtype=rdt, device=device))


def make_system(n, cond, seed, device):
    """A = Q₁·diag(logspace(0, −log10 κ))·Q₂ᴴ with Haar Q₁, Q₂, and a random
    b, built in complex64 from a seeded torch.Generator: the JAX bench's
    operand (``bench.py:_device_problem``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def haar():
        q, r = torch.linalg.qr(cnormal(g, (n, n), torch.complex64, device))
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    q1 = haar()
    q2 = haar()
    s = torch.logspace(0.0, -math.log10(cond), n,
                       dtype=torch.float32, device=device).to(torch.complex64)
    A = (q1 * s[None, :]) @ q2.mH
    del q1, q2
    return A.contiguous(), cnormal(g, (n,), torch.complex64, device)


def eig_operand(n, seed, device):
    """A = (G₁ + iG₂)/√N with G₁, G₂ standard normal, complex64: the JAX
    package's general eig probe operand
    (``benchmarks/spectral_large_probe.py``, ``_device_operand``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    re = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    im = torch.randn(n, n, generator=g, dtype=torch.float32, device=device)
    return (torch.complex(re, im) / math.sqrt(n)).contiguous()


def hermitian_operand(n, seed, device):
    """A = (G + Gᴴ)/2 with G = :func:`eig_operand`, complex64: the JAX
    package's Hermitian eig probe operand (``_device_operand``, kind
    hermitian)."""
    G = eig_operand(n, seed, device)
    return ((G + G.mH) / 2).contiguous()


def svd_operand(m, n, top, seed, device):
    """A = U·diag(σ)·Vᴴ with U (m×n) and V (n×n) Haar (QR of complex
    Gaussians with the phases of R's diagonal fixed), σ = 0.8^k for k < top
    and logspace(−2, −4) for the rest: the JAX package's SVD probe operand
    (``spectral_large_probe.py``, ``_svd_operand``). Built in complex128, so
    that σ is known to FP64; a solver runs on its complex64 working copy.
    Returns (A, σ)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def haar(rows, cols):
        q, r = torch.linalg.qr(cnormal(g, (rows, cols), torch.complex128, device))
        d = torch.diagonal(r)
        return q * (d / d.abs())[None, :]

    U = haar(m, n)
    V = haar(n, n)
    sig = torch.cat([0.8 ** torch.arange(top, dtype=torch.float64, device=device),
                     torch.logspace(-2.0, -4.0, n - top, dtype=torch.float64,
                                    device=device)])
    A = (U * sig[None, :]) @ V.mH
    del U, V
    return A.contiguous(), sig


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a function's work
# ---------------------------------------------------------------------------

def bound_ms(nbytes, flops, peak_flops):
    """The larger of the work's bytes over the HBM rate and its operations
    over ``peak_flops``, in ms; and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(m: int, n: int, a_dtype: torch.dtype):
    """K1, r = b − A·x in FP64 (A in its own dtype, x and b complex128):
    A read once, x and b read once, r written once; 8 operations a complex
    multiply-add of A's entries."""
    a_bytes = m * n * torch.empty((), dtype=a_dtype).element_size()
    return a_bytes + (n + 2 * m) * 16, 8 * m * n


def k2_work(K: int, N: int):
    """K2, (H + s_k I) w_k = b_k for K shifts of one upper-Hessenberg N×N H
    (complex64): H's upper Hessenberg part, the shifts and B read once, W
    written once; ~14·N² operations a candidate (10·N² in the sweep, 4·N² in
    the back substitution)."""
    return (N * (N + 1) // 2 + N - 1 + K + 2 * K * N) * 8, 14 * K * N ** 2


def peaks(device_rec: dict) -> dict:
    """The published rates the bounds use, beside the card's own power limit
    (they hold at 700 W; a card set lower runs slower under load)."""
    return {"source": "NVIDIA H100 SXM data sheet, dense, at 700 W",
            "power_limit": device_rec.get("power_limit"),
            "hbm_tb_s": HBM_BYTES_PER_S / 1e12, "fp64_tflops": FP64_FLOPS / 1e12,
            "fp32_tflops": FP32_FLOPS / 1e12, "tf32_tflops": TF32_FLOPS / 1e12}
