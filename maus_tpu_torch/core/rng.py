"""Per-candidate random streams.

Counterpart of ``maus_tpu/core/rng.py``. Each candidate slot carries its own
stream, so re-initializing one slot never perturbs the others and a run
replays exactly from its seed. A slot's stream is a (seed, counter) pair in
``Population.keys``; a draw seeds a ``torch.Generator`` on the population's
device from the pair, and the counter then advances. The draws are not
threefry's, so they differ from the JAX package's; tests that compare the two
packages inject the state instead of drawing it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def make_candidate_keys(seed: int, capacity: int, device=None) -> torch.Tensor:
    """One independent (seed, counter=0) pair per slot, from one base seed."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(capacity, np.uint64)
    keys = np.zeros((capacity, 2), np.int64)
    keys[:, 0] = (seeds >> np.uint64(1)).astype(np.int64)   # non-negative int64
    return torch.from_numpy(keys).to(device)


def advance(keys: torch.Tensor) -> torch.Tensor:
    """Move every slot's stream to its next draw (the ``split`` of JAX keys)."""
    out = keys.clone()
    out[:, 1] += 1
    return out


def _generator(seed: int, counter: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_splitmix64(_splitmix64(seed) ^ counter) >> 1)
    return g


def normal_rows(keys: torch.Tensor, rows, n: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Zero-mean, unit-variance complex normal vectors of length ``n``, one
    per slot index in ``rows``, each drawn from that slot's own stream.
    Zero-mean init keeps the population diverse (the reference's U[0,1] init
    collapses it)."""
    pairs = keys.cpu().tolist()
    rdt = dtype.to_real()
    out = []
    for k in rows:
        g = _generator(pairs[k][0], pairs[k][1], device)
        re = torch.randn(n, generator=g, dtype=rdt, device=device)
        im = torch.randn(n, generator=g, dtype=rdt, device=device)
        out.append(torch.complex(re, im) / math.sqrt(2.0))
    return torch.stack(out)
