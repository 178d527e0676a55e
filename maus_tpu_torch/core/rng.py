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


def _generator(seed: int, counter: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one slot's draw: ``stream`` tells apart the
    independent draws a slot makes at the same counter (the JAX package
    splits the slot's key once per draw)."""
    z = _splitmix64(_splitmix64(seed) ^ counter)
    if stream:
        z = _splitmix64(z ^ stream)
    g = torch.Generator(device=device)
    g.manual_seed(z >> 1)
    return g


def _per_row(keys: torch.Tensor, rows, device, stream: int, draw):
    pairs = keys.cpu().tolist()
    return torch.stack([draw(_generator(pairs[k][0], pairs[k][1], device, stream))
                        for k in rows])


def normal_rows(keys: torch.Tensor, rows, n: int, dtype: torch.dtype,
                device, stream: int = 0) -> torch.Tensor:
    """Zero-mean, unit-variance complex normal vectors of length ``n``, one
    per slot index in ``rows``, each drawn from that slot's own stream.
    Zero-mean init keeps the population diverse (the reference's U[0,1] init
    collapses it)."""
    rdt = dtype.to_real()

    def draw(g):
        re = torch.randn(n, generator=g, dtype=rdt, device=device)
        im = torch.randn(n, generator=g, dtype=rdt, device=device)
        return torch.complex(re, im) / math.sqrt(2.0)

    return _per_row(keys, rows, device, stream, draw)


def normal_scalars(keys: torch.Tensor, rows, dtype: torch.dtype, device,
                   stream: int = 0) -> torch.Tensor:
    """One zero-mean, unit-variance complex normal per slot index in
    ``rows``, from that slot's own stream: shape (len(rows),)."""
    return normal_rows(keys, rows, 1, dtype, device, stream)[:, 0]


def categorical(keys: torch.Tensor, rows, logits: torch.Tensor,
                stream: int = 0) -> torch.Tensor:
    """One index per slot index in ``rows``, drawn with probabilities
    softmax(``logits``) (a -inf logit is never drawn), from that slot's own
    stream: int64 of shape (len(rows),). At least one logit must be finite."""
    device = logits.device
    cdf = torch.cumsum(torch.softmax(logits.double(), dim=0), dim=0)
    u = _per_row(keys, rows, device, stream,
                 lambda g: torch.rand(1, generator=g, dtype=torch.float64,
                                      device=device))[:, 0] * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp_max(idx, logits.shape[0] - 1)
