"""Communication budget of the mesh paths, counted as they run.

Counterpart of ``maus_tpu/utils/comm_budget.py``. The JAX version walks a
traced jaxpr and multiplies loop bodies by their trip counts
(``collective_volume(fn, *args, while_bound=)``); the port's collectives
are eager calls through ``parallel/comm.py``, each of which counts its own
bytes, so :func:`collective_volume` runs ``fn`` under a counting context and
returns the same kind of dict: per-rank bytes by collective kind
(``all_reduce``, ``broadcast``) plus their ``"total"``. A loop that ends
early is counted as far as it ran; the JAX ``while_bound`` is the most it
could run.
"""
from __future__ import annotations

from ..parallel import comm


def collective_volume(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on this rank and return the bytes its
    collectives moved, by kind (kinds that did not occur are left out), and
    their ``"total"``."""
    with comm.counting() as counts:
        fn(*args, **kwargs)
    acc = {k: v for k, v in counts.bytes.items() if counts.calls[k]}
    acc["total"] = sum(acc.values())
    return acc
