"""Diffusion visualization (reference K10, K:572-593): a heatmap of the best
expression's full diffusion grid. Counterpart of ``maus_tpu/age/viz.py``;
matplotlib is optional and imported only by :func:`plot_best`."""
from __future__ import annotations

import numpy as np
import torch

from ..solver.api import _resolve_device
from . import diffusion
from .tape import compile_tree, stack_tapes


def capture_full_grid(genome, conf, device=None) -> np.ndarray:
    """Re-run one genome's diffusion sim keeping every time step (the
    reference's ``visualize=True`` path, K:82-116) on ``device`` (default:
    the card). Returns (T, N) float32."""
    base = torch.tensor(conf.base_kernel, dtype=torch.float32,
                        device=_resolve_device(None, device))
    tapes = stack_tapes([compile_tree(genome.tree, conf.variables)])
    states = [state[0] for state, _ in diffusion.trajectory(
        tapes, conf.diffusion_n, conf.diffusion_t, base)]
    return torch.stack(states).cpu().numpy()


def plot_best(engine, path: str = "age_best_diffusion.png"):
    """Save the reference's final heatmap (K:572-593) for the engine's best
    archived genome. Returns the path, or None when matplotlib is unavailable
    or the library is empty."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    if not engine.harmonic_library:
        return None
    best = max(engine.harmonic_library, key=lambda g: g.stability)
    grid = capture_full_grid(best, engine.conf, device=engine.device)
    fig, ax = plt.subplots(figsize=(7, 5))
    im = ax.imshow(grid, aspect="auto", origin="lower", cmap="magma")
    ax.set_xlabel("space")
    ax.set_ylabel("time")
    ax.set_title(f"best expression (fitness {best.stability:.3f}): "
                 f"{best.tree.to_string()[:60]}")
    fig.colorbar(im, ax=ax, label="concentration")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
