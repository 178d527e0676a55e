"""1-D diffusion simulation and spread fitness, batched over a population of
expressions.

Counterpart of ``maus_tpu/age/diffusion.py`` (reference K:64-152). Per time
step a memory trace accumulates, each member's expression maps per-cell
trace features to kernel weights (clipped sigmoid, all-zero → uniform 0.5,
K:49-58), the base 3-tap kernel is convolved with the weights and
normalized, and the state is convolved with the result; blow-up, die-out or
a non-finite value fails the member (K:98-112), and a failed member freezes
and stays failed. Fitness is the normalized spread of the final
concentration (K:122-152).

The JAX ``lax.scan`` over time becomes an eager loop of T − 1 steps, each
one batched interpreter pass over all members and cells. The "same"
convolutions are windows of the padded input (``unfold``) times the
flipped per-member kernel, summed in float32 on the vector units (no
matrix product, so no TF32 question).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .interp import eval_population, tape_length


def _conv_same_batched(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``np.convolve(x[p], k[p], mode='same')`` for every row: x (P, N),
    k (P, M) or (M,). The JAX package's padding: (M//2, (M−1)//2)."""
    P, _ = x.shape
    k = k.expand(P, k.shape[-1])
    M = k.shape[1]
    windows = F.pad(x, (M // 2, (M - 1) // 2)).unfold(1, M, 1)   # (P, N, M)
    return (windows * k.flip(1)[:, None, :]).sum(-1)


def _step(tapes: dict, length: int, state, memory, ok, t_step: int, t: int,
          base_kernel: torch.Tensor):
    """One time step of every member: (state, memory, ok) → the next."""
    P, n = state.shape
    center = n // 2
    memory = memory + state
    trace = torch.tanh(memory) * 0.5 + 0.5
    # variables in tape order: m_i, m_c, delta_m, t_norm, i_norm (K:31-40)
    m_c = trace[:, center:center + 1].expand(P, n)
    t_norm = torch.full((P, n), float(t_step), dtype=torch.float32,
                        device=state.device) / t
    i_norm = (torch.arange(n, dtype=torch.float32, device=state.device) / n
              ).expand(P, n)
    variables = torch.stack([trace, m_c, trace - m_c, t_norm, i_norm], dim=1)
    val, valid = eval_population(tapes, variables, length)
    weights = torch.where(
        valid, 1.0 / (1.0 + torch.exp(-torch.clamp(val, -10.0, 10.0))),
        torch.zeros_like(val))
    dead = weights.sum(dim=1) < 1e-9 * n          # all-zero → uniform 0.5
    weights = torch.where(dead[:, None], torch.full_like(weights, 0.5), weights)

    eff = _conv_same_batched(weights, base_kernel)   # K:95-103
    ssum = eff.sum(dim=1)
    kernel_ok = torch.abs(ssum) >= 1e-9
    eff = eff / torch.where(kernel_ok, ssum, torch.ones_like(ssum))[:, None]
    nxt = _conv_same_batched(state, eff)
    total = nxt.sum(dim=1)
    healthy = kernel_ok & torch.isfinite(nxt).all(dim=1) & \
        (total >= 1e-7) & (total <= 1e7)
    ok = ok & healthy
    state = torch.where(ok[:, None], nxt, state)
    return state, memory, ok


def _initial(P: int, n: int, device):
    state = torch.zeros((P, n), dtype=torch.float32, device=device)
    state[:, n // 2] = 1.0
    return state, torch.zeros_like(state), \
        torch.ones((P,), dtype=torch.bool, device=device)


def trajectory(tapes: dict, n: int, t: int, base_kernel: torch.Tensor):
    """Yield ``(state, ok)`` of a population's sim at every time step, the
    initial state first: (P, N) concentration and (P,) success flags, on
    ``base_kernel``'s device. ``tapes``: numpy arrays or tensors
    (``tape.stack_tapes``)."""
    device = base_kernel.device
    length = tape_length(tapes["opcode"])
    tapes = {k: torch.as_tensor(v, device=device) for k, v in tapes.items()}
    state, memory, ok = _initial(tapes["opcode"].shape[0], n, device)
    yield state, ok
    for t_step in range(1, t):
        state, memory, ok = _step(tapes, length, state, memory, ok, t_step, t,
                                  base_kernel)
        yield state, ok


def run_diffusion_population(tapes: dict, n: int, t: int,
                             base_kernel: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the T-step diffusion sim for a population of tapes.

    Returns ``(final_state, ok)``: (P, N) final concentration and (P,)
    success flags (False ⇔ the reference would have returned None).
    """
    for state, ok in trajectory(tapes, n, t, base_kernel):
        pass
    return state, ok


def spread_fitness(final_state: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Normalized spatial std-dev of the final concentration (K:122-152):
    0 for failed or died-out members, else clamp(std/(N/2.5), 0, 1)."""
    _, n = final_state.shape
    total = final_state.sum(dim=1)
    alive = ok & (total > 1e-6)
    safe_total = torch.where(total > 1e-9, total, torch.ones_like(total))
    pos = torch.arange(n, dtype=torch.float32, device=final_state.device)[None, :]
    mean = (final_state * pos).sum(dim=1) / safe_total
    var = (final_state * (pos - mean[:, None]) ** 2).sum(dim=1) / safe_total
    std = torch.sqrt(torch.clamp_min(var, 0.0))
    fit = torch.clamp(std / (n / 2.5), 0.0, 1.0)
    return torch.where(alive, fit, torch.zeros_like(fit))


def population_fitness(tapes: dict, n: int, t: int,
                       base_kernel: torch.Tensor) -> torch.Tensor:
    """Diffusion sim and spread fitness: the engine's stage III, (P,)
    float32 on ``base_kernel``'s device."""
    return spread_fitness(*run_diffusion_population(tapes, n, t, base_kernel))

