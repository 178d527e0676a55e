"""Batched postfix-tape interpreter.

Counterpart of ``maus_tpu/age/interp.py``. The reference evaluates each
expression tree recursively per grid cell (K:28-47). Here one pass
evaluates a whole population of tapes on all grid cells at once: the
operand stack is a ``(P, MAX_STACK, N)`` float32 tensor with a stack
pointer per member, and at each tape position every member's op is applied
through a gather and a scatter at its own pointer. As under the JAX
package's vmapped ``lax.switch``, the full unary and binary tables are
evaluated and each member's entry selected; a member's validity is ANDed
only with the finiteness of the op it actually runs, so a non-finite value
in a branch it did not take never invalidates a cell. The loop stops at the
batch's longest tape, since the NOP padding after it changes nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from .tape import BINARY_OPS, MAX_STACK, OP_BINARY, OP_CONST, OP_NOP, OP_UNARY, \
    OP_VAR, UNARY_OPS


def _unary_table(x: torch.Tensor) -> torch.Tensor:
    """The protected unary ops (K:183-188) of ``x``, stacked in
    ``UNARY_OPS`` order."""
    table = torch.stack([
        -x,                                                   # neg
        torch.sin(x),                                         # sin
        torch.cos(x),                                         # cos
        torch.exp(torch.clamp(x, -10.0, 10.0)),               # exp (clipped)
        torch.log(torch.abs(x) + 1e-9),                       # log (protected)
        torch.sqrt(torch.abs(x)),                             # sqrt (protected)
        torch.abs(x),                                         # abs
        torch.tanh(x),                                        # tanh
        1.0 / (1.0 + torch.exp(-torch.clamp(x, -10.0, 10.0))),  # sig
    ])
    assert table.shape[0] == len(UNARY_OPS)
    return table


def _binary_table(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The protected binary ops (K:216-217), stacked in ``BINARY_OPS``
    order. Division by |b| ≤ 1e-9 gives sign(a)·sign(b + 1e-30)·inf (so 0/0
    is NaN), and the exponent of ``^`` is clipped to ±5; the non-finite
    results invalidate the cell, as the reference's None does."""
    inf = torch.full_like(a, float("inf"))
    table = torch.stack([
        a + b,
        a - b,
        a * b,
        torch.where(torch.abs(b) > 1e-9, a / b,
                    torch.sign(a) * torch.sign(b + 1e-30) * inf),
        torch.pow(a, torch.clamp(b, -5.0, 5.0)),
    ])
    assert table.shape[0] == len(BINARY_OPS)
    return table


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx[p], p]`` for a (T, P, N) table and (P,) indices."""
    idx = torch.clamp(idx, 0, table.shape[0] - 1)
    return torch.gather(table, 0, idx[None, :, None].expand(1, *table.shape[1:]))[0]


def tape_length(opcode) -> int:
    """Positions up to the last non-NOP of any tape in the batch."""
    used = torch.nonzero(torch.as_tensor(opcode).reshape(-1, opcode.shape[-1])
                         != OP_NOP)
    return int(used[:, 1].max()) + 1 if used.numel() else 0


def eval_population(tapes: dict, variables: torch.Tensor,
                    length: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a population of tapes.

    Args:
      tapes: ``opcode``, ``arg`` (P, MAX_TAPE) integers and ``const``
        (P, MAX_TAPE) float32, numpy arrays or tensors.
      variables: (V, N) variables shared by all members, or (P, V, N), one
        row per variable in tape-variable order, N cells.
      length: the batch's :func:`tape_length`, when the caller has it.
    Returns:
      ``(value, valid)``: (P, N) float32 results and validity, on the
      variables' device.
    """
    device = variables.device
    length = tape_length(tapes["opcode"]) if length is None else length
    opcode, arg = (torch.as_tensor(tapes[k], device=device).long()
                   for k in ("opcode", "arg"))
    const = torch.as_tensor(tapes["const"], device=device).to(torch.float32)
    P, n = opcode.shape[0], variables.shape[-1]
    variables = variables.to(torch.float32).expand(P, *variables.shape[-2:])
    stack = torch.zeros((P, MAX_STACK, n), dtype=torch.float32, device=device)
    sp = torch.zeros((P,), dtype=torch.long, device=device)
    valid = torch.ones((P, n), dtype=torch.bool, device=device)
    rows = torch.arange(P, device=device)
    for i in range(length):
        op, a = opcode[:, i], arg[:, i]
        top = stack[rows, torch.clamp(sp - 1, min=0)]
        below = stack[rows, torch.clamp(sp - 2, min=0)]
        un = _pick(_unary_table(top), a)
        bi = _pick(_binary_table(below, top), a)
        var = _pick(variables.transpose(0, 1), a)
        is_un, is_bi = (op == OP_UNARY)[:, None], (op == OP_BINARY)[:, None]
        val = torch.where(is_un, un, torch.where(
            is_bi, bi, torch.where((op == OP_VAR)[:, None], var,
                                   const[:, i, None].expand(P, n))))
        pos = torch.where(op == OP_UNARY, sp - 1,
                          torch.where(op == OP_BINARY, sp - 2, sp))
        pos = torch.clamp(pos, 0, MAX_STACK - 1)
        stack[rows, pos] = torch.where((op != OP_NOP)[:, None], val,
                                       stack[rows, pos])
        valid = valid & torch.where(is_un, torch.isfinite(un),
                                    torch.where(is_bi, torch.isfinite(bi), True))
        sp = sp + torch.where((op == OP_CONST) | (op == OP_VAR), 1,
                              torch.where(op == OP_BINARY, -1, 0))
    return stack[:, 0], valid


def eval_tape(opcode, arg, const, variables: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate one tape ((MAX_TAPE,) arrays) on (V, N) variables: (N,)
    float32 values and validity."""
    val, valid = eval_population(
        {"opcode": torch.as_tensor(opcode)[None], "arg": torch.as_tensor(arg)[None],
         "const": torch.as_tensor(const)[None]}, variables)
    return val[0], valid[0]
