"""Plain reference for a linear answer: the relative residual
‖b − A·x‖/‖b‖ of the program's x, in complex128 against the operand as
served (complex64 entries, widened exactly).

Number judged (``judge``): ``linear_resid``, the largest residual of an
answer's x over the window; limit: the configuration's ``tol``.
"""
from __future__ import annotations

import math

import torch

C128 = torch.complex128


def relative_residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    A64 = A.to(C128)
    x64 = x.to(device=A.device, dtype=C128)
    b64 = b.to(C128)
    r = b64 - A64 @ x64
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def judge(config: dict, records: list, rebuilt) -> dict:
    worst = 0.0
    for r in records:
        if r["answer"] is None:
            continue
        A, b = rebuilt(r)
        res = relative_residual(A, r["answer"], b)
        worst = max(worst, math.inf if math.isnan(res) else res)
        del A, b
    return {"linear_resid": (worst, float(config["tol"]))}
