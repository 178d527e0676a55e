"""The condition probe on the card.

The probe factors and solves through the linear path's one QR form
(``ops/batched_solve.factor_qr``, ``solve_qr``, ``solve_qr_adj``) on every
device, so its estimate on the card must be the one it gives on the CPU:
on the north-star operand (N = 4096, κ = 1e6, complex64, built as
``benchmarks/common.make_system`` and port_bench's ``cond_pool`` build it)
the two agree within 1e-4 relative and both refine to the 1e-6 gate, and at
κ = 1e13 the card answers ∞. This file imports no JAX, so that it runs on
the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cond_probe.py``.
"""
import math

import pytest
import torch

from maus_tpu_torch.benchmarks.common import make_system
from maus_tpu_torch.solver import diagnose

GATE = 1e-6


def _probe(A):
    """(estimate, final IR residual)."""
    probe = diagnose._cond_probe_device(A)
    return diagnose._cond_from_probe(probe), float(probe[3])


@pytest.mark.cuda
def test_rinv_form_matches_triangular_form_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, _ = make_system(4096, 1e6, 0, torch.device("cuda"))
    card, host = _probe(A), _probe(A.cpu())
    assert card[1] <= GATE and host[1] <= GATE
    assert math.isfinite(host[0])
    assert card[0] == pytest.approx(host[0], rel=1e-4)
    assert diagnose.estimate_cond_device(A) == pytest.approx(card[0], rel=1e-4)


@pytest.mark.cuda
def test_both_forms_answer_infinity_past_complex64s_reach_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, _ = make_system(1024, 1e13, 1, torch.device("cuda"))
    assert _probe(A)[0] == math.inf
