"""The condition probe's two forms on the card.

On a CUDA operand of N ≥ 1024 the probe's working solves go through an
explicit R⁻¹; the triangular form (``with_rinv=False``) is the one it takes
below that gate. Both must give one estimate on the north-star operand
(N = 4096, κ = 1e6, complex64, built as ``benchmarks/common.make_system``
and port_bench's ``cond_pool`` build it), both must refine to the 1e-6 gate
there, and both must answer ∞ at κ = 1e13. This file imports no JAX, so that
it runs on the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cond_probe.py``.
"""
import math

import pytest
import torch

from maus_tpu_torch.benchmarks.common import make_system
from maus_tpu_torch.ops.batched_solve import _want_rinv
from maus_tpu_torch.solver import diagnose

GATE = 1e-6


def _both_forms(A):
    """{with_rinv: (estimate, final IR residual)}."""
    out = {}
    for with_rinv in (True, False):
        probe = diagnose._cond_probe_device(A, with_rinv=with_rinv)
        out[with_rinv] = (diagnose._cond_from_probe(probe), float(probe[3]))
    return out


@pytest.mark.cuda
def test_rinv_form_matches_triangular_form_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, _ = make_system(4096, 1e6, 0, torch.device("cuda"))
    assert _want_rinv(A)
    forms = _both_forms(A)
    assert forms[True][1] <= GATE and forms[False][1] <= GATE
    assert math.isfinite(forms[False][0])
    assert forms[True][0] == pytest.approx(forms[False][0], rel=1e-4)
    assert diagnose.estimate_cond_device(A) == pytest.approx(forms[True][0],
                                                             rel=1e-4)


@pytest.mark.cuda
def test_both_forms_answer_infinity_past_complex64s_reach_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, _ = make_system(1024, 1e13, 1, torch.device("cuda"))
    assert _want_rinv(A)
    forms = _both_forms(A)
    assert forms[True][0] == forms[False][0] == math.inf
