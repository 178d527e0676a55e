"""The operands: κ and Hermitian symmetry exact, and the same seed giving the
same operand, large and negative seeds included."""
from __future__ import annotations

import math

import pytest
import torch

from port_bench import mix, operands

from .conftest import REPO

SEEDS = (0, 2**31 + 5, 3 * 2**40 + 7, -12)


def _cond(A: torch.Tensor) -> float:
    s = torch.linalg.svdvals(A.to(torch.complex128))
    return float(s[0] / s[-1])


def test_cond_operand_and_rephase_keep_kappa():
    A = operands.cond_operand(64, 1e3, operands.sub_seed(5, 1), "cpu")
    assert math.isclose(_cond(A), 1e3, rel_tol=1e-3)
    for seed in SEEDS:
        B, b = operands.rephase(A, operands.sub_seed(seed, 2))
        assert math.isclose(_cond(B), 1e3, rel_tol=1e-3)
        assert torch.allclose(torch.linalg.svdvals(B.to(torch.complex128)),
                              torch.linalg.svdvals(A.to(torch.complex128)), rtol=1e-5)
        assert b.shape == (64,) and B.dtype == torch.complex64


def test_gue_exactly_hermitian_and_ginibre_general():
    for seed in SEEDS:
        s = operands.sub_seed(seed, 2, 0)
        H = operands.hermitian_operand(48, s, "cpu")
        assert torch.equal(H, H.mH)
        G = operands.eig_operand(48, s, "cpu")
        assert not torch.equal(G, G.mH)


def test_requests_repeat_from_the_seed():
    config = {"n": 32, "cond": 1e3, "pool": 2, "reference": "port_bench/reference/linear.py"}
    traffic = {"operand": "cond_pool", "call": "solve"}
    for seed in SEEDS:
        a = mix.Mix(REPO, config, traffic, seed, "cpu")
        b = mix.Mix(REPO, config, traffic, seed, "cpu")
        a.setup(), b.setup()
        for i in (0, 1, 5):
            ra, rb = a.request(i), b.request(i)
            assert torch.equal(ra.A, rb.A) and torch.equal(ra.b, rb.b)
            assert ra.solver_seed == rb.solver_seed < 2**32
            assert ra.info == {"cond": 1e3}
            rec = {"index": i, "fingerprint": ra.fingerprint}
            A, bb = a.rebuilt(rec)
            assert torch.equal(A, ra.A) and torch.equal(bb, ra.b)
        assert not torch.equal(a.request(0).A, a.request(2).A)   # same pool entry, new phases
        with pytest.raises(RuntimeError):
            a.rebuilt({"index": 1, "fingerprint": a.request(0).fingerprint})


def test_sub_seed_range():
    for seed in SEEDS:
        s = operands.sub_seed(seed, 3, 7)
        assert 0 <= s < 2**63
        assert s != operands.sub_seed(seed, 3, 8)
