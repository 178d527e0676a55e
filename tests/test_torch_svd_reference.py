"""The SVD cell's plain reference (``port_bench/reference/svd.py``) against
the port on the CPU.

``maus_tpu_torch.svd`` runs at 256×128 with 8 targets on an operand of the
cell's input kind (``port_bench/inputs/svd_pool.py``: U·diag(σ)·Vᴴ, σ_k =
0.8^k for k < 8, then logspace(−2, −4), served in complex64 and rephased),
tol 1e-8, and the reference judges its answer sound. The reference judges
unsound each fault of an answer (every σ moved by 1e-6, one triplet a copy
of the best, half the triplets dropped) and the control (complex64, the
FP64 finisher off). It gives the generator's exact triplets residuals at
rounding level, and imports neither JAX nor the port.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from port_bench import mix
from port_bench.reference import svd as reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
INPUTS = mix.load_module(REPO, "port_bench/inputs/svd_pool.py")
CALL = mix.load_module(REPO, "port_bench/calls/svd.py")
CONFIG = {"m": 256, "n": 128, "sigma_ratio": 0.8, "sigma_top": 8,
          "sigma_tail_log10": [-2.0, -4.0], "num_candidates": 16, "target_solutions": 8,
          "tol": 1e-8, "max_iterations": 100, "pool": 1}
SEED = 2**31 + 7

_CACHE = {}


def _served():
    """The operand as the cell serves it: a pool entry, rephased."""
    if "A" not in _CACHE:
        pool = INPUTS.setup(CONFIG, {}, SEED, "cpu")
        _CACHE["A"] = INPUTS.operand(CONFIG, {}, pool, SEED + 1, 0, "cpu")
    return _CACHE["A"]


def _report(control: bool):
    if control not in _CACHE:
        A, _, _ = _served()
        _CACHE[control] = CALL.serve(CONFIG, SimpleNamespace(A=A, solver_seed=3), control)
    return _CACHE[control]


def _judge(answer, A=None):
    A = _served()[0] if A is None else A
    return reference.judge(CONFIG, [{"index": 0, "answer": answer}], lambda r: (A, None))


def _sound():
    return CALL.answer(CONFIG, _report(False))


def test_the_port_is_sound_by_the_reference():
    A, b, info = _served()
    assert A.shape == (256, 128) and A.dtype == torch.complex64 and b is None
    assert torch.equal(info["sigma_top"], reference.known_sigma(CONFIG, 8))
    report = _report(False)
    assert CALL.reached_target(CONFIG, report)
    checks = _judge(_sound())
    assert checks["svd_resid"][0] <= checks["svd_resid"][1] == 1e-8
    assert checks["svd_short"] == (0, 0)


def _sigma_moved(sig, U, V, claimed):
    return sig + 1e-6, U, V, claimed


def _copy_of_best(sig, U, V, claimed):
    """The triplet of one known σ other than the best one's replaced by a
    copy of the best, its claimed residual kept."""
    best = int(torch.argmin(claimed))
    known = reference.known_sigma(CONFIG, 8)
    victim = next(p for p in range(len(sig)) if p != best
                  and bool(((known - sig[p]).abs() <= reference.MATCH).any()))
    sig, U, V = sig.clone(), U.clone(), V.clone()
    sig[victim], U[victim], V[victim] = sig[best], U[best], V[best]
    return sig, U, V, claimed


def _half_dropped(sig, U, V, claimed):
    return sig[::2], U[::2], V[::2], claimed[::2]


FAULTS = {"sigma_moved": (_sigma_moved, "svd_resid"),
          "copy_of_best": (_copy_of_best, "svd_short"),
          "half_dropped": (_half_dropped, "svd_short")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_faulty_answer_is_unsound(fault):
    alter, fails = FAULTS[fault]
    checks = _judge(alter(*_sound()))
    value, limit = checks[fails]
    assert value > limit, checks


def test_the_control_is_unsound():
    checks = _judge(CALL.answer(CONFIG, _report(True)))
    assert checks["svd_resid"][0] > 10 * checks["svd_resid"][1], checks


@pytest.mark.parametrize("m,n", [(256, 128), (512, 32)])
def test_the_generators_exact_triplets_are_sound(m, n):
    config = dict(CONFIG, m=m, n=n)
    U, sig, V = INPUTS.factors(config, SEED, "cpu")
    A = (U * sig[None, :]) @ V.mH
    top = 8
    res = reference.triplet_residuals(A, sig[:top], U.T[:top], V.T[:top])
    assert float(res.max()) <= 1e-13
    checks = _judge((sig[:top], U.T[:top], V.T[:top], res), A=A)
    assert checks["svd_resid"][0] <= 1e-13 and checks["svd_short"] == (0, 0)


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import port_bench.reference.svd; "
            "print(sorted({m.partition('.')[0] for m in sys.modules} & "
            "{'maus_tpu_torch', 'maus_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
