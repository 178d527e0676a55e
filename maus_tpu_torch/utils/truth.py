"""Reference-truth computation and error report (counterpart of
``maus_tpu/utils/truth.py``; the reference's oracle checking, AMS:554-570 and
AMS:597-608).

Runs on host numpy in float64: O(N³) LAPACK oracle work belongs off the
accelerator. Used by tests and by anyone who wants the reference's "error vs
LAPACK" readout as data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.types import ProblemType


@dataclasses.dataclass
class TruthReport:
    problem_type: ProblemType
    max_abs_error: float        # worst matched-solution error vs the oracle
    mean_abs_error: float
    matched: int                # how many found solutions matched an oracle value
    total_found: int
    details: dict


def compute_truth(A: np.ndarray, problem_type: ProblemType,
                  b: Optional[np.ndarray] = None):
    """LAPACK ground truth: eig → eigenvalues; linear → x; SVD → singular values."""
    A = np.asarray(A, np.complex128)
    if problem_type == ProblemType.EIGENVALUE:
        return np.linalg.eigvals(A)
    if problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        return np.linalg.solve(A, np.asarray(b, np.complex128))
    return np.linalg.svd(A, compute_uv=False)


def compare(report, A: np.ndarray, b: Optional[np.ndarray] = None) -> TruthReport:
    """Compare a :class:`~maus_tpu_torch.solver.api.SolutionReport` against the oracle
    (reference AMS:597-608: per-solution nearest-truth matching)."""
    pt = report.problem_type
    truth = compute_truth(A, pt, b)
    errors = []
    if pt == ProblemType.EIGENVALUE:
        for lam, _v in report.solutions:
            errors.append(float(np.min(np.abs(truth - lam))))
    elif pt == ProblemType.SVD:
        for sig, _u, _v in report.solutions:
            errors.append(float(np.min(np.abs(truth - sig))))
    else:
        for (x,) in report.solutions:
            denom = max(float(np.linalg.norm(truth)), 1e-300)
            errors.append(float(np.linalg.norm(x - truth)) / denom)
    errors_arr = np.asarray(errors) if errors else np.asarray([np.inf])
    return TruthReport(
        problem_type=pt,
        max_abs_error=float(errors_arr.max()),
        mean_abs_error=float(errors_arr.mean()),
        matched=int(np.sum(errors_arr < 1e-4)),
        total_found=len(report.solutions),
        details={"errors": errors})
