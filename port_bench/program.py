"""What the calls in ``port_bench/calls/`` share: the control's solver
configuration, and the reading of the program's ``SolutionReport`` into the
answer a reference judges. The program is imported inside the functions
that need it, so that the references and the tests load nothing of it.

The control is the program's own lower-precision path: the complex64
working dtype with the certified FP64 finisher switched off
(``refine=False``), and the convergence floor the program gives that dtype.
"""
from __future__ import annotations

import torch


def control_config(config: dict, problem: str):
    """The ``SolverConfig`` of the control for ``problem`` (``"linear"`` or
    ``"eig"``)."""
    import maus_tpu_torch as maus
    from maus_tpu_torch.solver.api import convergence_floor, eig_convergence_floor

    c64 = torch.complex64
    cands, tol = int(config["num_candidates"]), float(config["tol"])
    if problem == "linear":
        return maus.SolverConfig(
            problem_type=maus.ProblemType.SOLVE_LINEAR_SYSTEM, num_candidates=cands,
            tol=tol, dtype=c64, refine=False,
            convergence_floor=convergence_floor(c64, float(config["cond"])))
    return maus.SolverConfig(
        problem_type=maus.ProblemType.EIGENVALUE, num_candidates=cands,
        tol=tol, dtype=c64, refine=False,
        convergence_floor=eig_convergence_floor(c64, int(config["n"])))


def reached(config: dict, report, need: int) -> bool:
    """Whether the report holds ``need`` solutions at the configuration's
    tol by the program's own account."""
    res = sorted(report.residuals)
    return len(res) >= need and res[need - 1] <= float(config["tol"])


def linear_answer(report):
    """The best x of a linear answer, complex128 on the host; None if none."""
    if not report.solutions:
        return None
    return torch.as_tensor(report.best()[0]).to(torch.complex128)


def eig_answer(report):
    """Every (λ, v) pair of an eig answer with the residual the program
    claims for it: ``(λ, V, claimed)`` on the host; None if none."""
    if not report.solutions:
        return None
    lams = torch.tensor([complex(lam) for lam, _ in report.solutions],
                        dtype=torch.complex128)
    V = torch.stack([torch.as_tensor(v).to(torch.complex128)
                     for _, v in report.solutions])
    return lams, V, torch.tensor(report.residuals, dtype=torch.float64)
