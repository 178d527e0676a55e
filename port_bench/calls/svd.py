"""``maus_tpu_torch.svd(A, ...)`` with the configured target: the public SVD
entry (``candidate.step_svd``'s block rounds, then the Gram finisher
``ops/refine_eig.refine_svd_triplets`` on P4/K3 and LS).

The control (``program.control_config`` knows only the linear and eig
problems) is built here the same way: the complex64 working dtype, the FP64
finisher off (``refine=False``), and the convergence floor the program
gives an SVD in that dtype."""
from __future__ import annotations

import torch

from port_bench import program


def control_config(config: dict):
    import maus_tpu_torch as maus
    from maus_tpu_torch.solver.api import eig_convergence_floor

    c64 = torch.complex64
    return maus.SolverConfig(
        problem_type=maus.ProblemType.SVD, num_candidates=int(config["num_candidates"]),
        tol=float(config["tol"]), dtype=c64, refine=False,
        convergence_floor=eig_convergence_floor(c64, max(int(config["m"]),
                                                         int(config["n"]))))


def serve(config, req, control):
    import maus_tpu_torch as maus

    return maus.svd(req.A, tol=float(config["tol"]),
                    max_iterations=int(config["max_iterations"]),
                    num_candidates=int(config["num_candidates"]), seed=req.solver_seed,
                    target_solutions=int(config["target_solutions"]),
                    config=control_config(config) if control else None,
                    device=req.A.device)


def reached_target(config, report):
    return program.reached(config, report, int(config["target_solutions"]))


def answer(config, report):
    """Every triplet with the residual the program claims for it: ``(σ, U,
    V, claimed)`` on the host, float64 and complex128; None if none came."""
    sols = report.solutions
    if not sols:
        return None
    sig = torch.tensor([float(s) for s, _, _ in sols], dtype=torch.float64)
    U = torch.stack([torch.as_tensor(u).to(torch.complex128) for _, u, _ in sols])
    V = torch.stack([torch.as_tensor(v).to(torch.complex128) for _, _, v in sols])
    return sig, U, V, torch.tensor(report.residuals, dtype=torch.float64)
