"""``maus_tpu_torch.eig(A, ...)`` with the configured target: the public
eigen entry (Hessenberg and K2 for a general operand, Lanczos for a
Hermitian one past ``eigh_max_n``, then the P4/K3 finisher)."""
from port_bench import program


def serve(config, req, control):
    import maus_tpu_torch as maus

    cfg = program.control_config(config, "eig") if control else None
    return maus.eig(req.A, tol=float(config["tol"]),
                    max_iterations=int(config["max_iterations"]),
                    num_candidates=int(config["num_candidates"]), seed=req.solver_seed,
                    target_solutions=int(config["target_solutions"]), config=cfg,
                    device=req.A.device)


def reached_target(config, report):
    return program.reached(config, report, int(config["target_solutions"]))


def answer(config, report):
    return program.eig_answer(report)
