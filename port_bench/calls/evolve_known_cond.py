"""``MausSolver(A, SOLVE_LINEAR_SYSTEM, b_vector=b, knowledge=...).evolve``:
the caller who knows the operand's κ (the input kind's ``info["cond"]``), as
``bench.py`` does, so the diagnosis is bypassed."""
from port_bench import program


def serve(config, req, control):
    import maus_tpu_torch as maus

    n = req.A.shape[0]
    kn = maus.ProblemKnowledge(shape=(n, n), cond_estimate=float(req.info["cond"]))
    s = maus.MausSolver(req.A, maus.ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=req.b,
                        initial_num_candidates=int(config["num_candidates"]),
                        global_convergence_tol=float(config["tol"]),
                        config=program.control_config(config, "linear") if control else None,
                        seed=req.solver_seed, knowledge=kn, device=req.A.device)
    return s.evolve(int(config["max_iterations"]))


def reached_target(config, report):
    return program.reached(config, report, 1)


def answer(config, report):
    return program.linear_answer(report)
