"""``maus_tpu_torch.solve(A, b, ...)``: the public linear entry, staging and
the diagnosis's condition probe included."""
from port_bench import program


def serve(config, req, control):
    import maus_tpu_torch as maus

    cfg = program.control_config(config, "linear") if control else None
    return maus.solve(req.A, req.b, tol=float(config["tol"]),
                      max_iterations=int(config["max_iterations"]),
                      num_candidates=int(config["num_candidates"]), seed=req.solver_seed,
                      config=cfg, device=req.A.device)


def reached_target(config, report):
    return program.reached(config, report, 1)


def answer(config, report):
    return program.linear_answer(report)
