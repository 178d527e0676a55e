"""A fresh complex Ginibre operand (G₁ + iG₂)/√N, complex64, for every
request (``operands.eig_operand``); an eigenproblem, so no b.

Set-up refuses, before any request, a program that lacks what the
configuration's guarantee rests on: each name in its ``requires`` has to be
one the program declares in ``maus_tpu_torch.utils.metrics.SPANS``."""
from port_bench import operands


def setup(config, traffic, seed, device):
    from maus_tpu_torch.utils.metrics import SPANS

    missing = sorted(set(config.get("requires", ())) - {name for name, _ in SPANS})
    if missing:
        raise SystemExit(f"port_bench: the program declares no {', '.join(missing)}, "
                         f"which {config['name']} requires; no result")
    return None


def operand(config, traffic, state, seed, i, device):
    return operands.eig_operand(int(config["n"]), seed, device), None, {}
