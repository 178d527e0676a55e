"""Dense systems of a known condition number. Set-up builds the
configuration's ``pool`` operands of condition number ``cond``
(``operands.cond_operand``: two Haar QRs each, too dear for every request);
request ``i`` takes pool entry ``i mod pool`` rephased with fresh
unit-modulus diagonals, which keeps every singular value, and a fresh b."""
from port_bench import operands


def setup(config, traffic, seed, device):
    n, cond = int(config["n"]), float(config["cond"])
    return [operands.cond_operand(n, cond, operands.sub_seed(seed, 1, p), device)
            for p in range(int(config["pool"]))]


def operand(config, traffic, pool, seed, i, device):
    A, b = operands.rephase(pool[i % len(pool)], seed)
    return A, b, {"cond": float(config["cond"])}
