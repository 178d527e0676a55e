"""A fresh GUE operand (G + Gᴴ)/2, G = (G₁ + iG₂)/√N, complex64, for every
request (``operands.hermitian_operand``); an eigenproblem, so no b."""
from port_bench import operands


def operand(config, traffic, state, seed, i, device):
    return operands.hermitian_operand(int(config["n"]), seed, device), None, {}
