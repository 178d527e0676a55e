"""Expression genomes and their compilation to fixed-width postfix tapes.

Counterpart of ``maus_tpu/age/tape.py``, kept as the port's own copy: the
same trees from the same ``random.Random`` stream, the same tapes. A genome
is a host-side expression tree (KAIROSAGE's node classes, K:156-249; its
generator, K:346-382); each tree compiles to a postfix tape of three
fixed-width arrays (opcode, argument, constant) padded to ``MAX_TAPE``, so
a population stacks into one (P, MAX_TAPE) batch for the interpreter
(:mod:`maus_tpu_torch.age.interp`).

Protected-op semantics follow the reference tables (K:183-222): clipped
exp and sigmoid, log(|x|+1e-9), sqrt(|x|), signed-inf protected division;
a non-finite intermediate invalidates the expression at that evaluation
point (weight → 0).
"""
from __future__ import annotations

import dataclasses
import random as _random
import numpy as np

# Core variable set (K:31-40)
VARIABLES = ("m_i", "m_c", "delta_m", "t_norm", "i_norm")
UNARY_OPS = ("neg", "sin", "cos", "exp", "log", "sqrt", "abs", "tanh", "sig")
BINARY_OPS = ("+", "-", "*", "/", "^")

# opcodes
OP_NOP, OP_CONST, OP_VAR, OP_UNARY, OP_BINARY = 0, 1, 2, 3, 4

MAX_TAPE = 64          # complete depth-5 tree is 63 nodes; reference caps depth 4
MAX_STACK = 16


# ---------------------------------------------------------------------------
# Tree genome
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    """One expression node: kind ∈ {'const','var','unary','binary'}."""

    kind: str
    value: float = 0.0               # const
    name: str = ""                   # var or op name
    children: tuple = ()

    def complexity(self) -> int:     # node count (K:261)
        return 1 + sum(c.complexity() for c in self.children)

    def to_string(self) -> str:
        if self.kind == "const":
            return str(self.value)
        if self.kind == "var":
            return self.name
        if self.kind == "unary":
            return f"{self.name}({self.children[0].to_string()})"
        return f"({self.children[0].to_string()} {self.name} " \
               f"{self.children[1].to_string()})"

    def to_sympy(self):
        """Sympy mirror (K:189-222) for canonical-form novelty dedup."""
        import sympy

        if self.kind == "const":
            return sympy.Float(self.value)
        if self.kind == "var":
            return sympy.Symbol(self.name)
        if self.kind == "unary":
            arg = self.children[0].to_sympy()
            table = {"neg": lambda x: -x, "sin": sympy.sin, "cos": sympy.cos,
                     "exp": sympy.exp, "log": sympy.log, "sqrt": sympy.sqrt,
                     "abs": sympy.Abs, "tanh": sympy.tanh,
                     "sig": lambda x: 1 / (1 + sympy.exp(-x))}
            return table[self.name](arg)
        a, b = (c.to_sympy() for c in self.children)
        table = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
                 "*": lambda x, y: x * y, "/": lambda x, y: x / y,
                 "^": lambda x, y: x ** y}
        return table[self.name](a, b)

    def canonical_form(self) -> str:
        """``sympy.simplify`` string (K:267-272); falls back to the raw string.

        Guarded by node count: ``simplify`` on deep random trees can take
        seconds each (the reference pays this cost for every genome)."""
        if self.complexity() > 24:
            return self.to_string()
        try:
            import sympy

            return str(sympy.simplify(self.to_sympy()))
        except Exception:
            return self.to_string()


def generate_tree(rng: _random.Random, current_depth: int, max_depth: int,
                  variables=VARIABLES, unary_ops=None, binary_ops=None,
                  const_range=(-2.5, 2.5)) -> Node:
    """Random recursive tree generation with depth-dependent terminal probability
    (reference ``_generate_expression_tree``, K:346-382 semantics)."""
    unary_ops = unary_ops if unary_ops is not None else \
        ("neg", "abs", "sin", "cos", "tanh", "sig", "sqrt", "exp")
    binary_ops = binary_ops if binary_ops is not None else ("+", "-", "*", "/")

    def terminal():
        if rng.random() < 0.5 and variables:
            return Node("var", name=rng.choice(list(variables)))
        lo, hi = const_range
        r = rng.random()
        if r < 0.6:
            val = rng.uniform(lo / 2, hi / 2)
        elif r < 0.85:
            val = float(rng.randint(int(lo), int(hi)))
        else:
            val = rng.uniform(lo, hi)
        return Node("const", value=round(val, 3))

    if current_depth >= max_depth:
        return terminal()
    term_prob = 0.2 + 0.5 * (current_depth / max_depth)
    if rng.random() < term_prob or not (unary_ops or binary_ops):
        return terminal()
    # reference draws op-node type 1:unary / 3:binary out of 5 draws (K:353)
    if rng.random() < 0.4 and unary_ops:
        op = rng.choice(list(unary_ops))
        child = generate_tree(rng, current_depth + 1, max_depth, variables,
                              unary_ops, binary_ops, const_range)
        return Node("unary", name=op, children=(child,))
    op = rng.choice(list(binary_ops))
    left = generate_tree(rng, current_depth + 1, max_depth, variables,
                         unary_ops, binary_ops, const_range)
    right = generate_tree(rng, current_depth + 1, max_depth, variables,
                          unary_ops, binary_ops, const_range)
    return Node("binary", name=op, children=(left, right))


# ---------------------------------------------------------------------------
# Tape compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tape:
    """Postfix program: opcode/arg int32 arrays + f32 constants, MAX_TAPE wide."""

    opcode: np.ndarray    # (MAX_TAPE,) int32
    arg: np.ndarray       # (MAX_TAPE,) int32 — var index or op index
    const: np.ndarray     # (MAX_TAPE,) float32
    length: int


def compile_tree(root: Node, variables=VARIABLES) -> Tape:
    ops, args, consts = [], [], []
    var_index = {v: i for i, v in enumerate(variables)}
    u_index = {o: i for i, o in enumerate(UNARY_OPS)}
    b_index = {o: i for i, o in enumerate(BINARY_OPS)}

    def emit(node: Node):
        for c in node.children:
            emit(c)
        if node.kind == "const":
            ops.append(OP_CONST); args.append(0); consts.append(node.value)
        elif node.kind == "var":
            ops.append(OP_VAR); args.append(var_index[node.name]); consts.append(0.0)
        elif node.kind == "unary":
            ops.append(OP_UNARY); args.append(u_index[node.name]); consts.append(0.0)
        else:
            ops.append(OP_BINARY); args.append(b_index[node.name]); consts.append(0.0)

    emit(root)
    n = len(ops)
    if n > MAX_TAPE:
        raise ValueError(f"expression too large for tape: {n} > {MAX_TAPE}")
    pad = MAX_TAPE - n
    return Tape(opcode=np.asarray(ops + [OP_NOP] * pad, np.int32),
                arg=np.asarray(args + [0] * pad, np.int32),
                const=np.asarray(consts + [0.0] * pad, np.float32),
                length=n)


def stack_tapes(tapes: list) -> dict:
    """Stack a population of tapes into batched arrays for the interpreter."""
    return {
        "opcode": np.stack([t.opcode for t in tapes]),
        "arg": np.stack([t.arg for t in tapes]),
        "const": np.stack([t.const for t in tapes]),
    }
