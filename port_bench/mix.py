"""The requests of a cell and the call that serves them, put together from
files found by name.

A traffic mix is a data file, ``port_bench/traffic/<mix>.json``, that names
an input kind (``"operand"``) and a call (``"call"``), with whatever
parameters those read; the configuration (``port_bench/configs/<config>.json``)
gives the sizes, the solver's parameters and its plain reference
(``"reference"``, a file under ``port_bench/reference/``). Each named piece
is a module of its own:

``port_bench/inputs/<operand>.py``
    ``setup(config, traffic, seed, device)`` (optional): what every request
    draws from, built once in set-up; ``operand(config, traffic, state,
    seed, i, device)``: request ``i``'s ``(A, b, info)``, drawn from
    ``seed`` alone (b is None for an eigenproblem; ``info`` a dict of what
    the generator knows of its operand, such as its κ).
``port_bench/calls/<call>.py``
    ``serve(config, req, control)``: the program run on a :class:`Request`,
    its report (``control``: the program's own lower-precision path, which
    the check has to fail); ``reached_target(config, report)``: whether the
    program says it delivered; ``answer(config, report)``: what the
    reference judges, on the host.
the reference
    ``judge(config, records, rebuilt)``: ``{name: (value, limit)}`` over
    the window's records (see ``check.py``).

Request ``i`` of a run is drawn from the run's seed and ``i`` alone, so the
same seed serves the same requests and the operand can be rebuilt bit for
bit after the window for the check. A new input kind, call or reference is
a new file; a new mix that recombines them is a new data file.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import torch

from . import operands


def load_module(root: Path, relpath: str):
    """The module in the file ``relpath`` under ``root``."""
    path = Path(root) / relpath
    if not path.is_file():
        raise SystemExit(f"port_bench: no file {relpath}")
    name = "port_bench._by_name." + relpath.removesuffix(".py").replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Request:
    index: int
    A: torch.Tensor
    b: torch.Tensor | None
    info: dict
    solver_seed: int
    fingerprint: torch.Tensor


class Mix:
    """The requests of one cell: ``config`` and ``traffic`` as read from
    their files, ``seed`` the run's seed, the named modules from ``root``."""

    def __init__(self, root: Path, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.inputs = load_module(root, f"port_bench/inputs/{traffic['operand']}.py")
        self.call = load_module(root, f"port_bench/calls/{traffic['call']}.py")
        self.reference = load_module(root, config["reference"])
        self.state = None

    def setup(self) -> None:
        """Build what every request draws from."""
        setup = getattr(self.inputs, "setup", None)
        if setup is not None:
            self.state = setup(self.config, self.traffic, self.seed, self.device)

    def operand_of(self, i: int):
        """(A, b, info) of request ``i``."""
        return self.inputs.operand(self.config, self.traffic, self.state,
                                   operands.sub_seed(self.seed, 2, i), i, self.device)

    def request(self, i: int) -> Request:
        A, b, info = self.operand_of(i)
        return Request(i, A, b, info, operands.sub_seed(self.seed, 3, i) % 2**32,
                       operands.fingerprint(A, b))

    def serve(self, req: Request, control: bool = False):
        return self.call.serve(self.config, req, control)

    def reached_target(self, report) -> bool:
        return self.call.reached_target(self.config, report)

    def answer(self, report):
        return self.call.answer(self.config, report)

    def rebuilt(self, record: dict):
        """The record's operand and b, rebuilt from the seed; raises if they
        are not bit for bit those the program was served."""
        A, b, _ = self.operand_of(record["index"])
        if not torch.equal(operands.fingerprint(A, b), record["fingerprint"]):
            raise RuntimeError(f"request {record['index']}: the rebuilt operand "
                               f"differs from the one served")
        return A, b
