"""maus_tpu_torch stands alone: it imports without jax and without nvcc, exports
exactly its public API, and its copy of the problem generators is identical to
the JAX package's."""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maus_tpu.problems import generators as gen_jax
from maus_tpu_torch.problems import generators as gen_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = (
        "import sys, maus_tpu_torch\n"
        "import maus_tpu_torch.ops.kernels.residual, maus_tpu_torch.utils.convert\n"
        "import maus_tpu_torch.ops.kernels.hess_solve, maus_tpu_torch.ops.refine_eig\n"
        "import maus_tpu_torch.ops.kernels.cgemm, maus_tpu_torch.ops.kernels.lu\n"
        "import maus_tpu_torch.utils.truth, maus_tpu_torch.utils.checkpoint\n"
        "import maus_tpu_torch.utils.metrics, maus_tpu_torch.age.viz\n"
        "import maus_tpu_torch.age, maus_tpu_torch.cli\n"
        "import maus_tpu_torch.parallel.launch, maus_tpu_torch.parallel.dist_svd\n"
        "import maus_tpu_torch.parallel.dist_refine, maus_tpu_torch.utils.comm_budget\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'maus_tpu.')) or m == 'maus_tpu')\n"
        "assert not bad, bad\n"
        "print(sorted(maus_tpu_torch.__all__))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin",
               CUDA_HOME="", CUDA_PATH="")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted(
        ["MausSolver", "MeshSolver", "ProblemKnowledge", "ProblemType",
         "SolutionReport", "SolverConfig", "eig", "solve", "svd"]))


def test_package_sources_never_import_jax():
    root = os.path.join(REPO, "maus_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax",
                                                 "import maus_tpu ",
                                                 "from maus_tpu ",
                                                 "from maus_tpu.")), \
                            (name, line)


_GEN_CALLS = {
    "hilbert": [(7,)],
    "dynamic_solve_system": [(5, 3), (8, 0, 50, 4)],
    "laplace_like_complex": [(8,), (9, True, 3)],
    "low_rank_svd_matrix": [(5, 4), (12, 7, 3, 2, 1e-3)],
    "well_conditioned_system": [(6,), (9, 2, False)],
    "ill_conditioned_system": [(16,), (12, 1e9, 5)],
    "hermitian_matrix": [(6,), (10, 4)],
}


def test_generator_table_covers_every_function():
    public = {n for n, f in inspect.getmembers(gen_jax, inspect.isfunction)
              if f.__module__ == gen_jax.__name__}
    assert public == set(_GEN_CALLS)


@pytest.mark.parametrize("name", sorted(_GEN_CALLS))
def test_generators_are_identical(name):
    for args in _GEN_CALLS[name]:
        a = getattr(gen_jax, name)(*args)
        b = getattr(gen_torch, name)(*args)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
