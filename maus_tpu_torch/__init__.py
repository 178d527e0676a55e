"""maus_tpu_torch — the MAUS adaptive matrix solver on PyTorch and CUDA.

A port of ``maus_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper GPU,
slice by slice: the dense linear path Ax=b (:func:`solve`), the
eigenproblem (:func:`eig`; general operands against a shared Hessenberg
form, Hermitian ones through a shared eigh or a deflated Lanczos), the SVD
(:func:`svd`), ``MausSolver.update_problem``, checkpoint/resume and
per-iteration metrics (``MausSolver.evolve``'s ``checkpoint_path``,
``resume_from``, ``checkpoint_every``, ``reopen``, ``collect_metrics``;
``utils/checkpoint.py``, ``utils/metrics.py``), KAIROSAGE (``age/``) and
the CLI (``python -m maus_tpu_torch``). The population engine runs in the
working dtype (complex64 on CUDA, complex128 on the CPU); certified
refinement takes a linear solution to the user's tolerance with a true-FP64
residual (kernel K1, ``csrc/true_residual.cu``), and every shifted solve of
the general eig engine runs against the shared Hessenberg form through
kernel K2 (``csrc/hess_solve_rq.cu``, a bottom-up RQ sweep fused with the
back substitution; its first, top-down QR form ``csrc/hess_solve.cu`` and
that form's blocked variants P1 and P2, ``csrc/hess_stream_v2.cu`` and
``csrc/hess_stream_v3.cu`` on ``csrc/hess_stream.cuh``, are timed beside
it). The finishers of eig and SVD factor their per-candidate shifted
systems with the port's blocked LU (kernels P3 and P4, ``csrc/lu.cu``),
whose trailing update is the complex GEMM K3 (``csrc/cgemm_tc.cu``:
complex64 on the tensor cores; complex128 in ``csrc/cgemm.cu``). Entry
points run on the card unless the caller passes ``device="cpu"``. The
package imports torch and numpy, never jax.
"""
from .core.types import ProblemKnowledge, ProblemType, SolverConfig
from .solver.api import MausSolver, MeshSolver, SolutionReport, eig, solve, svd

__all__ = ["MausSolver", "MeshSolver", "ProblemKnowledge", "ProblemType", "SolutionReport",
           "SolverConfig", "eig", "solve", "svd"]
