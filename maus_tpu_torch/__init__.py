"""maus_tpu_torch — the MAUS adaptive matrix solver on PyTorch and CUDA.

A port of ``maus_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper GPU,
slice by slice; this slice is the dense linear path Ax=b. The population
engine runs in the working dtype (complex64 on CUDA, complex128 on the CPU)
and certified refinement takes the solution to the user's tolerance with a
true-FP64 residual, a hand-written CUDA kernel on the GPU
(``csrc/true_residual.cu``). The package imports torch and numpy, never jax.
"""
from .core.types import ProblemKnowledge, ProblemType, SolverConfig
from .solver.api import MausSolver, SolutionReport, solve

__all__ = ["MausSolver", "ProblemKnowledge", "ProblemType", "SolutionReport",
           "SolverConfig", "solve"]
