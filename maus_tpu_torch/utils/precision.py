"""Full-precision matrix products around the solver's entry points.

On a CUDA card a float32 (and complex64) matrix product may run in TF32,
which keeps about three decimal digits — the same trap as the TPU's bf16
default, which the JAX package closes with
``jax.default_matmul_precision("highest")``; so may a float32 convolution
through cuDNN, whose TF32 flag is on by default. :func:`full_precision`
turns both off for the duration of a call and restores the caller's
settings after.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
