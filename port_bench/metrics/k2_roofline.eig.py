"""K2 (``csrc/hess_solve_rq.cu``): the summed bounds of the traced
``hess_solve`` calls (FP32 operations, 14·K·N², or bytes over the HBM rate,
whichever is larger; ``work.k2_work``) over the device time of K2's kernel,
%."""
from port_bench import readers, work

KERNELS = ("hess_solve_rq_kernel",)
CALLS = ("maus_tpu_torch.ops.kernels.hess_solve:hess_solve",)


def bound_s(call):
    K, N = call["B"].shape
    return work.bound_ms(*work.k2_work(K, N), work.FP32_FLOPS)[0] / 1e3


def read(run):
    return readers.roofline(run, KERNELS, CALLS[0], bound_s)
