"""K1 (``csrc/true_residual.cu``): the summed bounds of the traced
``true_residual`` calls (bytes over the HBM rate or FP64 operations,
whichever is larger) over the device time of K1's kernels, %."""
from port_bench import readers, work

KERNELS = ("residual_c64", "residual_c128")
CALLS = ("maus_tpu_torch.ops.kernels.residual:true_residual",)


def bound_s(call):
    A = call["A"]
    nbytes, flops = work.k1_work(A.shape[0], A.shape[1], A.dtype)
    return work.bound_ms(nbytes, flops, work.FP64_FLOPS)[0] / 1e3


def read(run):
    return readers.roofline(run, KERNELS, CALLS[0], bound_s)
