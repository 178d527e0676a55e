"""P4 (``csrc/lu.cu`` with K3's trailing updates, ``csrc/cgemm_tc.cu`` in
complex64 and ``csrc/cgemm.cu`` in complex128): the summed bounds of the
traced ``lu_factor`` calls (``work.p4_work`` over ``work.p4_peak`` of the
call's dtype, or bytes over the HBM rate, whichever is larger) over the
device time of the kernels that ``lu_factor`` launches, %."""
from port_bench import readers, work

KERNELS = ("lu_panel_kernel", "lu_panel_cluster_kernel", "lu_swap_trsm_kernel",
           "cgemm_tc_kernel", "cgemm_kernel")
CALLS = ("maus_tpu_torch.ops.kernels.lu:lu_factor",)


def bound_s(call):
    H = call["H"]
    K, N = (H.shape[0] if len(H.shape) == 3 else 1), H.shape[-1]
    return work.bound_ms(*work.p4_work(K, N, H.dtype), work.p4_peak(H.dtype))[0] / 1e3


def read(run):
    return readers.roofline(run, KERNELS, CALLS[0], bound_s)
