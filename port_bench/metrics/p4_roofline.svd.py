"""P4 in the SVD finisher (the LU of each chunk's shifted Gram, (8, 2048)
complex64): ``p4_roofline.eig``'s kernels, calls and bound (``work.p4_work``
over ``work.p4_peak``), read from that file, over the SVD cell's trace, %."""
from pathlib import Path

from port_bench import mix, readers

_EIG = mix.load_module(Path(__file__).resolve().parents[2],
                       "port_bench/metrics/p4_roofline.eig.py")
KERNELS, CALLS, bound_s = _EIG.KERNELS, _EIG.CALLS, _EIG.bound_s


def read(run):
    return readers.roofline(run, KERNELS, CALLS[0], bound_s)
