"""Build and load the port's hand-written CUDA kernels.

The sources under ``maus_tpu_torch/csrc/`` have a plain C interface; each is
compiled by its own ``nvcc`` process (all started together) and the objects
are linked into one shared library in ``maus_tpu_torch/_build/`` (listed in
``.gitignore``) at the first CUDA use, then loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edited
source is rebuilt. Nothing here runs at import time, and nothing falls back:
a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("true_residual.cu", "hess_solve_rq.cu", "hess_solve.cu",
           "hess_solve_v2.cu", "hess_solve_v3.cu", "cgemm.cu", "cgemm_tc.cu",
           "lu.cu")
HEADERS = ("hess_common.cuh", "hess_blocked.cuh", "cgemm.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "maus_tpu_torch are built from source at first use")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmaus_kernels-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the sources into the shared library (if not built yet, or
    always with ``force``) and return its path. The library is written to a
    temporary name and renamed into place, so a process never loads a file
    that another process is still writing."""
    path = _library_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.splitext(s)[0] + ".o") for s in SOURCES]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o,
                              os.path.join(CSRC, s)]
                             for s, o in zip(SOURCES, objs))]
        outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        tmp = os.path.join(work, "lib.so")
        if all(rc == 0 for _, _, rc in outs):
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            outs = [(cmd, proc.stdout + proc.stderr, proc.returncode)]
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.maus_true_residual
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.maus_hess_solve
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for name in ("maus_hess_solve_v2", "maus_hess_solve_v3"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
                    [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_double)
            for name, args in (
                    ("maus_cgemm", [ptr] * 3 + [i32] * 5 + [i64] * 6
                     + [f64] * 4 + [ptr]),
                    ("maus_cgemm_simt", [ptr] * 3 + [i32] * 5 + [i64] * 6
                     + [f64] * 4 + [ptr]),
                    ("maus_cgemm_tc_attrs", [i32, ptr]),
                    ("maus_lu_panel", [ptr, ptr] + [i32] * 5 + [ptr]),
                    ("maus_lu_panel_cluster", [ptr, ptr] + [i32] * 6 + [ptr]),
                    ("maus_lu_cluster_occupancy", [i32] * 4 + [ptr]),
                    ("maus_lu_factor", [ptr, ptr] + [i32] * 4 + [ptr, ptr]),
                    ("maus_lu_cluster_barrier", [i32] * 3 + [ptr]),
                    ("maus_hess_solve_rq", [ptr] * 7 + [i32] * 5 + [ptr]),
                    ("maus_hess_rq_step_floor", [i32] * 4 + [ptr, ptr])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
