"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` into one shared library with a
plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). The library lands in `s2s_ismr_tpu_torch/_build/` under a
name that carries the hash of the sources and flags: a changed source
rebuilds, an unchanged one loads what is there. Nothing is built at import;
the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()     # lanes of a mesh launch from several threads


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> dict:
    """Build the kernel library unless a build of these exact sources and
    flags exists. Returns {'path', 'seconds', 'log'} (the compiler's output,
    with ptxas register and spill counts; 'seconds' is 0 for a cached
    build)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + fh.read())
    path = os.path.join(BUILD_DIR, f"libs2s_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()["path"])
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.s2s_conv3x3_f32.argtypes = [vp] * 6 + [ci] * 9 + [cl] * 6 + [vp]
        lib.s2s_conv3x3_f32.restype = ci
        pi = ctypes.POINTER(ci)
        lib.s2s_conv3x3_tile.argtypes = [ci] + [pi] * 6
        lib.s2s_conv3x3_tile.restype = ci
        lib.s2s_conv3x3_chunk.argtypes = []
        lib.s2s_conv3x3_chunk.restype = ci
        lib.s2s_batchnorm_f32.argtypes = [ci] + [vp] * 12 + [ci] * 5 + [vp]
        lib.s2s_batchnorm_f32.restype = ci
        lib.s2s_cuda_error_string.argtypes = [ci]
        lib.s2s_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
