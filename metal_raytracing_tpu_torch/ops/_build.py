"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` process
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, keyed by a hash of the sources, the headers and the
flags, into ``build/kernels/`` at the root of the checkout, so a fresh
checkout builds its own kernels.  Nothing is built or imported when this
module is imported.

``-fmad=false`` keeps the kernels' float arithmetic op for op equal to their
plain PyTorch versions (no fused multiply-add contraction); division stays
IEEE (no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from ..utils.profiling import named_scope

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Set by the first build in this process: nvcc's register / spill report
# (``-Xptxas -v``).
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        path = os.path.join(root, "bin", "nvcc")
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def sources() -> list:
    """The kernel sources, one object each."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"kernels_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    srcs = sources()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{src} ({p.returncode}):\n{log}"
              for src, p, log in zip(srcs, procs, logs) if p.returncode]
    tmp = f"{out}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stdout}{link.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
    build_log = "".join(logs)


def load_library() -> ctypes.CDLL:
    """Build (when needed) and load the kernel library: the ``kernel
    load`` span, with ``kernel build`` inside it where nvcc runs."""
    with _lock:
        if _lib is not None:
            return _lib
        with named_scope("kernel load"):
            return _load()


def _load() -> ctypes.CDLL:
    global _lib
    path = _library_path()
    if not os.path.isfile(path):
        with named_scope("kernel build"):
            _build(path)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    # K1-K4 and K6: `counts` before the outputs, `visits` after them
    lib.launch_closest_flat.argtypes = [p] * 6 + [i] * 5 + [p] * 5
    lib.launch_closest_flat.restype = i
    lib.launch_any_flat.argtypes = [p] * 6 + [i] * 6 + [p] * 4
    lib.launch_any_flat.restype = i
    lib.launch_closest_hier.argtypes = [p] * 8 + [i] * 6 + [p] * 5
    lib.launch_closest_hier.restype = i
    lib.launch_closest_hier_baked.argtypes = [p] * 7 + [i] * 6 + [p] * 5
    lib.launch_closest_hier_baked.restype = i
    lib.launch_any_hier.argtypes = [p] * 7 + [i] * 7 + [p] * 4
    lib.launch_any_hier.restype = i
    lib.launch_broadphase.argtypes = [p] * 6 + [i] * 6 + [p] * 3 + [i, p]
    lib.launch_broadphase.restype = i
    lib.launch_nearest_cluster.argtypes = [p] * 8 + [i] * 3 + [p] * 4 + [i, p]
    lib.launch_nearest_cluster.restype = i
    lib.launch_closest_rank.argtypes = [p] * 6 + [i] * 5 + [p] * 5
    lib.launch_closest_rank.restype = i
    lib.launch_closest_bvh.argtypes = [p] * 8 + [i] * 7 + [p] * 5
    lib.launch_closest_bvh.restype = i
    lib.launch_any_bvh.argtypes = [p] * 9 + [i] * 7 + [p] * 2
    lib.launch_any_bvh.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
