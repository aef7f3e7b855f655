"""ctypes bindings for the native C++ OBJ parser (``native/objparse.cpp``).

The port's copy of ``metal_raytracing_tpu.io.native``: the same C ABI, the
same ``NativeObj`` and the same entry points.  The library is compiled from
the port's own source with the host's C++ compiler (``$CXX``, else ``c++``,
else ``g++``) at first use, never at import, into
``build/native/objparse_<hash>.so`` at the root of the checkout, keyed by a
hash of the source, the compiler's path and the flags.

Unlike the JAX package, a parser that cannot be built or loaded raises
``RuntimeError`` with the compiler's output: nothing falls back to the
pure-Python parser behind the caller's back.  Set ``MRT_NO_NATIVE=1`` or
pass ``use_native=False`` to :func:`..obj.load_obj` to parse in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..utils.profiling import named_scope

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "objparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
# native/Makefile's CXXFLAGS and its -shared
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_OPT_OUT = ("set MRT_NO_NATIVE=1 or pass use_native=False to load_obj to "
            "parse in Python")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """The C++ compiler: ``$CXX`` as given, else ``c++``, else ``g++``."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shutil.which(cxx) or cxx
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH to build the "
                       f"native OBJ parser: set CXX, or {_OPT_OUT}")


def _library_path(cxx: str) -> str:
    digest = hashlib.sha256("\0".join((cxx,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"objparse_{digest.hexdigest()[:16]}.so")


def _build(cxx: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not run the C++ compiler {cxx!r} to build "
                           f"the native OBJ parser ({e}); {_OPT_OUT}") from e
    if proc.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{cxx} failed ({proc.returncode}) to build the native OBJ "
            f"parser:\n{proc.stdout}{proc.stderr}\n{_OPT_OUT}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file


def load_library() -> ctypes.CDLL:
    """Build (when needed) and load the native parser: the ``parser load``
    span, with ``parser build`` inside it where the compiler runs."""
    with _lock:
        if _lib is not None:
            return _lib
        with named_scope("parser load"):
            return _load()


def _load() -> ctypes.CDLL:
    global _lib
    cxx = compiler()
    path = _library_path(cxx)
    if not os.path.isfile(path):
        with named_scope("parser build"):
            _build(cxx, path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"could not load the native OBJ parser {path} "
                           f"({e}); {_OPT_OUT}") from e
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_counts.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.obj_vertices.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 3
    lib.obj_submesh_tris.restype = ctypes.c_int64
    lib.obj_submesh_tris.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.obj_submesh_material.restype = ctypes.c_char_p
    lib.obj_submesh_material.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.obj_submesh_indices.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.obj_mtllib_count.restype = ctypes.c_int64
    lib.obj_mtllib_count.argtypes = [ctypes.c_void_p]
    lib.obj_mtllib.restype = ctypes.c_char_p
    lib.obj_mtllib.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class NativeObj:
    """Raw parse result: flat arrays + per-submesh index triples."""

    def __init__(self, positions, normals, texcoords, submeshes, mtllibs,
                 face_count):
        self.positions = positions  # (V, 3) f32
        self.normals = normals  # (VN, 3) f32
        self.texcoords = texcoords  # (VT, 2) f32
        # list of (material_name, tri_pos (T,3), tri_norm (T,3), tri_uv (T,3))
        self.submeshes = submeshes
        self.mtllibs: List[str] = mtllibs
        self.face_count = face_count


def parse_obj_native(path: str) -> NativeObj:
    """Parse with the C++ library (built at its first use)."""
    lib = load_library()
    handle = lib.obj_parse(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        counts = (ctypes.c_int64 * 6)()
        lib.obj_counts(handle, counts)
        nv, nn, nt, nsub, nfaces, _ = list(counts)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nn, 3), np.float32)
        uv = np.empty((nt, 2), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.obj_vertices(handle, pos.ctypes.data_as(fp),
                         nrm.ctypes.data_as(fp), uv.ctypes.data_as(fp))
        submeshes = []
        ip = ctypes.POINTER(ctypes.c_int32)
        for i in range(nsub):
            t = int(lib.obj_submesh_tris(handle, i))
            name = lib.obj_submesh_material(handle, i).decode()
            tp = np.empty((t, 3), np.int32)
            tn = np.empty((t, 3), np.int32)
            tu = np.empty((t, 3), np.int32)
            lib.obj_submesh_indices(handle, i, tp.ctypes.data_as(ip),
                                    tn.ctypes.data_as(ip),
                                    tu.ctypes.data_as(ip))
            submeshes.append((name, tp, tn, tu))
        mtllibs = [lib.obj_mtllib(handle, i).decode()
                   for i in range(int(lib.obj_mtllib_count(handle)))]
        return NativeObj(pos, nrm, uv, submeshes, mtllibs, int(nfaces))
    finally:
        lib.obj_free(handle)
