"""ctypes bindings of the repository's native host runtime,
native/tiray_native.cpp (twin of ti_raytrace_tpu/io/native.py): a C++
OBJ/MTL parser with the semantics of io/obj.py, and 30-bit morton codes.

The library is compiled with g++ at first use into this package's
git-ignored build directory (ops/cuda_build.BUILD_DIR), named by a hash
of the source and the flags, so an edited source is rebuilt.  Where it
cannot be built or loaded, `get_lib` returns None and every entry point
returns None, so callers fall back to Python (io/obj.load_obj does).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ti_raytrace_tpu_torch.ops.cuda_build import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "tiray_native.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> str:
    """Where the library of the present source and flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"tiray_native-{digest[:16]}.so")


def build(out: str) -> bool:
    """Compile the source into the library `out` with g++; False on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # atomic publish: a torn library is never loaded
    return True


def _bind(lib):
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.tiray_obj_load.restype = p
    lib.tiray_obj_load.argtypes = [ctypes.c_char_p]
    lib.tiray_obj_free.argtypes = [p]
    lib.tiray_obj_error.restype = ctypes.c_char_p
    lib.tiray_obj_error.argtypes = [p]
    lib.tiray_obj_num_materials.restype = i32
    lib.tiray_obj_num_materials.argtypes = [p]
    lib.tiray_obj_material_tris.restype = i32
    lib.tiray_obj_material_tris.argtypes = [p, i32]
    lib.tiray_obj_material_params.argtypes = [p, i32, fptr]
    lib.tiray_obj_material_name.restype = ctypes.c_char_p
    lib.tiray_obj_material_name.argtypes = [p, i32]
    lib.tiray_obj_material_soup.argtypes = [p, i32, fptr, fptr, fptr]
    lib.tiray_morton3d.argtypes = [fptr, ctypes.c_int64, fptr, fptr,
                                   ctypes.POINTER(ctypes.c_uint32)]
    return lib


def get_lib():
    """The loaded library, or None if it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        out = library_path()
        if not os.path.exists(out) and not build(out):
            _failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(out))
        except OSError:
            _failed = True
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_obj_native(path: str):
    """The OBJ at `path` parsed natively -> ObjMesh (as io.obj.load_obj
    makes it), or None if the library is unavailable or the parse failed."""
    lib = get_lib()
    if lib is None:
        return None
    from ti_raytrace_tpu_torch.io.obj import ObjMaterial, ObjMesh

    h = lib.tiray_obj_load(path.encode())
    try:
        if lib.tiray_obj_error(h):
            return None
        mesh = ObjMesh()
        for mi in range(lib.tiray_obj_num_materials(h)):
            p = (ctypes.c_float * 9)()
            lib.tiray_obj_material_params(h, mi, p)
            mesh.materials.append(ObjMaterial(
                name=lib.tiray_obj_material_name(h, mi).decode(),
                diffuse=(p[0], p[1], p[2]),
                emissive=(p[3], p[4], p[5]),
                shininess=p[6],
                optical_density=p[7],
                transparency=p[8],
            ))
            t = lib.tiray_obj_material_tris(h, mi)
            pos = np.zeros((t, 3, 3), np.float32)
            nrm = np.zeros((t, 3, 3), np.float32)
            uv = np.zeros((t, 3, 2), np.float32)
            if t:
                lib.tiray_obj_material_soup(h, mi, _fptr(pos), _fptr(nrm), _fptr(uv))
            mesh.tri_pos.append(pos)
            mesh.tri_normal.append(nrm)
            mesh.tri_uv.append(uv)
        return mesh
    finally:
        lib.tiray_obj_free(h)


def morton3d_native(centroids: np.ndarray, lo, hi):
    """30-bit morton codes (uint32) of (n, 3) points in the box [lo, hi],
    or None if the library is unavailable.  The native code scales by the
    reciprocal of the extent where utils/morton divides by it, so a point
    on a quantisation boundary may fall one cell over."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    out = np.zeros((c.shape[0],), np.uint32)
    lib.tiray_morton3d(_fptr(c), ctypes.c_int64(c.shape[0]), _fptr(lo), _fptr(hi),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out
