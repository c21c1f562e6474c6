"""Host C++ for the preprocessing pipeline (counterpart of
e3diff_tpu/native): ``dssp_core.cpp`` holds the two hot loops of the DSSP
features, the Kabsch-Sander H-bond pair scan and the Shrake-Rupley
accessibility. data/dssp.py calls them through ``load_native_lib`` and
holds them to its numpy engine (same element order, values within 1e-12:
numpy's norm rounds through BLAS).

The library is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``e3diff_tpu_torch/_build/native/``, named by a hash of
the source, so an edited source rebuilds; concurrent builds each write a
temporary file and rename it into place. A failed build raises with the
compiler's message: nothing falls back silently. ``E3DIFF_NATIVE=0``
selects the numpy engine instead (``load_native_lib`` returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dssp_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
# what the last build_library call did: the library's path and the
# seconds g++ took (None when the library was already there)
BUILD_INFO: dict = {}


def native_enabled() -> bool:
    """False when ``E3DIFF_NATIVE=0`` asks for the numpy engine."""
    return os.environ.get("E3DIFF_NATIVE", "1") != "0"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"dssp_core-{digest}.so"


def build_library() -> Path:
    """Compile ``dssp_core.cpp`` unless a library of this source exists;
    returns its path. Raises RuntimeError with g++'s output on failure."""
    so_path = library_path()
    if so_path.is_file():
        BUILD_INFO.update(path=str(so_path), build_seconds=None)
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native DSSP build: cannot run g++ ({e}); set "
                           "E3DIFF_NATIVE=0 for the numpy engine") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native DSSP build failed:\n$ {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)  # atomic under concurrent builds
    BUILD_INFO.update(path=str(so_path),
                      build_seconds=time.perf_counter() - t0)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ks_hbond_scan.restype = ctypes.c_int
    lib.ks_hbond_scan.argtypes = [
        f64p, f64p, f64p, f64p, f64p, u8p, ctypes.c_int,
        i32p, i32p, f64p, ctypes.c_int]
    lib.shrake_rupley.restype = None
    lib.shrake_rupley.argtypes = [
        f64p, f64p, i32p, ctypes.c_int, f64p, ctypes.c_int,
        f64p, ctypes.c_int]
    return lib


def load_native_lib():
    """The compiled library (built at the first call of a process), or
    None when ``E3DIFF_NATIVE=0``. A build or load failure raises."""
    global _LIB
    if not native_enabled():
        return None
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(build_library())))
    return _LIB


def as_f64(arr):
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def as_i32(arr):
    a = np.ascontiguousarray(arr, dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def as_u8(arr):
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
