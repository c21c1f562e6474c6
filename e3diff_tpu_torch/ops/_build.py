"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (all sources at
once, one process each) and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in ``_build/`` inside
the package, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing here runs at import:
the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], False
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        failed = failed or proc.returncode != 0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(logs))
    return "\n".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for these sources exists yet;
    returns the library's path. ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's output (registers, shared memory, spills per kernel)."""
    lib_path = BUILD_DIR / f"libe3d_kernels_{_digest()}.so"
    if lib_path.is_file():
        if verbose:
            print(f"kernel library up to date: {lib_path.name}")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *ARCH, *FLAGS, *extra, "-c", str(src),
                         "-o", str(o)] for src, o in zip(_sources(), objs)])
        if verbose:
            print(log)
        tmp_lib = Path(tmp) / lib_path.name
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.e3d_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.e3d_attention.restype = i
        lib.e3d_layernorm.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i,
                                      p]
        lib.e3d_layernorm.restype = i
        f, u = ctypes.c_float, ctypes.c_uint32
        lib.e3d_attention_train.argtypes = [p] * 8 + [i] * 5 + [u, f, i, p]
        lib.e3d_attention_train.restype = i
        lib.e3d_attention_backward.argtypes = ([p] * 13 + [i] * 5
                                               + [u, f, i, p])
        lib.e3d_attention_backward.restype = i
        lib.e3d_layernorm_backward.argtypes = [p] * 9 + [i, i, f, i, i, p]
        lib.e3d_layernorm_backward.restype = i
        lib.e3d_dropout_keep.argtypes = [p, i, i, i, i, u, p, p]
        lib.e3d_dropout_keep.restype = i
        lib.e3d_attention_train_occupancy.argtypes = [i, i, i, p]
        lib.e3d_attention_train_occupancy.restype = i
        lib.e3d_layernorm_backward_occupancy.argtypes = [i, i, p]
        lib.e3d_layernorm_backward_occupancy.restype = i
        _lib = lib
    return _lib
