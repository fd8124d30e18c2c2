"""Build and load the window kernels' CUDA library.

``nvcc`` compiles ``csrc/window_kernels.cu`` for ``sm_90a`` into a shared
library with a plain C interface, on first use, into ``build/`` at the
repository root.  The library's name carries a hash of its source and flags,
so an edited source rebuilds.  It is loaded with ``ctypes``; pointers and the
stream travel as ``c_void_p``.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["SOURCE", "build_dir", "library"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "window_kernels.cu"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "density_window": [_P] * 6 + [_I] * 4 + [_F] * 5 + [_P],
    "forces_window": [_P] * 8 + [_I] * 4 + [_F] * 10 + [_P],
}


def build_dir() -> pathlib.Path:
    """``build/`` beside the package (the repository root)."""
    return _PKG.parent / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the window kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def library() -> tuple[ctypes.CDLL, str]:
    """The loaded library and the compiler's log (empty when it was already
    built).  Compiles on first use."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"libwindow_kernels_{tag}.so"
    log = ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, log
