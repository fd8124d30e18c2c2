"""Build and load the port's CUDA libraries.

``nvcc`` compiles each source under ``csrc/`` for ``sm_90a`` into its own
shared library with a plain C interface, on first use, into ``build/`` at
the repository root: ``window_kernels.cu`` (density, forces, field),
``probe_kernels.cu`` (the window-copy and span probes) and
``relayout_kernels.cu`` (the relayout).  A library's name
carries a hash of its source and flags, so an edited source rebuilds that
library alone.  It is loaded with ``ctypes``; pointers and the stream travel
as ``c_void_p``.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

from ...utils.tracer import tracer

__all__ = ["SOURCES", "build_dir", "library"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> (source, {entry point: argtypes})
SOURCES = {
    "window_kernels": (_PKG / "csrc" / "window_kernels.cu", {
        "density_window": [_P] * 5 + [_I] * 6 + [_F] * 5 + [_P],
        "forces_window": [_P] * 7 + [_I] * 6 + [_F] * 10 + [_P],
        "field_window": [_P] * 5 + [_I] * 6 + [_F] * 2 + [_P],
    }),
    "probe_kernels": (_PKG / "csrc" / "probe_kernels.cu", {
        "window_copy": [_P] * 3 + [_I] * 5 + [_P],
        "span_density": [_P] * 4 + [_I] * 5 + [_P],
    }),
    "relayout_kernels": (_PKG / "csrc" / "relayout_kernels.cu", {
        "relayout_ws_ints": [_I] * 3,
        "relayout_keys": [_P] * 3 + [_I] * 4 + [_F] + [_P],
        "relayout_frame": [_P] * 14 + [_I] * 9 + [_F] + [_P],
    }),
}


def build_dir() -> pathlib.Path:
    """``build/`` beside the package (the repository root)."""
    return _PKG.parent / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def library(name: str = "window_kernels") -> tuple[ctypes.CDLL, str]:
    """The loaded library ``name`` (a key of SOURCES) and the compiler's log
    (empty when it was already built).  Compiles on first use.  The first
    call is one span ``kernels.load``, whose ``compiled`` says whether nvcc
    ran."""
    source, signatures = SOURCES[name]
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"lib{name}_{tag}.so"
    log = ""
    with tracer.span("kernels.load", library=name, compiled=not out.exists()):
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, log
