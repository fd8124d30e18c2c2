"""ctypes loader for the native host-I/O runtime, csrc/host_io.c (port of
`pi_sph_fluid_tpu/io/native.py:28-118`).

The host shell (sensor polling, terminal blitting, pacing) is native C like
the reference's L7 layer (`pi_sph_fluid.c:414-470`).  ``gcc`` compiles the
port's own copy of the source on first use into ``build/`` at the
repository root (named by a hash of the source); every entry point has a
pure-Python fallback, since this is host I/O and not device work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time

import numpy as np

from ..ops.window._build import build_dir

__all__ = ["load", "native_available", "blit_halfblocks", "pace_until",
           "read_gravity_sysfs"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "host_io.c")


@functools.lru_cache(maxsize=None)
def load():
    """The loaded native library (built if needed), or None if unavailable."""
    try:
        with open(SOURCE, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    so_path = build_dir() / f"libsph_host_io_{tag}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            so_path.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(["gcc", "-O2", "-Wall", "-fPIC", "-shared", "-o",
                            str(tmp), SOURCE], check=True, capture_output=True)
            os.replace(tmp, so_path)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None

    lib.sph_read_gravity.argtypes = [
        ctypes.c_char_p, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.sph_read_gravity.restype = ctypes.c_int
    lib.sph_blit_halfblocks.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.sph_blit_halfblocks.restype = ctypes.c_long
    lib.sph_pace_until.argtypes = [ctypes.c_double]
    lib.sph_pace_until.restype = ctypes.c_double
    lib.sph_monotonic_s.argtypes = []
    lib.sph_monotonic_s.restype = ctypes.c_double
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads (`io/native.py:70-71`)."""
    return load() is not None


def blit_halfblocks(framebuffer: np.ndarray, rows: int, cols: int) -> str:
    """Packed framebuffer -> half-block text (native fast path)."""
    lib = load()
    fb = np.ascontiguousarray(framebuffer, np.uint8)
    if lib is not None:
        cap = (rows // 2) * (cols * 3 + 1) + 16
        out = ctypes.create_string_buffer(cap)
        n = lib.sph_blit_halfblocks(fb.tobytes(), rows, cols, out, cap)
        if n > 0:
            return out.raw[:n].decode("utf-8")
    # pure-Python fallback
    from ..render.metaballs import unpack_framebuffer

    img = unpack_framebuffer(fb, rows, cols)
    glyphs = np.asarray([" ", "▀", "▄", "█"])
    chars = glyphs[img[0::2].astype(int) + 2 * img[1::2].astype(int)]
    return "\n".join("".join(r) for r in chars) + "\n"


def pace_until(deadline_monotonic_s: float) -> float:
    """Hybrid sleep/spin to an absolute monotonic deadline; returns overshoot."""
    lib = load()
    if lib is not None:
        return float(lib.sph_pace_until(ctypes.c_double(deadline_monotonic_s)))
    while True:
        now = time.monotonic()
        if now >= deadline_monotonic_s:
            return now - deadline_monotonic_s
        time.sleep(min(max(deadline_monotonic_s - now - 2e-4, 0.0), 0.01) or 0.0)


def read_gravity_sysfs(device_dir: str, g_mag: float):
    """MPU6050 sysfs read via C; returns (gx, gy) or None on failure."""
    lib = load()
    if lib is None:
        return None
    gx = ctypes.c_float()
    gy = ctypes.c_float()
    rc = lib.sph_read_gravity(device_dir.encode(), ctypes.c_float(g_mag),
                              ctypes.byref(gx), ctypes.byref(gy))
    if rc != 0:
        return None
    return float(gx.value), float(gy.value)
