"""Gravity sources — the input side of the host I/O shell.

A copy of `pi_sph_fluid_tpu/io/gravity.py:28-175` for the port (framework-free host code).

The reference polls an MPU6050 accelerometer over sysfs at 10 Hz from a
pthread and shares a bare float2 with the sim loop (`pi_sph_fluid.c:431-464`);
without hardware it uses constant (0, -G) (`pi_sph_fluid.c:441-444`).

Here a gravity source is an iterator-style object: ``source.trace(k, dt)``
returns a (k, 2) float32 gravity trace for the next k sim-steps, which the
run loop feeds into one device dispatch — the sensor is sampled per *batch*
rather than per step, replacing the unsynchronized shared float2 with an
explicit value hand-off (no races to reason about, SURVEY.md §5).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from ..config import SPHConfig

__all__ = ["ConstantGravity", "TraceGravity", "RotatingGravity",
           "MPU6050Gravity", "WebGravity"]


class ConstantGravity:
    """The no-hardware default: (0, -G) (`pi_sph_fluid.c:441-444`)."""

    def __init__(self, cfg: SPHConfig, gx: float | None = None, gy: float | None = None):
        self.g = np.asarray(
            [0.0 if gx is None else gx, -cfg.g if gy is None else gy], np.float32
        )

    is_constant = True

    def current(self) -> np.ndarray:
        return self.g

    def trace(self, k: int, dt: float) -> np.ndarray:
        return np.broadcast_to(self.g, (k, 2)).copy()


class TraceGravity:
    """Replays a recorded (T, 2) gravity trace sampled at ``sample_hz``
    (e.g. a captured MPU6050 session) as per-step gravity vectors
    (BASELINE.json config 3)."""

    def __init__(self, samples: np.ndarray, sample_hz: float = 10.0, loop: bool = True):
        self.samples = np.asarray(samples, np.float32).reshape(-1, 2)
        self.sample_hz = float(sample_hz)
        self.loop = loop
        self._t = 0.0

    def current(self) -> np.ndarray:
        idx = int(self._t * self.sample_hz)
        n = len(self.samples)
        idx = idx % n if self.loop else min(idx, n - 1)
        return self.samples[idx]

    def trace(self, k: int, dt: float) -> np.ndarray:
        t = self._t + np.arange(k, dtype=np.float64) * dt
        idx = (t * self.sample_hz).astype(np.int64)
        n = len(self.samples)
        idx = idx % n if self.loop else np.minimum(idx, n - 1)
        self._t += k * dt
        return self.samples[idx]


class RotatingGravity:
    """Synthetic tilt: gravity vector rotating at ``period_s`` per turn —
    a hardware-free stand-in for sloshing demos."""

    def __init__(self, cfg: SPHConfig, period_s: float = 4.0):
        self.g_mag = float(cfg.g)
        self.period = float(period_s)
        self._t = 0.0

    def current(self) -> np.ndarray:
        a = 2 * math.pi * self._t / self.period
        return np.asarray([self.g_mag * math.sin(a), -self.g_mag * math.cos(a)], np.float32)

    def trace(self, k: int, dt: float) -> np.ndarray:
        t = self._t + np.arange(k, dtype=np.float64) * dt
        a = 2 * math.pi * t / self.period
        self._t += k * dt
        return np.stack([self.g_mag * np.sin(a), -self.g_mag * np.cos(a)], axis=1).astype(np.float32)


class WebGravity:
    """Browser tilt via the web display's ``POST /gravity`` — the MPU6050
    analog for the live-browser demo (the reference's tilt-to-slosh
    interactivity, `pi_sph_fluid.c:431-464`, with the page's pointer/device
    orientation standing in for the accelerometer).

    The sink stores the latest unit-disc tilt vector; ``current`` scales it
    by G — the same shape as the reference's raw/2^14 * G projection
    (`pi_sph_fluid.c:439-440`), with the unit-disc clamp standing in for a
    resting accelerometer's |a| <= 1 g.  Like ``MPU6050Gravity``, a batch
    trace holds the latest sample: every step between posts sees the same
    vector.  Before the first post: the hardware-free (0, -G).
    """

    def __init__(self, cfg: SPHConfig, sink):
        self.g_mag = float(cfg.g)
        self.sink = sink   # io.web.WebSink (anything with .tilt())

    def current(self) -> np.ndarray:
        tilt = self.sink.tilt()
        if tilt is None:
            return np.asarray([0.0, -self.g_mag], np.float32)
        return (tilt * self.g_mag).astype(np.float32)

    def trace(self, k: int, dt: float) -> np.ndarray:
        return np.broadcast_to(self.current(), (k, 2)).copy()


class MPU6050Gravity:
    """Real accelerometer via Linux sysfs IIO, polled at 10 Hz from a daemon
    thread (`pi_sph_fluid.c:431-464`).

    Replicates the reference's projection: gx = +accel_y/2^14 * G,
    gy = -accel_x/2^14 * G (`pi_sph_fluid.c:439-440`).  The trace for a
    batch holds the latest sample — matching the reference, where all steps
    between 10 Hz polls see the same vector.
    """

    def __init__(self, cfg: SPHConfig,
                 device_path: str = "/sys/bus/iio/devices/iio:device0",
                 poll_hz: float = 10.0):
        self.g_mag = float(cfg.g)
        self.path = device_path
        self.poll_s = 1.0 / poll_hz
        self._g = np.asarray([0.0, -self.g_mag], np.float32)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._read()  # fail fast if the device is absent
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _read(self):
        from .native import read_gravity_sysfs

        native = read_gravity_sysfs(self.path, self.g_mag)
        if native is not None:
            g = np.asarray(native, np.float32)
        else:
            with open(f"{self.path}/in_accel_x_raw") as f:
                ax = int(f.read())
            with open(f"{self.path}/in_accel_y_raw") as f:
                ay = int(f.read())
            g = np.asarray(
                [ay / (1 << 14) * self.g_mag, -ax / (1 << 14) * self.g_mag], np.float32
            )
        with self._lock:
            self._g = g

    def _run(self):
        while not self._stop.is_set():
            time.sleep(self.poll_s)
            try:
                self._read()
            except OSError:
                pass  # transient sysfs read failure: keep last value

    def stop(self):
        self._stop.set()

    def current(self) -> np.ndarray:
        with self._lock:
            return self._g.copy()

    def trace(self, k: int, dt: float) -> np.ndarray:
        return np.broadcast_to(self.current(), (k, 2)).copy()
