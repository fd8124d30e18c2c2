"""kernel.forces_roofline: the least time the card needs for one forces
pass over the pairs within 2H of the window's last state (roofline.py:
39 FLOPs a pair, each fluid row's bytes once, each wall row in reach once),
over the profiler's mean device time of one forces_window_kernel launch,
in %."""

import importlib

import numpy as np

roofline = importlib.import_module("benchmark.roofline")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    mask = tr.in_window() & np.array(["forces_window_kernel" in n for n in tr.names], bool)
    if not mask.any():
        return None
    per_launch_s = tr.device_ns(mask) / int(mask.sum()) * 1e-9
    return 100.0 * roofline.least_s(*roofline.pass_work("forces", run.pairs)) / per_launch_s
