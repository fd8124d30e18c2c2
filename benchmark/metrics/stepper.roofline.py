"""stepper.roofline: the least time the card needs for one tick's work
(kick-drift, density and forces over the pairs within 2H of the window's
last state; roofline.tick_work) over the device time of a tick outside its
relayout: the operations launched inside the dispatch but neither inside
the relayout nor inside the renderer, per tick dispatched, in %."""

import importlib

roofline = importlib.import_module("benchmark.roofline")


def read(run):
    tr = run.trace
    if tr is None or not run.ticks_run:
        return None
    mask = (tr.in_window() & tr.under("runner.dispatch")
            & ~tr.under("stepper.relayout") & ~tr.under("render.frame"))
    if not mask.any():
        return None
    per_tick_s = tr.device_ns(mask) / run.ticks_run * 1e-9
    return 100.0 * roofline.least_s(*roofline.tick_work(run.pairs)) / per_tick_s
