"""stepper.launches_per_tick: CUDA kernel launches of the traced window
(every kernel, the renderer's and the stats' included; copies and fills
are not kernels) per tick dispatched."""


def read(run):
    tr = run.trace
    if tr is None or not run.ticks_run:
        return None
    n = int((tr.is_kernel & tr.in_window()).sum())
    return n / run.ticks_run if n else None
