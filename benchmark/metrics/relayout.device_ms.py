"""relayout.device_ms: device time of the operations launched inside the
relayout (WindowEngine._relayout) per relayout, in ms, from the trace."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n = tr.count("stepper.relayout")
    if not n:
        return None
    return tr.device_ns(tr.under("stepper.relayout") & tr.in_window()) / n * 1e-6
