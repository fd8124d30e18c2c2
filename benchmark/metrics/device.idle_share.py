"""device.idle_share: the share of the traced window in which no operation
runs on the device (the complement of the union of the device operations'
intervals on the profiler's timeline), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_ns <= 0 or not tr.names:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns)
