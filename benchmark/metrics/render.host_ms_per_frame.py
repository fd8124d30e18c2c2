"""render.host_ms_per_frame: host wall time of the renderer call
(WindowRenderer.render_from_frame) per frame, in ms, from the trace's
spans."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    d = tr.span_ns("render.frame")
    return float(d.mean()) * 1e-6 if d.size else None
