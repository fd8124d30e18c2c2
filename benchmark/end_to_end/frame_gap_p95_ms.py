"""frame_gap_p95_ms: the 95th percentile of the wall gap between
consecutive frames handed to the display sink, over every frame of the
window (host clock): the stutter a user watching the display sees."""

import numpy as np


def read(run):
    t = np.asarray(run.frame_times)
    if t.shape[0] < 3:
        return None
    return float(np.percentile(np.diff(t), 95.0)) * 1e3
