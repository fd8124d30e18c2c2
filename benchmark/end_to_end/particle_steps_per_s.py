"""particle_steps_per_s: fluid particles times the ticks the window
committed, over the window's wall time (host clock).  Time lost to reverts
and replays counts in the wall time; replayed ticks do not count as work."""


def read(run):
    return run.n_fluid * run.ticks_committed / run.window_s
