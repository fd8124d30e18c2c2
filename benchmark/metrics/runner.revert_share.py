"""runner.revert_share: the share of the ticks the traced window ran that
the runner's reverts threw away, in %: the ``ticks`` of the port's
runner.recover spans (SimRunner.run, one a revert: the ticks run since the
checkpoint, replays included) that open inside the window, over the
window's ticks run.  None for a port that does not count them (no
``runner.ticks_reverted`` counter)."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    if run.trace is None or program.TRACER is None or not run.ticks_run:
        return None
    if "runner.ticks_reverted" not in program.TRACER.counters:
        return None
    recovers = program.in_window(program.spans() or [], "runner.recover", run.trace.window)
    return 100.0 * sum(s.attrs["ticks"] for s in recovers) / run.ticks_run
