"""runner.syncs_per_dispatch: CUDA runtime synchronisations whose host time
lies inside one of the port's runner.dispatch spans (SimRunner._dispatch:
K ticks and a frame, enqueued) of the traced window, per dispatch."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    return program.syncs_per_span(run.trace, program.spans(), "runner.dispatch")
