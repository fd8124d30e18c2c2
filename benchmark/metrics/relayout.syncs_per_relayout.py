"""relayout.syncs_per_relayout: CUDA runtime synchronisations whose host
time lies inside one of the port's stepper.relayout spans
(WindowEngine._relayout_order) of the traced window, per such span."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    return program.syncs_per_span(run.trace, program.spans(), "stepper.relayout")
