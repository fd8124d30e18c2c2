"""runner.dispatch_host_ms: mean host wall time of the port's
runner.dispatch span (SimRunner._dispatch) in the traced window, in ms."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    return program.mean_ms(run.trace, program.spans(), "runner.dispatch")
