"""setup.settle_s: host seconds of the runner's damped settle (the port's
runner.settle span: the exact ticks of the pre-roll and their one drain)
in set-up."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    return program.settle_s(program.spans())
