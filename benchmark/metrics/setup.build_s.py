"""setup.build_s: host seconds of set-up spent building what the window
runs, from the port's own spans: runner.build (engine, span tables,
multi-steps, renderer), kernels.load (the kernel library's build or load)
and runner.prime (the step-0 pass), before the first dispatch, their union
where they nest."""

import importlib

program = importlib.import_module("benchmark.program")
program.begin()


def read(run):
    return program.setup_build_s(program.spans())
