"""setup_s: seconds from the start of the process to the start of the
window: interpreter and CUDA context, the kernel library from build/ (built
there on a checkout's first run), the scene, the runner, its prime and the
pre-roll or warm chunk of the cell's own shapes (host clock)."""


def read(run):
    return run.setup_s
