"""From the process's start to the window's start: imports, the kernels'
build or load, weights, frames, the warm-up and the checked first steps, s."""


def read(run):
    return run.setup_s
