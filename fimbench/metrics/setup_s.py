"""Process start to the first timed request: imports, CUDA start, loading
the kernels (building them in a checkout's first run), the data and the
warm-up."""


def read(run):
    return run.setup_s
