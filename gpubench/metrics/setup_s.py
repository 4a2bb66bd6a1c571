"""``setup_s``: seconds from the process's start to the window's: imports,
CUDA start-up, loading (or, in a fresh checkout, building) the kernels, the
data pool and the warm-up fits."""


def read(run):
    return run.setup_s
