"""setup_s (host clock): seconds from the process's start to the window's
start: imports, the CUDA context, the chromosomes made from the seed, the
kernel library's build or load, and one warm-up scan of every group."""


def read(run):
    return run.setup_s
