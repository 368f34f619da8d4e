"""setup_s (s, host clock): from the start of the run's process to the
start of the window: the imports, CUDA's context, the kernel libraries'
load (their build, in a checkout's first run), the cell's data and its
warm-up calls."""


def read(record):
    return record.setup_s
