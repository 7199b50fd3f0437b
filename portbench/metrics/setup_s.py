"""setup_s: process start to the first timed call: imports, the kernel
library's load (its build on a checkout's first run), input generation
and one warm-up call."""


def read(run):
    return run.setup_s
