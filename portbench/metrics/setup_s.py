"""setup_s: process start to the first timed round (host clock): the
imports, the inputs made from the seed, the build, the kernels' first
build in a fresh checkout, the warm-up and the capture."""


def read(run):
    return run.setup_s
