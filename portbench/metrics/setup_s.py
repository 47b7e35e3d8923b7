"""Set-up: from the start of the process to the first timed step, less
the kernel library's build or load (reported apart as ``kernel_build_s``)."""


def read(run):
    return run.setup_s
