"""Device milliseconds a step of the kernels and copies launched from
inside the ``fast.*`` ranges, over the traced steps."""


def read(run):
    return None if run.trace is None else run.trace.device_ms("fast.")
