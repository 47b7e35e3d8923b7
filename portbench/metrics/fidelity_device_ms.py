"""Device milliseconds a step of the kernels and copies launched from
inside the ``fidelity.*`` ranges (linked to their launch by the
profiler's correlation ids), over the traced steps."""


def read(run):
    return None if run.trace is None else run.trace.device_ms("fidelity.")
