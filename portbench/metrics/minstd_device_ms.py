"""Device milliseconds a step of the kernels launched from inside the
``fidelity.minstd`` range (linked to their launch by the profiler's
correlation ids), over the traced steps.  None where the program has no
such range."""


def read(run):
    return None if run.trace is None else run.trace.device_ms("fidelity.minstd")
