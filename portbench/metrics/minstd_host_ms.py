"""Host milliseconds a step inside the fidelity step's ``fidelity.minstd``
range (every hop's MINSTD seed, its draw streams and the state carried
out, on steps outside the deterministic regime), over the traced steps.
None where the program has no such range."""


def read(run):
    return None if run.trace is None else run.trace.host_ms("fidelity.minstd")
