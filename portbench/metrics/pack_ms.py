"""Host milliseconds a step inside the pool's ``pool.pack`` range (its
time-map sampling into the packed step array), over the traced steps."""


def read(run):
    return None if run.trace is None else run.trace.host_ms("pool.pack")
