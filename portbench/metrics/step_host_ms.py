"""Host milliseconds a step inside the pool's ``pool.step`` range less
its ``pool.fetch`` range: the whole host cost of putting a step on the
card, over the traced steps."""


def read(run):
    if run.trace is None:
        return None
    step = run.trace.host_ms("pool.step")
    return None if step is None else step - (run.trace.host_ms("pool.fetch") or 0.0)
