"""Host milliseconds a step inside the fast step's four ranges
(``fast.analyse``, ``.hop_factors``, ``.rotation_scan``, ``.synthesis``),
over the traced steps."""


def read(run):
    return None if run.trace is None else run.trace.host_ms("fast.")
