"""Host milliseconds a step inside the fidelity step's four ranges
(``fidelity.analyse``, ``.chain_inputs``, ``.hop_loop``,
``.synthesis``): the cost of launching its work, over the traced steps."""


def read(run):
    return None if run.trace is None else run.trace.host_ms("fidelity.")
