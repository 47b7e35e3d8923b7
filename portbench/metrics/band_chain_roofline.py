"""Kernel 4's share of its roofline: the least time a call could take
(``roofline/band_chain.py``) over its traced device time a call, in %."""


def read(run):
    got = run.roofline("band_chain")
    return None if got is None else 100.0 * got[0] / got[1]
