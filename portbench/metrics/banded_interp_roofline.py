"""Kernel 5's share of its roofline: the least time a call could take
(``roofline/banded_interp.py``) over its traced device time a call, in %."""


def read(run):
    got = run.roofline("banded_interp")
    return None if got is None else 100.0 * got[0] / got[1]
