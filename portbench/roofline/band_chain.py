"""Kernel 4, the sequential band chain (``csrc/bandchain.cu``): the least
time one call could take at the cell's shapes, from the function's
contract.  One call renders one hop of every stream: lead [9, B, S],
chan [C, 6, B, S] in, out [C, 2, B, S] out, each read or written once;
26 float32 operations a band and stream for the leader and 25 for each
channel; and the dependent chain, 19 operations of at least 4 cycles a
band, one band after the other.  The least time is the largest of the
three (a floor: the card runs a band's step in more cycles)."""

from portbench.core import peaks

KERNEL = "band_chain_kernel"
CHAIN_DEPTH = 19


def least_seconds(run) -> float:
    b, s, c = run.geo.bands, run.voices, run.geo.channels
    nbytes = 4 * (9 * b * s + 6 * c * b * s + 2 * c * b * s)
    ops = b * s * (26 + 25 * c)
    chain = b * CHAIN_DEPTH * peaks.DEP_CYCLES / peaks.BOOST_HZ
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_OPS_PER_S, chain)
