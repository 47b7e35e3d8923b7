"""Kernel 5, the banded linear interpolation (``csrc/interp.cu``), as the
fast step calls it once a step: every voice's 2H analyses of C channels,
interleaved complex rows [S, 2HC, bins, 2], read at the voice's pitch-map
positions [S, bins].  From the function's contract at the cell's shapes:
each input element the positions address (floor(p) and floor(p) + 1
inside [0, bins)) read once, the positions read once, each output
written once; 3 float32 operations an output.  The least time is the
larger of bytes over the memory rate and operations over the float32
rate."""

import numpy as np

from portbench.core import peaks

KERNEL = "banded_interp_kernel"
TILE = 128


def _taps(semitones: float, bins: int, block: int, sample_rate: float,
          tonality_hz: float = 8000.0) -> int:
    """Distinct input bands one voice's positions address."""
    tf = 2.0 ** (semitones / 12.0)
    limit = tonality_hz / sample_rate / np.sqrt(tf)
    f_out = (np.arange(bins) + 0.5) / block
    f_in = np.where(f_out <= limit * tf, f_out / tf, f_out - limit * (tf - 1.0))
    i0 = np.floor(f_in * block - 0.5).astype(np.int64)
    taps = np.concatenate([i0, i0 + 1])
    return int(np.unique(taps[(taps >= 0) & (taps < bins)]).size)


def least_seconds(run) -> float:
    geo = run.geo
    bins, s = geo.bins, run.voices
    bins_out = -(-bins // TILE) * TILE
    width = 2 * run.hops * geo.channels * 2             # planes of a row, re and im
    need = sum(_taps(st, bins, geo.block, geo.sample_rate) for st in run.semitones) * width
    out = s * bins_out * width
    nbytes = 4 * (need + s * bins_out + out)
    return max(nbytes / peaks.HBM_BYTES_PER_S, 3 * out / peaks.FP32_OPS_PER_S)
