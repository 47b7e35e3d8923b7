"""FFT-size grid used by :class:`engine.config.StretchConfig`.

``fast_fft_size(n)`` returns the smallest size >= n of the form
``2^a * k`` with ``k in {1, 3, 7, 9, 21}``.  The JAX package chose this
grid for the TPU's FFT; the port keeps it unchanged so that a
``StretchConfig`` rounds its block exactly as the reference package does
(``bauklank_tpu/ops/fftsize.py`` holds the original rationale).
"""

from __future__ import annotations

import functools

__all__ = ["fast_fft_size"]

_ODD_PARTS = (1, 3, 7, 9, 21)


@functools.lru_cache(maxsize=256)
def fast_fft_size(n: int) -> int:
    n = max(2, int(n))
    best = None
    for k in _ODD_PARTS:
        m = k
        while m < n:
            m *= 2
        if best is None or m < best:
            best = m
    return best
