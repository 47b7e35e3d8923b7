"""Analysis/synthesis windows with enforced perfect reconstruction.

A copy (pure numpy) of ``bauklank_tpu/ops/windows.py`` for the fast
engine: ``pr_window_pair`` returns an (analysis, synthesis) pair such that
``sum_k analysis[n-kH] * synthesis[n-kH] == 1`` for every sample ``n`` in
steady state, so identity processing reconstructs its input up to float
rounding whatever the window family.
"""

from __future__ import annotations

import numpy as np

from bauklank_tpu_torch.utils.metrics import table_cache

__all__ = ["kaiser", "kaiser_beta_for_overlap", "pr_window_pair", "ola_norm"]


def kaiser_beta_for_overlap(block: int, interval: int) -> float:
    """Kaiser beta from the block/interval ratio: main-lobe bandwidth
    ``b ~= overlap`` bins, ``beta = pi * sqrt(max(b^2/4 - 1, 0))``."""
    overlap = block / max(1, interval)
    b = max(2.0, overlap)
    return float(np.pi * np.sqrt(max(b * b / 4.0 - 1.0, 0.0)))


@table_cache(maxsize=64)
def _kaiser_cached(n: int, beta: float) -> np.ndarray:
    # symmetric Kaiser sampled at k + 0.5 ("periodic-centered"): frame
    # centres at (block - 1) / 2 + 0.5, no zero endpoints
    k = (np.arange(n) + 0.5) / n * 2.0 - 1.0  # in (-1, 1)
    win = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - k * k))) / np.i0(beta)
    return win.astype(np.float64)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window of length ``n`` (float64 numpy; cast at use site)."""
    return _kaiser_cached(int(n), float(beta))


def ola_norm(window_product: np.ndarray, interval: int) -> np.ndarray:
    """Per-sample overlap-add sum ``sum_k w[n - k*interval]`` (steady
    state), periodic with period ``interval``."""
    n = window_product.shape[0]
    acc = np.zeros(interval, dtype=np.float64)
    for start in range(0, n, interval):
        seg = window_product[start: start + interval]
        acc[: seg.shape[0]] += seg
    return np.tile(acc, (n + interval - 1) // interval)[:n]


def pr_window_pair(block: int, interval: int, beta: float | None = None):
    """(analysis, synthesis) float32 windows with exact COLA at ``interval``:
    analysis = kaiser(beta); synthesis = analysis / ola_norm(analysis^2)."""
    if beta is None:
        beta = kaiser_beta_for_overlap(block, interval)
    w = kaiser(block, beta)
    norm = ola_norm(w * w, interval)
    synth = w / norm
    return w.astype(np.float32), synth.astype(np.float32)
