"""Frequency band mapping with tonality limit, and unit-phase helpers.

Port of ``bauklank_tpu/ops/pitchmap.py``.  Below the tonality limit
frequencies are multiplied by the transpose factor; above it they are
offset by a constant, so the map stays continuous and noisy highs keep
their character.  Frequencies are in cycles/sample (Nyquist = 0.5).

The functions are elementwise and broadcast: batched callers pass the
per-stream factor and limit as ``[S, 1]``.  The two gathers read every
row of stream ``s`` at that stream's positions through kernel 5,
``banded_interp`` (x ``[S, P, bins]``, pos ``[S, bins_out]``; complex
spectra through its interleaved entry point, with no planar copy), in
place of ``_interp_real``'s tiled matmuls and its TPU branch.  Where the
window of 768 (+128) bands covers a tile's taps this is the exact linear
interpolation; below about -31 semitones a tile spans more than the
window and its outer taps read 0, as in both JAX forms (ROADMAP "Faults
found").
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels.interp import TILE, banded_interp, banded_interp_complex
from bauklank_tpu_torch.ops.mdft import cabs

__all__ = [
    "effective_tonality_limit",
    "map_freq",
    "unmap_freq",
    "source_positions",
    "gather_fractional",
    "gather_fractional_real",
    "unit",
]

_EPS = 1e-12
WINDOW = 768  # input bands one 128-band output tile may read (+128 alignment slack)


def effective_tonality_limit(factor: torch.Tensor, tonality: torch.Tensor) -> torch.Tensor:
    """``tonality / sqrt(factor)`` (the limit split between input and
    output frequency space); ``tonality <= 0`` disables it (Nyquist)."""
    lim = tonality * (1.0 / torch.sqrt(torch.clamp_min(factor, _EPS)))
    return torch.where(tonality > 0, lim, 0.5)


def map_freq(freq_in, factor, limit):
    """Input frequency -> output frequency (multiply below limit, offset above)."""
    return torch.where(freq_in <= limit, freq_in * factor, freq_in + limit * (factor - 1.0))


def unmap_freq(freq_out, factor, limit):
    """Output frequency -> source input frequency (inverse of map_freq)."""
    return torch.where(freq_out <= limit * factor,
                       freq_out / torch.clamp_min(factor, _EPS),
                       freq_out - limit * (factor - 1.0))


def source_positions(band_freqs: torch.Tensor, factor, limit, block: int):
    """(pos, dfreq): the fractional input band read by each output band and
    ``f_out - f_in`` in cycles/sample, float32."""
    f_in = unmap_freq(band_freqs, factor, limit)
    pos = f_in * float(block) - 0.5
    return pos.to(torch.float32), (band_freqs - f_in).to(torch.float32)


def _tile_padded(pos: torch.Tensor) -> torch.Tensor:
    """pos [S, bins_out] padded to whole 128-band tiles by repeating the
    last position (the padded tile stays monotone), contiguous."""
    pad = (-pos.shape[-1]) % TILE
    if pad:
        pos = torch.cat([pos, pos[:, -1:].expand(pos.shape[0], pad)], dim=1)
    return pos.contiguous()


def gather_fractional_real(x: torch.Tensor, pos: torch.Tensor, oob: str = "clamp") -> torch.Tensor:
    """Linear interpolation of a real array along its last axis: x [S, ...,
    bins], pos [S, bins_out] monotone -> [S, ..., bins_out].  ``oob="zero"``
    reads out-of-range positions as 0 (spectra), ``"clamp"`` clips the
    positions to [0, bins - 1] first (envelopes)."""
    s_n, bins = x.shape[0], x.shape[-1]
    bo = pos.shape[-1]
    if oob == "clamp":
        pos = torch.clamp(pos, 0.0, float(bins - 1))
    out = banded_interp(x.reshape(s_n, -1, bins).contiguous(), _tile_padded(pos), WINDOW)
    return out[..., :bo].reshape(x.shape[:-1] + (bo,))


def gather_fractional(spec: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Complex linear interpolation of spectra at fractional band positions:
    spec [S, ..., bins] complex64, pos [S, bins_out]; out-of-range reads 0.
    The rows stay interleaved (re, im) through the kernel: no planar copy
    of the spectra and none of the result."""
    s_n, bins = spec.shape[0], spec.shape[-1]
    bo = pos.shape[-1]
    x = torch.view_as_real(spec.reshape(s_n, -1, bins).resolve_conj().contiguous())
    out = torch.view_as_complex(banded_interp_complex(x, _tile_padded(pos), WINDOW))
    return out[..., :bo].reshape(spec.shape[:-1] + (bo,))


def unit(z: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """z / |z| with a graceful zero limit (-> 1+0j as |z| -> 0): silent
    bands yield the identity rotation.  The division is by the real
    magnitude, part by part (XLA's complex division by a real-valued
    complex64, value for value)."""
    zr = z + eps
    mag = cabs(zr)
    return torch.complex(zr.real / mag, zr.imag / mag)
