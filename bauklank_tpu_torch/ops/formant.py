"""Spectral-envelope (formant) estimation and shift for the fast engine.

Port of ``bauklank_tpu/ops/formant.py``.  The envelope is a
Gaussian-smoothed power spectrum, computed in the quefrency domain (an
FFT along the band axis times a Gaussian transfer function whose width is
per stream and per hop); ``formant_gain`` turns the formant controls into
a per-band magnitude gain, reading the envelope through the pitch map's
gather (kernel 5).  The FFTs along the band axis run on cuFFT on the GPU
and on pocketfft (``scipy.fft``) on the CPU, the FFT the JAX package's
CPU backend runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bauklank_tpu_torch.ops.mdft import cabs
from bauklank_tpu_torch.ops.pitchmap import gather_fractional_real, unmap_freq

__all__ = ["rfft", "irfft", "spectral_envelope", "detect_f0_bands", "formant_gain"]

_EPS = 1e-9


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real FFT over the last axis: cuFFT on the GPU, pocketfft on the CPU."""
    if x.device.type != "cpu":
        return torch.fft.rfft(x, dim=-1)
    import scipy.fft

    return torch.from_numpy(np.ascontiguousarray(scipy.fft.rfft(x.numpy(), axis=-1)))


def irfft(z: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT of length ``n`` over the last axis."""
    if z.device.type != "cpu":
        return torch.fft.irfft(z, n=n, dim=-1)
    import scipy.fft

    return torch.from_numpy(np.ascontiguousarray(
        scipy.fft.irfft(z.resolve_conj().numpy(), n=n, axis=-1)))


def spectral_envelope(power: torch.Tensor, sigma_bands) -> torch.Tensor:
    """Gaussian-smooth a power spectrum along the last (band) axis.

    power [..., bins] nonnegative; sigma_bands a scalar or [...] std-dev
    in bands.  Reflection-pads to 2*bins (no circular wrap), then applies
    the Gaussian's transfer function in the FFT domain."""
    bins = power.shape[-1]
    ext = torch.cat([power, power.flip(-1)], dim=-1)
    spec = rfft(ext)
    q = torch.arange(spec.shape[-1], dtype=torch.float32, device=power.device)
    sig = torch.as_tensor(sigma_bands, dtype=torch.float32, device=power.device)
    if sig.dim():
        sig = sig[..., None]
    g = torch.exp(-2.0 * (math.pi ** 2) * (sig ** 2) * (q ** 2) / float((2 * bins) ** 2))
    sm = irfft(spec * g, 2 * bins)[..., :bins]
    return torch.clamp_min(sm, 0.0)


def detect_f0_bands(power: torch.Tensor, max_band: int | None = None) -> torch.Tensor:
    """Per-hop fundamental estimate in bands: the cepstral peak of the
    log-power spectrum over quefrencies [8, bins/2].  power [..., bins]
    -> [...]."""
    bins = power.shape[-1]
    ceps = cabs(rfft(torch.log(power + _EPS)))
    q = torch.arange(ceps.shape[-1], dtype=torch.float32, device=power.device)
    mask = (q >= 8.0) & (q <= bins / 2.0)
    qpk = torch.argmax(torch.where(mask, ceps, -torch.inf), dim=-1).to(torch.float32)
    spacing = bins / torch.clamp_min(qpk, 1.0)
    return torch.clamp(spacing, 1.0, float(bins // 4 if max_band is None else max_band))


def formant_gain(env, band_freqs, source_pos, formant_factor, compensation,
                 transpose_factor, tonality_limit, block: int,
                 max_gain: float = 16.0) -> torch.Tensor:
    """Per-band magnitude gain realizing the formant controls.

    env [S, ..., bins] input envelope (power); band_freqs [bins];
    source_pos [S, bins] (the pitch map's read positions, whose envelope
    is the natural post-shift one); the controls [S, 1].  The target
    envelope position is ``f_out / formant_factor`` with compensation on,
    ``unmap(f_out / formant_factor)`` with it off; the gain is
    sqrt(target / natural), clipped, exactly 1 with factor 1 and
    compensation off."""
    ff = torch.clamp_min(formant_factor, 1e-6)
    f_t = band_freqs / ff
    f_uncomp = unmap_freq(f_t, transpose_factor, tonality_limit)
    f_target = compensation * f_t + (1.0 - compensation) * f_uncomp
    pos_t = f_target * float(block) - 0.5
    env_nat = gather_fractional_real(env, source_pos, oob="clamp")
    env_tgt = gather_fractional_real(env, pos_t, oob="clamp")
    gain = torch.sqrt((env_tgt + _EPS) / (env_nat + _EPS))
    return torch.clamp(gain, 0.0, max_gain)
