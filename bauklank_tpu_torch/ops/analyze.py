"""Monitoring analysis ops: oscilloscope buckets, spectrum, level meters.

Port of ``bauklank_tpu/ops/analyze.py``: the servable form of the
reference's (disabled) Scope visualizer, as batched tensor ops a monitoring
client requests over the control plane.  They run on the device of the
signal they are given.
"""

from __future__ import annotations

import math

import torch

__all__ = ["scope_buckets", "spectrum_db", "levels", "analyze_signal"]


def scope_buckets(signal: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Min/max envelope per display bucket (oscilloscope rendering).

    signal: [..., T] -> [..., n_buckets, 2] (min, max per bucket).
    """
    t = signal.shape[-1]
    per = t // n_buckets
    x = signal[..., : per * n_buckets].reshape(signal.shape[:-1] + (n_buckets, per))
    return torch.stack([torch.amin(x, dim=-1), torch.amax(x, dim=-1)], dim=-1)


def spectrum_db(signal: torch.Tensor, n_fft: int = 2048, floor_db: float = -120.0) -> torch.Tensor:
    """Averaged magnitude spectrum in dB over Hann-windowed frames.

    signal: [..., T] -> [..., n_fft//2 + 1].  A signal shorter than one
    frame reads its last sample past its end, as the JAX gather clamps."""
    t = signal.shape[-1]
    hop = n_fft // 2
    n_frames = max(1, (t - n_fft) // hop + 1)
    dev = signal.device
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :]).clamp_max(t - 1)
    frames = signal[..., idx]                                  # [..., n_frames, n_fft]
    n = torch.arange(n_fft, dtype=torch.float32, device=dev)
    win = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)
    spec = torch.fft.rfft(frames * win, dim=-1)
    power = torch.mean(torch.abs(spec) ** 2, dim=-2)
    ref = (torch.sum(win) / 2.0) ** 2
    return 10.0 * torch.log10(torch.clamp_min(power / ref, 10.0 ** (floor_db / 10.0)))


def levels(signal: torch.Tensor) -> dict:
    """Per-channel rms and peak (dBFS-able raw linear values).

    signal: [..., T] -> {"rms": [...], "peak": [...]}
    """
    return {
        "rms": torch.sqrt(torch.mean(torch.square(signal), dim=-1)),
        "peak": torch.amax(torch.abs(signal), dim=-1),
    }


def analyze_signal(slot: str, sig: torch.Tensor, sample_rate: float,
                   n_buckets: int = 128) -> dict:
    """The ``analyze`` reply for one voice's last chunk ``sig`` [C, n]:
    scope of the channel mean, its spectrum over the largest power-of-two
    frame (16 to 2048 samples) and per-channel levels, rounded as the JAX
    pools round them.  Computed on the signal's device, one copy to the
    host."""
    mono = torch.mean(sig, dim=0)
    n = int(mono.shape[-1])
    n_fft = min(1 << max(4, n.bit_length() - 1), 2048)
    scope = scope_buckets(mono, min(n_buckets, n)).cpu().numpy()
    spectrum = spectrum_db(mono, n_fft=n_fft).cpu().numpy()
    lv = {k: v.cpu().numpy() for k, v in levels(sig).items()}
    return {
        "slot": slot,
        "scope": [[round(float(a), 5), round(float(b), 5)] for a, b in scope],
        "spectrum": [round(float(v), 1) for v in spectrum],
        "spectrumHzPerBin": sample_rate / n_fft,
        "levels": {
            "rms": [round(float(v), 6) for v in lv["rms"]],
            "peak": [round(float(v), 6) for v in lv["peak"]],
        },
    }
