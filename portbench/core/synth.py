"""Seeded synthetic music, one track per voice, made on the device.

Each voice is a harmonic tone (a few partials of a fundamental that
glides slowly, with a note envelope that never falls silent) and noise
bursts as percussion.  The two channels are decorrelated: each has its
own detune, partial phases and noise.  Tonal content is what the
engines' peak maps and phase chains work on.

Everything is drawn with one ``torch.Generator`` on the device, in a few
large calls a group of voices; the phase is computed in closed form in
float64, so nothing accumulates along the track.
"""

from __future__ import annotations

import math

import torch

DEFAULTS = dict(partials=6, f0_lo=80.0, f0_hi=600.0, glide_depth=(0.005, 0.04),
                glide_period_s=(3.0, 12.0), note_period_s=(0.3, 1.6), note_decay_s=(0.1, 0.6),
                burst_period_s=(0.25, 1.0), burst_decay_s=(0.01, 0.05), burst_level=(0.05, 0.3),
                peak=0.5, group=8)


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)


def make_audio(voices: int, channels: int, samples: int, sample_rate: float, seed: int,
               device) -> torch.Tensor:
    """[voices, channels, samples] float32 on ``device``."""
    p = DEFAULTS
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    t = torch.arange(samples, device=device, dtype=torch.float64) / sample_rate
    out = torch.empty((voices, channels, samples), dtype=torch.float32, device=device)
    k = torch.arange(1, p["partials"] + 1, device=device, dtype=torch.float64)
    for v0 in range(0, voices, p["group"]):
        g = min(p["group"], voices - v0)
        f0 = torch.exp(_u(gen, (g, 1, 1), math.log(p["f0_lo"]), math.log(p["f0_hi"]), device))
        det = 1.0 + _u(gen, (g, channels, 1), -0.003, 0.003, device)
        depth = _u(gen, (g, 1, 1), *p["glide_depth"], device)
        omega = 2.0 * math.pi / _u(gen, (g, 1, 1), *p["glide_period_s"], device)
        psi = _u(gen, (g, 1, 1), 0.0, 2.0 * math.pi, device)
        # phase of f(t) = f0 (1 + depth sin(omega t + psi)), in closed form
        base = 2.0 * math.pi * f0 * det * (
            t - depth / omega * (torch.cos(omega * t + psi) - torch.cos(psi)))   # [g, C, T]
        amps = k.pow(-_u(gen, (g, 1, 1), 0.7, 1.5, device))                      # [g, 1, P]
        ph0 = _u(gen, (g, channels, p["partials"]), 0.0, 2.0 * math.pi, device)
        tone = torch.zeros((g, channels, samples), dtype=torch.float64, device=device)
        for j in range(p["partials"]):
            tone += amps[..., j:j + 1] * torch.sin(torch.remainder(
                base * k[j] + ph0[..., j:j + 1], 2.0 * math.pi))
        per = _u(gen, (g, 1, 1), *p["note_period_s"], device)
        off = _u(gen, (g, 1, 1), 0.0, 1.0, device) * per
        env = 0.3 + 0.7 * torch.exp(-torch.remainder(t + off, per)
                                   / _u(gen, (g, 1, 1), *p["note_decay_s"], device))
        bper = _u(gen, (g, 1, 1), *p["burst_period_s"], device)
        boff = _u(gen, (g, 1, 1), 0.0, 1.0, device) * bper
        benv = _u(gen, (g, 1, 1), *p["burst_level"], device) * torch.exp(
            -torch.remainder(t + boff, bper) / _u(gen, (g, 1, 1), *p["burst_decay_s"], device))
        noise = torch.randn((g, channels, samples), generator=gen, device=device,
                            dtype=torch.float32)
        x = (tone * env).float() + benv.float() * noise
        x *= p["peak"] / x.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-12)
        out[v0:v0 + g] = x
    return out
