"""Plain reference of the fast (hop-parallel) engine, in float64 PyTorch.

Written from the JAX package's per-hop NumPy renderer (``refdsp``, the
engine's executable specification), with the arithmetic carried here and
driven per hop: N independent streams, each with its own controls and
its own analysis frame ends, the carried state (band rotation, last
mapped spectrum, overlap-add tail) passed in and returned.  It runs on
the device of the tensors it is given and imports nothing of the
program.

Per hop, for frame end ``e``:

1. cur and prev: MDFTs of the analysis-windowed frames ending at ``e``
   and at ``e - interval``, zero-phase referenced;
2. each output band reads its source band through the tonality-limited
   transpose map, by linear interpolation (zeros outside);
3. the band's rotation advances by the phase change of the previous
   hop's mapped spectrum against this one, and by 2 pi f_out I plus the
   measured deviation of the source from its band centre, scaled by the
   map's gradient;
4. out = rot * cur_m * lobe gain; inverse MDFT, synthesis window,
   overlap-add.

``rnd`` is applied to every stage's result: the identity for the
reference, a rounding to a lower precision for the control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

F64, C128 = torch.float64, torch.complex128
# no formant chain here: a cell whose traffic sets a formant control is
# refused at set-up (core/cell.py)
FORMANTS = False


def _ident(x):
    return x


class Geometry:
    """The engine's sizes, from a configuration file's ``geometry``."""

    def __init__(self, channels: int, block: int, interval: int, sample_rate: float,
                 split: bool = True):
        self.channels, self.block, self.interval = channels, block, interval
        self.sample_rate = float(sample_rate)
        self.bins = block // 2
        self.out_lat = block // 2 + (interval if split else 0)
        # the time map is read at each output frame's centre
        self.centre = block // 2


def geometry(config: dict) -> Geometry:
    g = config["geometry"]
    return Geometry(config["channels"], g["block"], g["interval"], config["sample_rate"],
                    g.get("split_computation", True))


@functools.lru_cache(maxsize=8)
def windows(block: int, interval: int):
    """(analysis, synthesis) windows: a periodic-centred Kaiser whose
    beta follows the overlap, and its partner normalised so that the
    product overlap-adds to one."""
    ov = max(2.0, block / max(1, interval))
    beta = float(np.pi * np.sqrt(max(ov * ov / 4.0 - 1.0, 0.0)))
    k = (np.arange(block) + 0.5) / block * 2.0 - 1.0
    wa = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - k * k))) / np.i0(beta)
    acc = np.zeros(interval)
    sq = wa * wa
    for start in range(0, block, interval):
        seg = sq[start:start + interval]
        acc[: seg.shape[0]] += seg
    norm = np.tile(acc, (block + interval - 1) // interval)[:block]
    return wa, wa / norm


@functools.lru_cache(maxsize=8)
def lobe_alpha(block: int, interval: int) -> float:
    """|G(x bins)| ~ exp(-alpha x^2) of the analysis window, at x = 1."""
    wa, _ = windows(block, interval)
    n = np.arange(block)
    g0 = np.abs(np.sum(wa))
    g1 = np.abs(np.sum(wa * np.exp(-2j * np.pi * (1.0 / block) * (n - (block - 1) / 2.0))))
    return float(-np.log(max(g1 / g0, 1e-6)))


def _mdft(x):
    n = x.shape[-1]
    m = torch.arange(n, dtype=F64, device=x.device)
    return torch.fft.fft(x * torch.polar(torch.ones_like(m), -np.pi * m / n), dim=-1)[..., : n // 2]


def _imdft(spec, n: int):
    z = torch.zeros(spec.shape[:-1] + (n,), dtype=C128, device=spec.device)
    z[..., : n // 2] = spec
    m = torch.arange(n, dtype=F64, device=spec.device)
    return 2.0 * (torch.fft.ifft(z, dim=-1) * torch.polar(torch.ones_like(m), np.pi * m / n)).real


def _unit(z, eps=1e-20):
    zr = z + eps
    return zr / zr.abs()


def _frame(audio, start, block: int, voices):
    """Stream ``i`` reads track ``voices[i]`` of audio [V, C, T]: start
    [N] -> [N, C, block]; zeros outside [0, T)."""
    t = audio.shape[-1]
    idx = start[:, None] + torch.arange(block, device=audio.device)
    ok = (idx >= 0) & (idx < t)
    got = audio[voices[:, None], :, idx.clamp(0, t - 1)]                 # [N, block, C]
    return torch.where(ok[..., None], got.to(F64), 0.0).permute(0, 2, 1)


def _gather_lin(spec, pos):
    """Linear interpolation of spec [N, C, bins] at pos [N, bins]; zeros outside."""
    n, c, bins = spec.shape
    f0 = torch.floor(pos)
    i0 = f0.to(torch.int64)
    w = (pos - f0)[:, None]

    def at(i):
        ok = ((i >= 0) & (i < bins))[:, None]
        v = torch.gather(spec, 2, i.clamp(0, bins - 1)[:, None].expand(n, c, bins))
        return torch.where(ok, v, 0.0)

    return at(i0) * (1.0 - w) + at(i0 + 1) * w


def init_state(geo: Geometry, n: int, device) -> dict:
    return dict(rot=torch.ones((n, geo.bins), dtype=C128, device=device),
                prev_cur=torch.zeros((n, geo.channels, geo.bins), dtype=C128, device=device),
                tail=torch.zeros((n, geo.channels, geo.block), dtype=F64, device=device))


def state_from_program(geo: Geometry, tree, device) -> dict:
    """The program's carried state (fields by name) -> this module's form."""
    t = lambda x, dt: torch.from_numpy(np.asarray(x)).to(device=device, dtype=dt)
    return dict(rot=t(tree["rot"], C128), prev_cur=t(tree["prev_cur"], C128),
                tail=t(tree["ola_tail"], F64))


def step(geo: Geometry, state: dict, audio, ends, ctl: dict, voices=None, rnd=_ident):
    """H hops of N streams.  audio [V, C, T], stream ``i`` reading track
    ``voices[i]`` (default: track i); ends [N, H] frame ends; ctl: rate,
    semitones, tonality_hz, active [N] (float64 tensors).  Returns
    (state, emitted [N, C, H * interval]); an inactive stream updates its
    state and emits silence."""
    b, i = geo.block, geo.interval
    n, h = ends.shape
    dev = audio.device
    voices = torch.arange(n, device=dev) if voices is None else voices
    wa, ws = (torch.from_numpy(w).to(dev) for w in windows(b, i))
    alpha = lobe_alpha(b, i)
    bins = geo.bins
    tf = (2.0 ** (ctl["semitones"] / 12.0))[:, None]                  # [N, 1]
    ton = (ctl["tonality_hz"] / geo.sample_rate)[:, None]
    limit = torch.where(ton > 0, ton / torch.sqrt(torch.clamp_min(tf, 1e-12)), 0.5)
    f_out = ((torch.arange(bins, dtype=F64, device=dev) + 0.5) / b)[None]
    below = f_out <= limit * tf
    f_in = torch.where(below, f_out / torch.clamp_min(tf, 1e-12), f_out - limit * (tf - 1.0))
    pos = f_in * b - 0.5
    grad = torch.where(below, tf, 1.0)
    two_pi_i = 2.0 * np.pi * i
    sign = torch.where(torch.arange(bins, device=dev) % 2 == 0, 1.0, -1.0).to(F64)
    cphase = torch.complex(torch.zeros_like(sign), sign)

    rot, prev_cur = state["rot"], state["prev_cur"]
    out = torch.zeros((n, geo.channels, h * i + b), dtype=F64, device=dev)
    out[..., :b] = state["tail"]
    for k in range(h):
        e = ends[:, k]
        cur = rnd(_mdft(rnd(_frame(audio, e - b, b, voices) * wa)) * cphase)
        prev = rnd(_mdft(rnd(_frame(audio, e - i - b, b, voices) * wa)) * cphase)
        cur_m = rnd(_gather_lin(cur, pos))
        prev_m = rnd(_gather_lin(prev, pos))
        w = _unit((cur_m * torch.conj(prev_m)).sum(1))
        dev_h = rnd(torch.angle(w * torch.polar(torch.ones_like(f_in), -two_pi_i * f_in)))
        corr_a = (prev_cur * torch.conj(cur_m)).sum(1)
        v = _unit(corr_a) * torch.polar(torch.ones_like(dev_h),
                                        two_pi_i * f_out + grad * dev_h)
        v = torch.where(corr_a.abs() > 1e-12, v, torch.ones_like(v))
        rot = rnd(rot * v)
        delta = dev_h * (b / (2.0 * np.pi * i))
        gain = torch.clamp(torch.exp(-alpha * (grad ** 2 - 1.0) * delta ** 2), 0.05, 4.0)
        spec = rot[:, None] * cur_m * gain[:, None]
        frame = rnd(_imdft(spec * torch.conj(cphase), b) * ws)
        out[..., k * i: k * i + b] += frame
        prev_cur = cur_m
    emit = rnd(out[..., : h * i] * (ctl["active"] > 0)[:, None, None])
    new = dict(rot=_unit(rot), prev_cur=prev_cur, tail=out[..., h * i: h * i + b])
    return new, emit


def state_parts(state: dict) -> dict:
    """What the carried state is compared by: the last hop's output
    spectrum as the state implies it (rotation times mapped spectrum), and
    the overlap-add tail."""
    return dict(state_spectrum=state["rot"][:, None] * state["prev_cur"],
                state_tail=state["tail"])
