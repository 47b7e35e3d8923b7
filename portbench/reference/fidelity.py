"""Plain reference of the fidelity (blob-exact) engine, in float64 PyTorch.

A frozen plain copy of the per-hop form of the port's fidelity step: one
hop of every stream at a time, as ``engine/spectral.py:spectral_hop``
runs it and ``engine/fidelity.py:_scan_hops`` loops it, with the plain
versions of the kernels written out here (the windowed frame fetch, the
compensated prefix sum, the fractional row gather, the sequential band
chain).  It follows the arithmetic of the algorithm, not the port's
rounding: every quantity is float64 (complex128), the smoother is a
direct one-pole recursion, the prefix sums are plain ``cumsum``.  It
runs on the device of the tensors it is given and imports nothing of
the program.

One call renders ``H`` hops of ``N`` independent streams from their
carried state: the analyses of the frames ending at ``ends``, the hop
chain (peaks map, the formant chain, MINSTD vertical steps, predictions,
the band chain), then the synthesis and the overlap-add with the carried
tail.

The formant chain (the blob's step 5, the port's
``engine/spectral.py:chain_inputs_drawn`` written per hop) runs for a
stream that is formant-active: its formant factor is not 1, or it
compensates and transposes.  Its envelope is the square root of the
hop's channel-summed energy, smoothed by the two-pass smoother with one
coefficient a stream, ``1 / (width / 2 + 1)``; the width is the given
base's (``base * fft - 0.5``), or with base 0 the tracked f0's: the top
three local maxima of the energy, two harmonic folds, and 1/16 EMAs of
the peak and of the peak times its band (the trackers, carried in the
state), advanced hop after hop only where the stream is active.  The
envelope is read at the formant-mapped frequency, and the squared ratio
of the two is a gain on the channel energies that the predictions
gather; the peaks map reads the energy before the gain, as the port's
does.  A stream that is not active gets the gain 1 and frozen trackers,
and a step in which no stream is active, or that is given no formant
control, runs no chain: it returns the same bits as without one.
Departures from the port: the peak pick takes float64 energies, so it
can pick another band than the program's float32 at a near-tie.

``rnd`` is applied to every stage's result: the identity for the
reference, a rounding to a lower precision for the control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.signal import lfilter
from scipy.special import i0 as bessel_i0

EPS = 1e-15                 # the blob's noise floor
MINSTD_M = 2147483647       # 2^31 - 1
MINSTD_A = 48271
F64, C128 = torch.float64, torch.complex128
# the formant chain is here: a cell may set the formant controls
FORMANTS = True
# the blob's epsilon in the formant ratio: the float32 of the bits 0x0DA24260
FORMANT_TINY = float(np.frombuffer(np.uint32(0x0DA24260).tobytes(), np.float32)[0])


def _ident(x):
    return x


def fft_size_for(block: int) -> int:
    """Smallest ``2^a * m >= block`` with ``m`` in {1, 3, 5}."""
    best = None
    for m in (1, 3, 5):
        size = m
        while size < block:
            size *= 2
        best = size if best is None else min(best, size)
    return best


class Geometry:
    """The engine's sizes, from a configuration file's ``geometry``."""

    def __init__(self, channels: int, block: int, interval: int, sample_rate: float,
                 split: bool = True):
        self.channels, self.block, self.interval = channels, block, interval
        self.sample_rate = float(sample_rate)
        self.split = split
        self.fft = fft_size_for(block)
        self.bands = self.fft // 2
        self.long_step = int(round(self.fft / interval))
        # output latency in samples, and where in a hop the time map is read
        self.out_lat = (block - block // 2) + (interval if split else 0)
        self.centre = 0


def geometry(config: dict) -> Geometry:
    g = config["geometry"]
    return Geometry(config["channels"], g["block"], g["interval"], config["sample_rate"],
                    g.get("split_computation", True))


@functools.lru_cache(maxsize=8)
def blob_window(block: int, interval: int) -> np.ndarray:
    """The blob's analysis/synthesis window: periodic-centred Kaiser with
    the overlap's bandwidth law, normalised so that sum_h w^2(n - h I) = 1."""
    ov = block / interval
    bw = ov + 8.0 / (ov + 3.0) ** 2 + max(3.0 - ov, 0.0) / 4.0
    beta = np.pi * np.sqrt(bw * bw / 4.0 - 1.0)
    n = np.arange(block)
    x = 2.0 * (n + 0.5) / block - 1.0
    k = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / bessel_i0(beta)
    s = np.zeros(block)
    hops = block // interval + 2
    for h in range(-hops, hops + 1):
        idx = n - h * interval
        ok = (idx >= 0) & (idx < block)
        s[ok] += k[idx[ok]] ** 2
    return k / np.sqrt(s)


def _window(geo: Geometry, dev) -> torch.Tensor:
    return torch.from_numpy(blob_window(geo.block, geo.interval)).to(dev)


def _phase(bands: int, shift: float, fft: int, dev) -> torch.Tensor:
    """e^{i 2 pi (b + 1/2) shift / fft}."""
    b = torch.arange(bands, dtype=F64, device=dev)
    return torch.polar(torch.ones_like(b), 2.0 * np.pi * (b + 0.5) * shift / fft)


def frames(audio, starts, block: int, voices) -> torch.Tensor:
    """Stream ``i`` reads track ``voices[i]`` of audio [V, C, T]: starts
    [N, F] -> [N, F, C, block]; zeros outside [0, T)."""
    t = audio.shape[-1]
    idx = starts[..., None] + torch.arange(block, device=audio.device)     # [N, F, block]
    ok = (idx >= 0) & (idx < t)
    got = audio[voices[:, None, None], :, idx.clamp(0, t - 1)]            # [N, F, block, C]
    return torch.where(ok[..., None], got.to(F64), 0.0).permute(0, 1, 3, 2)


def mdft(x):
    """X[k] = sum_n x[n] e^{-2 pi i (k + 1/2) n / N}, k < N/2."""
    n = x.shape[-1]
    m = torch.arange(n, dtype=F64, device=x.device)
    return torch.fft.fft(x * torch.polar(torch.ones_like(m), -np.pi * m / n), dim=-1)[..., : n // 2]


def imdft(spec, n: int):
    """x[n] = (2/N) Re sum_k X[k] e^{+2 pi i (k + 1/2) n / N}."""
    z = torch.zeros(spec.shape[:-1] + (n,), dtype=C128, device=spec.device)
    z[..., : n // 2] = spec
    m = torch.arange(n, dtype=F64, device=spec.device)
    return 2.0 * (torch.fft.ifft(z, dim=-1) * torch.polar(torch.ones_like(m), np.pi * m / n)).real


def analyse(geo: Geometry, audio, ends, voices, rnd=_ident):
    """Zero-phase referenced spectra of the frames ending at ``ends``
    [N, F]: [N, F, C, bands]."""
    dev = audio.device
    fr = rnd(frames(audio, ends - geo.block, geo.block, voices) * _window(geo, dev))
    padded = torch.nn.functional.pad(fr, (0, geo.fft - geo.block))
    return rnd(mdft(padded) * _phase(geo.bands, geo.block // 2, geo.fft, dev))


def synthesise(geo: Geometry, specs, rnd=_ident):
    """[..., bands] -> synthesis-windowed frames [..., block]."""
    dev = specs.device
    spec = specs * torch.conj(_phase(geo.bands, geo.block // 2, geo.fft, dev))
    return rnd(imdft(spec, geo.fft)[..., : geo.block] * _window(geo, dev))


# ------------------------------------------------------------- one hop
def _smooth(e, coef, carry):
    """The blob's two-pass one-pole smoother (backward, then forward from
    the backward pass's first value): y_b = y_prev + coef (e_b - y_prev).
    e [N, B], carry [N], ``coef`` a float or a tensor [N] of one a row ->
    (smoothed [N, B], carry [N]); a direct recursion
    (``scipy.signal.lfilter``) on the host."""
    x, c = e.cpu().numpy(), carry.cpu().numpy()
    if torch.is_tensor(coef):
        fwd = np.concatenate([_smooth_rows(x[i:i + 1], k, c[i:i + 1])
                              for i, k in enumerate(coef.tolist())] or [x])
    else:
        fwd = _smooth_rows(x, coef, c)
    out = torch.from_numpy(np.ascontiguousarray(fwd)).to(e.device)
    return out, out[:, -1]


def _smooth_rows(x, coef: float, c):
    b, a = [coef], [1.0, -(1.0 - coef)]
    bwd, _ = lfilter(b, a, x[:, ::-1], axis=-1, zi=((1.0 - coef) * c)[:, None])
    bwd = bwd[:, ::-1]
    fwd, _ = lfilter(b, a, bwd, axis=-1, zi=((1.0 - coef) * bwd[:, :1]))
    return fwd


def _smooth_twice(e, coef):
    """The two chained smoothers, the second from the first's carry."""
    sm, carry = _smooth(e, coef, torch.zeros(e.shape[0], dtype=F64, device=e.device))
    return _smooth(sm, coef, carry)[0]


def peaks_map(energy, smoothed, mult, limit, fft: int):
    """findPeaks + outputMap: maximal runs where energy > smoothed, each
    run's energy-weighted mean band mapped through the transpose, then a
    smoothstep map between adjacent peaks (a translation outside the end
    peaks).  energy, smoothed [N, B]; mult, limit [N].  Returns
    (input_bin [N, B], grad [N, B])."""
    n, bands = energy.shape
    dev = energy.device
    b_idx = torch.arange(bands, dtype=F64, device=dev)
    above = energy > smoothed
    no = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    starts = above & ~torch.cat([no, above[:, :-1]], dim=1)
    ends = above & ~torch.cat([above[:, 1:], no], dim=1)
    w = torch.where(above, energy, 0.0)
    zero = torch.zeros((n, 1), dtype=F64, device=dev)
    cs_e = torch.cat([zero, torch.cumsum(w, dim=1)], dim=1)
    cs_eb = torch.cat([zero, torch.cumsum(w * b_idx, dim=1)], dim=1)
    n_peaks = starts.sum(dim=1)
    slots = max(int(n_peaks.max()) if n else 0, 1)
    rs, cs = torch.nonzero(starts, as_tuple=True)
    _, ce = torch.nonzero(ends, as_tuple=True)
    rank = torch.cumsum(starts.to(torch.int64), dim=1)[rs, cs] - 1
    sum_e = cs_e[rs, ce + 1] - cs_e[rs, cs]
    sum_eb = cs_eb[rs, ce + 1] - cs_eb[rs, cs]
    center = torch.zeros((n, slots), dtype=F64, device=dev)
    center[rs, rank] = sum_eb / torch.clamp_min(sum_e, 1e-30)
    valid = torch.arange(slots, device=dev)[None] < n_peaks[:, None]
    f_in = (center + 0.5) / fft
    m, lim = mult[:, None], limit[:, None]
    f_out = torch.where(f_in > lim, f_in + (m - 1.0) * lim, f_in * m)
    out_bin = f_out * fft - 0.5
    # idx[b] = the number of peaks whose output bin is <= b
    u = torch.where(valid, torch.clamp(torch.ceil(out_bin), 0, bands), float(bands))
    hist = torch.zeros((n, bands + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, u.to(torch.int64), torch.ones((n, slots), dtype=torch.int64,
                                                       device=dev))
    idx = torch.cumsum(hist, dim=1)[:, :bands]
    cap = torch.clamp_min(n_peaks - 1, 0)[:, None]
    i_p = torch.minimum(torch.clamp_min(idx - 1, 0), cap)
    i_q = torch.minimum(idx, cap)
    p_in, p_out = torch.gather(center, 1, i_p), torch.gather(out_bin, 1, i_p)
    q_in, q_out = torch.gather(center, 1, i_q), torch.gather(out_bin, 1, i_q)
    interior = (idx > 0) & (idx < n_peaks[:, None])
    a_in = torch.where(idx <= 0, center[:, :1], p_in)
    a_out = torch.where(idx <= 0, out_bin[:, :1], p_out)
    span = q_out - p_out
    safe = torch.where(span.abs() > 1e-30, span, 1.0)
    t = (b_idx[None] - p_out) / safe
    dd = (q_in - p_in) - span
    ib_mid = (p_in - p_out) + b_idx[None] + t * t * (3.0 - 2.0 * t) * dd
    gr_mid = 1.0 + 6.0 * t * (1.0 - t) * dd / safe
    ib_ext = (a_in - a_out) + b_idx[None]
    input_bin = torch.where(interior, ib_mid, ib_ext)
    grad = torch.where(interior, gr_mid, 1.0)
    has = (n_peaks > 0)[:, None]
    return torch.where(has, input_bin, b_idx[None]), torch.where(has, grad, 1.0)


@functools.lru_cache(maxsize=8)
def _powers(n_draws: int) -> np.ndarray:
    """a^(k+1) mod (2^31 - 1), k < n_draws, exact."""
    out, p = np.empty(n_draws, np.int64), 1
    for k in range(n_draws):
        p = p * MINSTD_A % MINSTD_M
        out[k] = p
    return out


def _vertical_steps(seq, tf):
    """(d_down, d_up) [N, B]: the deterministic clamp(tf, 0.5, 2) where
    tf <= 2; the blob's MINSTD steps where tf > 2 (band 0 draws only up,
    interior bands down then up, the last band only down)."""
    t = tf[:, None]
    v32 = torch.clamp_min(t, 0.5)
    v45 = torch.where(v32 > 2.0, 4.0, 0.0) - v32
    vals = (v32 - v45) * 2.0 ** -31 * (seq - 1).to(F64) + v45
    zero = torch.zeros_like(vals[:, :1])
    dd = torch.cat([zero, vals[:, 1::2]], dim=1)
    du = torch.cat([vals[:, 0::2], zero], dim=1)
    det = torch.clamp(t, 0.5, 2.0)
    use = t > 2.0
    return torch.where(use, dd, det), torch.where(use, du, det)


def _shift(a, k: int):
    """a[..., k:] followed by k zeros."""
    return torch.cat([a[..., k:], torch.zeros_like(a[..., :k])], dim=-1)


def _gather(x, pos):
    """Linear interpolation of x [N, C, B] at pos [N, K]; zeros outside [0, B)."""
    n, c, b = x.shape
    f0 = torch.floor(pos)
    i0 = f0.to(torch.int64)
    frac = (pos - f0)[:, None]

    def at(i):
        ok = ((i >= 0) & (i < b))[:, None]
        v = torch.gather(x, 2, i.clamp(0, b - 1)[:, None].expand(n, c, i.shape[-1]))
        return torch.where(ok, v, 0.0)

    return at(i0) * (1.0 - frac) + at(i0 + 1) * frac


def band_chain(d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input, long_step,
               rnd=_ident):
    """The sequential Gauss-Seidel chain over bands: each band's leader
    (the channel of most predicted energy) takes the phase of its
    prediction from the band below and the band ``long_step`` below, at
    the predicted magnitude; the other channels are phase-locked to it.
    Leader operands [N, B], channel operands [N, C, B]; returns [N, C, B].
    The loop over bands runs in NumPy on the host (its steps are small)."""
    dev = pred_energy.device
    n, c, bands = pred_energy.shape
    t1 = lambda a: np.ascontiguousarray(np.moveaxis(a.resolve_conj().cpu().numpy(), -1, 0))
    d1, d2, u12, pe_mc, pi_mc, mc = map(t1, (d1, d2, u12, pe_mc, pi_mc, mc))
    lock, pec, pic = map(t1, (lock, pred_energy, pred_input))          # [B, N, C]
    q = (lambda x: x) if rnd is _ident else (
        lambda x: rnd(torch.from_numpy(x)).numpy())
    out = np.zeros((bands, n, c), np.complex128)
    flat = out.reshape(bands, n * c)
    lead_at = np.arange(n)[None] * c + mc                                # [B, N] in flat rows
    for b in range(bands):
        li = lead_at[b]
        ph = u12[b]
        if b >= 1:
            ph = ph + flat[b - 1].take(li) * d1[b]
        if b >= long_step:
            ph = ph + flat[b - long_step].take(li) * d2[b]
        p2 = ph.real * ph.real + ph.imag * ph.imag
        tiny = p2 <= EPS
        if tiny.any():
            ph = np.where(tiny, pi_mc[b], ph)
            p2 = np.where(tiny, np.abs(pi_mc[b]) ** 2 + EPS, p2)
        om = np.sqrt(pe_mc[b] / p2) * ph                                  # [N]
        cc = om[:, None] * lock[b]                                        # [N, C]
        c2 = cc.real * cc.real + cc.imag * cc.imag
        tc = c2 <= EPS
        if tc.any():
            cc = np.where(tc, pic[b], cc)
            c2 = np.where(tc, np.abs(pic[b]) ** 2 + EPS, c2)
        o = (np.sqrt(pec[b] / c2) * cc).reshape(-1)
        o[li] = om
        flat[b] = q(o)
    return torch.from_numpy(np.moveaxis(out, 0, -1)).to(dev)              # [N, C, B]


def formant_peak(env_e):
    """The auto-f0 tracker's look at one hop of N streams: env_e [N, B] ->
    (peak value [N], folded band [N] int64).  The blob scans the bands in
    order keeping the three largest local maxima (``v >= left`` and ``v >
    right``), seeded with three copies of band 0; a band enters only above
    the third, and a tie keeps the earlier band first.  That is the first
    three of the seeds and then the candidates, in band order, sorted
    stably by value from the largest.  Then the two harmonic folds."""
    n, bands = env_e.shape
    dev = env_e.device
    v = env_e[:, 1:-1]
    cand = (v >= env_e[:, :-2]) & (v > env_e[:, 2:])
    vals = torch.cat([env_e[:, :1].expand(n, 3), torch.where(cand, v, -torch.inf)], dim=1)
    band = torch.cat([torch.zeros(3, dtype=torch.int64, device=dev),
                      torch.arange(1, bands - 1, device=dev)])
    top = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :3]
    (pv, e2, e4), (i5, i2, i4) = torch.gather(vals, 1, top).T, band[top].T
    do1 = e2 > pv * 0.1
    d1 = (i5 - i2).abs()
    fold1 = do1 & ~((d1 <= i5 // 8) | (d1 >= (i5 * 7) // 8))
    i5 = torch.where(fold1, i5 % torch.clamp_min(d1, 1), i5)
    do2 = do1 & (e4 > pv * 0.01)
    d2 = (i5 - i4).abs()
    fold2 = do2 & ~((d2 <= i5 // 8) | (d2 >= (i5 * 7) // 8))
    return pv, torch.where(fold2, i5 % torch.clamp_min(d2, 1), i5)


def formant_active(mult, factor, compensation):
    """Whether each stream runs the formant chain: a formant factor that
    is not 1, or compensation of a transposition."""
    return (factor != 1.0) | ((compensation != 0.0) & (mult != 1.0))


def formant_gain(geo: Geometry, env_e, value_ema, weighted_ema, mult, limit, factor,
                 compensation, base, rnd=_ident):
    """The formant chain of one hop of N streams: env_e [N, B] the
    channel-summed energy, the trackers and the controls [N].  Returns
    (gain [N, B] on the channel energies, value_ema, weighted_ema)."""
    bands, fft = env_e.shape[1], geo.fft
    active = formant_active(mult, factor, compensation)
    auto = base <= 0.0
    pv, band = formant_peak(env_e)
    move = active & auto
    value_ema = torch.where(move, value_ema + (pv - value_ema) * 0.0625, value_ema)
    weighted_ema = torch.where(move, weighted_ema + (pv * band - weighted_ema) * 0.0625,
                               weighted_ema)
    width = torch.where(auto, weighted_ema / (value_ema + FORMANT_TINY), base * fft - 0.5)
    sm = rnd(_smooth_twice(torch.sqrt(env_e), 1.0 / (width * 0.5 + 1.0)))
    freq = (torch.arange(bands, dtype=F64, device=env_e.device)[None] + 0.5) / fft
    m, lim, f = mult[:, None], limit[:, None], factor[:, None]
    # compensation looks the envelope up where the transposition put the band
    fr = torch.where(compensation[:, None] != 0.0,
                     torch.where(freq > lim, freq + (m - 1.0) * lim, freq * m), freq)
    fm = fr / f
    fm = torch.where(fm > lim, (1.0 - f) * lim + fr, fm)
    pos = fm * fft - 0.5
    env_m = torch.where(pos < 0.0, 0.0, _gather(sm[:, None], pos)[:, 0])
    gain = torch.where(active[:, None], (env_m / (sm + FORMANT_TINY)) ** 2, 1.0)
    return rnd(gain), value_ema, weighted_ema


def hop(geo: Geometry, state: dict, cur, prev, tf, mult, limit, rnd=_ident, formant=None):
    """One hop of N streams: state (prev_output [N, C, B], prev_pred_energy
    [N, C, B], rng [N], the formant trackers [N]), this hop's analyses cur
    and prev [N, C, B], and the controls [N]; ``formant`` the formant
    factor, compensation and base [N], or None for no formant chain.
    Returns (state, out [N, C, B])."""
    n, c, bands = cur.shape
    dev = cur.device
    L = geo.long_step
    b_idx = torch.arange(bands, dtype=F64, device=dev)

    energy_c = cur.abs() ** 2
    energy = rnd(energy_c.sum(1))                                         # [N, B]
    coef = 1.0 / (0.5 * (geo.fft / geo.interval) + 1.0)
    sm = _smooth_twice(energy, coef)
    ib_m, gr_m = peaks_map(energy, rnd(sm), mult, limit, geo.fft)
    trackers = state["f_value_ema"], state["f_weighted_ema"]
    if formant is not None:
        gain, *trackers = formant_gain(geo, energy, *trackers, mult, limit, *formant, rnd)
        energy_c = energy_c * gain[:, None]

    use = tf > 2.0
    n_draws = 2 * bands - 2
    seed = state["rng"]
    if bool(use.any()):
        seq = seed[:, None] * torch.from_numpy(_powers(n_draws)).to(dev)[None] % MINSTD_M
        new_rng = torch.where(use, seq[:, -1], seed)
    else:
        seq, new_rng = torch.ones((n, n_draws), dtype=torch.int64, device=dev), seed
    d_down, d_up = _vertical_steps(seq, tf)

    mapping = (mult != 1.0)[:, None]
    input_bin = rnd(torch.where(mapping, ib_m, b_idx[None]))
    grad = rnd(torch.where(mapping, gr_m, 1.0))
    families = [input_bin, input_bin - d_down, input_bin - d_down * L,
                _shift(input_bin, 1) - d_up, _shift(input_bin, L) - d_up * L]
    pred_input, down_s, down_l, us_g, ul_g = (rnd(_gather(cur, f)) for f in families)
    rot = _phase(bands, geo.interval, geo.fft, dev)
    prev_interp = rnd(_gather(prev * rot, input_bin))
    pe_raw = rnd(_gather(energy_c, input_bin))

    pred_energy = pe_raw * torch.clamp_min(grad, 0.0)[:, None]
    tw = pred_input * torch.conj(prev_interp)
    mc = torch.argmax(pred_energy, dim=1)                                 # [N, B]
    oh = torch.arange(c, device=dev)[None, :, None] == mc[:, None, :]
    sel = lambda a: torch.where(oh, a, 0.0).sum(1)
    k1 = torch.where(oh, torch.conj(_shift(pred_input, 1) * torch.conj(us_g)), 0.0)
    k2 = torch.where(oh, torch.conj(_shift(pred_input, L) * torch.conj(ul_g)), 0.0)
    pi_mc = sel(pred_input)
    d1 = rnd(sel(pred_input * torch.conj(down_s)))
    d2 = rnd(sel(pred_input * torch.conj(down_l)))
    lock = rnd(torch.conj(pi_mc[:, None] * torch.conj(pred_input)))

    den = torch.maximum(pred_energy, state["prev_pred_energy"]) + EPS
    timepred = state["prev_output"] * rot * tw / den
    u12 = rnd((_shift(timepred, 1) * k1).sum(1) + (_shift(timepred, L) * k2).sum(1))
    out = band_chain(d1, d2, u12, rnd(sel(pred_energy)), rnd(pi_mc), mc, lock,
                     rnd(pred_energy), pred_input, L, rnd)
    return dict(prev_output=out, prev_pred_energy=pred_energy, rng=new_rng,
                f_value_ema=trackers[0], f_weighted_ema=trackers[1]), out


# ------------------------------------------------------------ one step
def init_state(geo: Geometry, n: int, device, seed: int = 1) -> dict:
    """The engine's fresh state: silence carried, MINSTD seeded with
    ``seed``, the formant trackers at 0."""
    shape = (n, geo.channels, geo.bands)
    return dict(prev_output=torch.zeros(shape, dtype=C128, device=device),
                prev_pred_energy=torch.zeros(shape, dtype=F64, device=device),
                rng=torch.full((n,), seed, dtype=torch.int64, device=device),
                f_value_ema=torch.zeros(n, dtype=F64, device=device),
                f_weighted_ema=torch.zeros(n, dtype=F64, device=device),
                tail=torch.zeros((n, geo.channels, geo.block + geo.interval), dtype=F64,
                                 device=device))


def state_from_program(geo: Geometry, tree, device) -> dict:
    """The program's carried state, as nested NumPy (the spectral state's
    fields by name, then the overlap-add tails) -> this module's form."""
    spec, tail = tree
    t = lambda x, dt: torch.from_numpy(np.asarray(x)).to(device=device, dtype=dt)
    return dict(prev_output=t(spec["prev_output"], C128),
                prev_pred_energy=t(spec["prev_pred_energy"], F64),
                rng=t(spec["rng"], torch.int64), f_value_ema=t(spec["f_value_ema"], F64),
                f_weighted_ema=t(spec["f_weighted_ema"], F64), tail=t(tail, F64))


def controls(geo: Geometry, rate, semitones, tonality_hz):
    """(time factor, transpose factor, tonality limit) of each stream [N]."""
    tf = torch.clamp_max(1.0 / torch.clamp_min(rate, 1e-6), float(geo.interval))
    mult = 2.0 ** (semitones / 12.0)
    limit = (tonality_hz / geo.sample_rate) / torch.sqrt(mult)
    return tf, mult, limit


def step(geo: Geometry, state: dict, audio, ends, ctl: dict, voices=None, rnd=_ident):
    """H hops of N streams.  audio [V, C, T], stream ``i`` reading track
    ``voices[i]`` (default: track i); ends [N, H] frame ends; ctl: rate,
    semitones, tonality_hz, active [N] and, if given, formant_factor,
    formant_compensation and formant_base [N] (float64 tensors).  Returns
    (state, emitted [N, C, H * interval]); an inactive stream keeps its
    state and emits silence."""
    n, h = ends.shape
    dev = audio.device
    voices = torch.arange(n, device=dev) if voices is None else voices
    tf, mult, limit = controls(geo, ctl["rate"], ctl["semitones"], ctl["tonality_hz"])
    formant = None
    if "formant_factor" in ctl:
        formant = (ctl["formant_factor"], ctl["formant_compensation"], ctl["formant_base"])
        if not bool(formant_active(mult, *formant[:2]).any()):
            formant = None
    st, outs = state, []
    for i in range(h):
        e = ends[:, i:i + 1]
        specs = analyse(geo, audio, torch.cat([e, e - geo.interval], dim=1), voices, rnd)
        st, out = hop(geo, st, specs[:, 0], specs[:, 1], tf, mult, limit, rnd, formant)
        outs.append(out)
    frames_ = synthesise(geo, torch.stack(outs, dim=2), rnd)              # [N, C, H, block]
    interval, block = geo.interval, geo.block
    c = frames_.shape[1]
    ola = torch.zeros((n, c, h * interval + block + interval), dtype=F64, device=dev)
    lead = interval if geo.split else 0
    for i in range(h):
        ola[..., lead + i * interval: lead + i * interval + block] += frames_[:, :, i]
    ola[..., : block + interval] += state["tail"]
    active = ctl["active"] > 0
    emit = rnd(ola[..., : h * interval] * active[:, None, None])
    new = dict(st, tail=ola[..., h * interval:])
    keep = lambda a, b: torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return {k: keep(new[k], state[k]) for k in state}, emit


def state_parts(state: dict) -> dict:
    """What the carried state is compared by: the carried spectrum, the
    overlap-add tail, the MINSTD states and the formant trackers."""
    return dict(state_spectrum=state["prev_output"], state_tail=state["tail"],
                state_rng=state["rng"],
                state_formant=torch.stack([state["f_value_ema"], state["f_weighted_ema"]], 1))
