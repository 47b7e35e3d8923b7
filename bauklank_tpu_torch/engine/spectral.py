"""Blob-exact spectral hop — the reference engine's algorithm in PyTorch.

Port of ``bauklank_tpu/engine/spectral.py`` for the serving step: the
configuration and state types, MINSTD, the bidirectional smoother, the
peaks map, the formant chain, the hop-local stage (``chain_inputs_hops``)
and the packing of the sequential band chain.  One hop maps (carried
state, two analyses, controls) -> (new state, output spectrum):

1. rotate carried spectra to the new frame position,
2. peak-based frequency map (channel-summed energy -> two-pass one-pole
   smoothing -> maximal runs -> smoothstep output map with gradient),
3. per-channel predictions (interpolated energy/input, time-twist against
   the previous-interval analysis, shared stale prediction buffer),
4. sequential Gauss-Seidel phase propagation over bands with short (1) and
   long (round(fft/interval)) neighbours, max-energy channel leading and
   the other channels phase-locked to it (kernel 4),
5. formant processing where a voice asks for it: a gain on the channel
   energies from the smoothed spectral envelope looked up at the
   formant-mapped frequency, its smoothing width from the tracked f0 or
   from the given base.

Batch axes are written out: hop-local work runs on ``[H, S, ...]``
tensors, flattened to ``N = H * S`` rows for the peaks map and the
gathers.  The TPU forms of the JAX module (one-hot block gathers, the
MXU rank count, the uint32 limb MINSTD) are replaced by what they
compute: plain indexing, exact integer counts, int64 modular products.
The smoothing of step 2 (two chained bidirectional smoothers: four
affine scans) is kernel 8 (``smooth_pair``, one launch), the peaks map's
prefix sums kernel 2 (``comp_cumsum``), and the row gathers kernel 3
(``frac_gather``, two launches) or, in the deterministic regime with
``BAUKLANK_CHAINFETCH`` set, kernel 7 (``chainfetch``, one fused launch);
both give the same bits.  The formant envelope's smoothing is kernel 8
too, with one coefficient a row.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
from bauklank_tpu_torch.kernels.compsum import comp_cumsum
from bauklank_tpu_torch.kernels.smooth import smooth_pair
# the plain smoother (kernel 8's plain version chains two), held against
# JAX by the tests under the name it had here
from bauklank_tpu_torch.kernels.smooth import (  # noqa: F401
    smooth_bidirectional as _smooth_bidirectional)
from bauklank_tpu_torch.ops import mdft
from bauklank_tpu_torch.ops.gather import chainfetch, frac_gather
from bauklank_tpu_torch.ops.mdft import unit_phase
from bauklank_tpu_torch.utils.metrics import table_cache
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = [
    "EPS",
    "SpectralConfig",
    "SpectralState",
    "fft_size_for",
    "blob_window",
    "init_spectral_state",
    "spectral_hop",
    "spectral_hop_batched",
    "chain_inputs_hops",
    "chain_inputs_drawn",
    "minstd_hops",
    "band_chain_packed",
]

EPS = 1e-15  # the blob's noise floor (measured; pymodel.EPS)


def fft_size_for(block: int) -> int:
    """Smallest ``2^a * m >= block`` with ``m in {1, 3, 5}`` — the blob's
    measured FFT-size rule (docs/WASM-ALGO.md "Sizes")."""
    best = None
    for m in (1, 3, 5):
        size = m
        while size < block:
            size *= 2
        if best is None or size < best:
            best = size
    return best


@table_cache(maxsize=64)
def blob_window(block: int, interval: int) -> np.ndarray:
    """The blob's exact analysis/synthesis window (identical pair):
    periodic-centered Kaiser with the heuristic-optimal bandwidth law,
    per-sample forced-COLA normalized (sum_h w^2(n - h*interval) = 1)."""
    try:
        from scipy.special import i0 as bessel_i0
    except ImportError:  # pragma: no cover
        def bessel_i0(x):
            x = np.asarray(x, np.float64)
            out = np.zeros_like(x)
            term = np.ones_like(x)
            for m in range(1, 40):
                out += term
                term = term * (x / (2 * m)) ** 2
            return out + term

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
    return (k / np.sqrt(s)).astype(np.float64)


class SpectralConfig(NamedTuple):
    """Static shapes for the fidelity core.

    formants: run the blob's step-5 formant processing (with it off the
    formant arguments of a step are ignored).  split: splitComputation mode — only
    the frame drive differs (split-off zeroes the first interval of the
    prev-analysis window and places frames one interval earlier)."""

    channels: int
    block: int
    interval: int
    formants: bool = False
    split: bool = True

    @property
    def fft(self) -> int:
        return fft_size_for(self.block)

    @property
    def bands(self) -> int:
        return self.fft // 2

    @property
    def long_step(self) -> int:
        return int(round(self.fft / self.interval))


class SpectralState(NamedTuple):
    """Carried per-stream state; batch with leading axes."""

    prev_output: torch.Tensor       # [C, bands] complex64 — carried spectrum
    prev_pred_energy: torch.Tensor  # [C, bands] float32 — stale pred buffer
    rng: torch.Tensor               # [] int64 — MINSTD state (timeFactor > 2)
    f_value_ema: torch.Tensor       # [] f32 — formant f0 tracker (blob 6688)
    f_weighted_ema: torch.Tensor    # [] f32 — formant f0 tracker (blob 6684)


def init_spectral_state(cfg: SpectralConfig, device, seed: int = 1) -> SpectralState:
    # seed: the blob seeds from std::random_device at construction (reduced
    # mod 2^31-1, clamped >= 1); exactness tests pass an observed state
    shape = (cfg.channels, cfg.bands)
    return SpectralState(
        prev_output=torch.zeros(shape, dtype=torch.complex64, device=device),
        prev_pred_energy=torch.zeros(shape, dtype=torch.float32, device=device),
        rng=torch.tensor(int(seed), dtype=torch.int64, device=device),
        f_value_ema=torch.zeros((), dtype=torch.float32, device=device),
        f_weighted_ema=torch.zeros((), dtype=torch.float32, device=device),
    )


# ------------------------------------------------------------------ MINSTD
MINSTD_M = 2147483647  # 2^31 - 1 (Mersenne prime)
MINSTD_A = 48271


@table_cache(maxsize=16)
def _minstd_powers(n_draws: int) -> np.ndarray:
    """[n_draws] int64: 48271^(k+1) mod (2^31-1) for k = 0..n_draws-1."""
    out = np.empty(n_draws, np.int64)
    p = 1
    for k in range(n_draws):
        p = (p * MINSTD_A) % MINSTD_M
        out[k] = p
    return out


@table_cache(maxsize=32)
def _minstd_hop_powers(n_draws: int, n_hops: int) -> np.ndarray:
    """[n_hops + 1] int64: (48271^n_draws)^h mod (2^31-1) for h = 0..H —
    the per-hop seed advance (seed_h = s * (a^n)^h)."""
    a_n = pow(MINSTD_A, n_draws, MINSTD_M)
    out = np.empty(n_hops + 1, np.int64)
    p = 1
    for h in range(n_hops + 1):
        out[h] = p
        p = (p * a_n) % MINSTD_M
    return out


@table_cache(maxsize=32)
def _minstd_tables(n_draws: int, n_hops: int, device: torch.device):
    """(:func:`_minstd_powers`, :func:`_minstd_hop_powers`) on ``device``."""
    return (torch.from_numpy(_minstd_powers(n_draws)).to(device),
            torch.from_numpy(_minstd_hop_powers(n_draws, n_hops)).to(device))


def _modmul31(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod (2^31 - 1) in int64: exact, as both factors are below
    2^31 and their product below 2^62."""
    return (x * y) % MINSTD_M


def _minstd_steps(seq: torch.Tensor, time_factor: torch.Tensor):
    """Vertical time steps for a batch of hops: (d_down [.., B], d_up [.., B]).

    seq [.., 2B-2] int64 is the draw stream s·a^k mod M of each hop;
    time_factor [..] f32.  timeFactor <= 2: the deterministic
    clamp(tf, 0.5, 2) everywhere.  timeFactor > 2: the blob's MINSTD
    steps, value = f32((2·tf−4)·2⁻³¹·u32(s'−1) + (4−tf)); band 0 draws only
    UP, interior bands DOWN then UP, the last band only DOWN."""
    tf = time_factor.to(torch.float32)[..., None]
    v32 = torch.clamp_min(tf, 0.5)
    v45 = torch.where(v32 > 2.0, 4.0, 0.0) - v32
    v46 = (v32 - v45) * float(2.0 ** -31)
    vals = v46 * (seq - 1).to(torch.float32) + v45
    zero = torch.zeros_like(vals[..., :1])
    dd_rand = torch.cat([zero, vals[..., 1::2]], dim=-1)
    du_rand = torch.cat([vals[..., 0::2], zero], dim=-1)
    bts = torch.clamp(tf, 0.5, 2.0)
    use = tf > 2.0
    return torch.where(use, dd_rand, bts), torch.where(use, du_rand, bts)


# ------------------------------------------------------------ peaks map
def _comp_cumsum(x: torch.Tensor):
    """Compensated cumulative sum along axis 1 of x [N, B, K] ->
    (hi, lo) double-float32 pairs, as a sequential TwoSum fold (kernel 2,
    the TPU product path's order)."""
    hi, lo = comp_cumsum(x.permute(2, 1, 0).contiguous())   # [K, B, N]
    return hi.permute(2, 1, 0), lo.permute(2, 1, 0)


def _find_peaks_map_batched(energy, smoothed, mult, limit, bands: int, fft: int):
    """findPeaks + outputMap for N rows (docs/WASM-ALGO.md steps 4c-4d).

    energy, smoothed [N, B]; mult, limit [N].  Returns (input_bin [N, B],
    grad [N, B]).  Peaks are maximal runs where energy > smoothed; each
    run's inputBin is its energy-weighted mean band (compensated
    prefix-sum differences at the run boundaries).  The output map is a
    smoothstep blend between adjacent peaks with analytic gradient and a
    pure translation outside the end peaks.  The JAX form's MXU rank
    counts become exact integer counts and its one-hot block gathers plain
    indexing; every float operation keeps its order."""
    dev = energy.device
    n = energy.shape[0]
    b_idx = torch.arange(bands, dtype=torch.float32, device=dev)
    slots = (bands + 1) // 2       # maximal runs are >= 1 band apart
    above = energy > smoothed
    prev_above = torch.cat([torch.zeros_like(above[:, :1]), above[:, :-1]], dim=1)
    run_start = above & ~prev_above
    n_peaks = run_start.sum(1)                                   # [N]
    w = torch.where(above, energy, 0.0)

    cs_hi, cs_lo = _comp_cumsum(
        torch.stack([w, w * b_idx[None], run_start.to(torch.float32)], dim=-1))
    vals_cs = torch.cat([cs_hi[..., :2], cs_lo[..., :2]], dim=-1)  # [N, B, 4]

    # start_pos[s] = #(b : cum_starts[b] <= s); cum_starts is an exact,
    # nondecreasing integer cumsum
    c_start = cs_hi[..., 2].to(torch.int64).contiguous()
    grid = torch.arange(slots, device=dev).expand(n, slots).contiguous()
    start_pos = torch.searchsorted(c_start, grid, right=True)    # [N, s]
    # prefix sums just before each run: row start_pos - 1, zero at -1
    gi = start_pos - 1
    gs = torch.gather(vals_cs, 1, gi.clamp_min(0)[..., None].expand(n, slots, 4))
    gs = gs * (gi >= 0).to(torch.float32)[..., None]
    total = torch.cat([cs_hi[:, -1, :2], cs_lo[:, -1, :2]], dim=-1)[:, None]
    ge = torch.cat([gs[:, 1:], total], dim=1)
    sum_e = (ge[..., 0] - gs[..., 0]) + (ge[..., 2] - gs[..., 2])
    sum_eb = (ge[..., 1] - gs[..., 1]) + (ge[..., 3] - gs[..., 3])

    valid = torch.arange(slots, device=dev)[None] < n_peaks[:, None]
    center = torch.where(valid, sum_eb / torch.clamp_min(sum_e, 1e-30), 0.0)
    f_in = (center + 0.5) / fft
    mult_c, limit_c = mult[:, None], limit[:, None]
    f_out = torch.where(f_in > limit_c, f_in + (mult_c - 1.0) * limit_c, f_in * mult_c)
    out_bin = f_out * fft - 0.5
    out_sorted = torch.where(valid, out_bin, torch.inf)

    # idx[b] = #(out_sorted <= b) = #(u <= b), u = clip(ceil(out_sorted), 0, B)
    # (invalid slots land on B and count nowhere): an exact histogram count
    u = torch.clamp(torch.ceil(out_sorted), 0.0, float(bands)).to(torch.int64)
    hist = torch.zeros((n, bands + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, u, torch.ones_like(u))
    idx = torch.cumsum(hist, dim=1)[:, :bands]                   # [N, B]

    has = n_peaks > 0
    cap = torch.clamp_min(n_peaks - 1, 0)[:, None]
    i_p = torch.minimum(torch.clamp_min(idx - 1, 0), cap)
    i_q = torch.minimum(torch.clamp_min(idx, 0), cap)
    vals = torch.stack([center, out_bin], dim=-1)                # [N, s, 2]
    ga = torch.gather(vals, 1, i_p[..., None].expand(n, bands, 2))
    gq = torch.gather(vals, 1, i_q[..., None].expand(n, bands, 2))
    p_in, p_out = ga[..., 0], ga[..., 1]
    q_in, q_out = gq[..., 0], gq[..., 1]
    interior = (idx > 0) & (idx < n_peaks[:, None])
    a_in = torch.where(idx <= 0, center[:, :1], p_in)
    a_out = torch.where(idx <= 0, out_bin[:, :1], p_out)
    span = q_out - p_out
    safe_span = torch.where(span.abs() > 1e-30, span, 1.0)
    t = (b_idx[None] - p_out) / safe_span
    dd = (q_in - p_in) - span
    ib_mid = (p_in - p_out) + b_idx[None] + t * t * (3.0 - 2.0 * t) * dd
    gr_mid = 1.0 + 6.0 * t * (1.0 - t) * dd / safe_span
    ib_ext = (a_in - a_out) + b_idx[None]
    input_bin = torch.where(interior, ib_mid, ib_ext)
    grad = torch.where(interior, gr_mid, 1.0)
    input_bin = torch.where(has[:, None], input_bin, b_idx[None])
    grad = torch.where(has[:, None], grad, 1.0)
    return input_bin, grad


# ------------------------------------------------------------- formants
# the blob's epsilon constant in the formant ratio (reint 0x0DA24260)
_FORMANT_TINY = float(np.frombuffer(np.uint32(228737632).tobytes(), np.float32)[0])


def _formant_peak(env_energy: torch.Tensor):
    """The hop-local part of the auto-f0 tracker for N rows: env_energy
    [N, B] -> (peak_value [N] f32, folded index i5 [N] int32).

    The blob scans the bands once, keeping the three largest local maxima
    (``v >= left`` and ``v > right``) seen so far, seeded with three copies
    of band 0; a candidate enters only if strictly above the third, and a
    tie keeps the earlier band first.  That is the stable descending
    top three of the seeds followed by the candidates in band order, taken
    here as three first-maximum picks over the masked row; the two
    harmonic folds after it are elementwise integer operations."""
    n, b_n = env_energy.shape
    v = env_energy[:, 1:-1]
    cand = (v >= env_energy[:, :-2]) & (v > env_energy[:, 2:])
    neg = torch.full_like(v, -torch.inf)
    # columns 0..2: the seeds (band 0); column j >= 3: band j - 2
    work = torch.cat([env_energy[:, :1].expand(n, 3), torch.where(cand, v, neg)], dim=1)
    vals, idxs = [], []
    for _ in range(3):
        col = torch.argmax(work, dim=1, keepdim=True)    # the first maximum
        vals.append(torch.gather(work, 1, col)[:, 0])
        idxs.append(torch.clamp_min(col[:, 0] - 2, 0).to(torch.int32))
        work = work.scatter(1, col, -torch.inf)
    (peak_val, e2, e4), (i5, i2, i4) = vals, idxs

    do1 = e2 > peak_val * 0.1
    d1 = torch.abs(i5 - i2)
    fold1 = do1 & ~((d1 <= i5 // 8) | (d1 >= (i5 * 7) // 8))
    i5 = torch.where(fold1, i5 % torch.clamp_min(d1, 1), i5)
    do2 = do1 & (e4 > peak_val * 0.01)
    d2 = torch.abs(i5 - i4)
    fold2 = do2 & ~((d2 <= i5 // 8) | (d2 >= (i5 * 7) // 8))
    i5 = torch.where(fold2, i5 % torch.clamp_min(d2, 1), i5)
    return peak_val, i5


def _formant_ema(pv, i5, value_ema, weighted_ema, update):
    """The hop-sequential tail of the auto-f0 tracker: 1/16 EMAs of the
    (folded) peak value and its energy-weighted index, advanced only where
    ``update``; width = weighted / (value + tiny).  Returns (width,
    new_value_ema, new_weighted_ema)."""
    new_value = value_ema + (pv - value_ema) * 0.0625
    new_weighted = weighted_ema + (pv * i5.to(torch.float32) - weighted_ema) * 0.0625
    new_value = torch.where(update, new_value, value_ema)
    new_weighted = torch.where(update, new_weighted, weighted_ema)
    width = new_weighted / (new_value + _FORMANT_TINY)
    return width, new_value, new_weighted


def _formant_gain_from_width(cfg: SpectralConfig, env_e, width, active, mult, limit,
                             formant_factor, formant_compensation):
    """The hop-local tail of step 5 once the smoothing width is known: the
    envelope smoothed with a per-row coefficient, the (compensation-aware)
    frequency remap, and the squared-ratio gain.  env_e [H, S, B], width
    [H, S], the rest [S].  Returns the gain [H, S, B]; a voice that is not
    ``active`` gets exactly 1."""
    fft, b_n = cfg.fft, cfg.bands
    h, s_n = width.shape
    env = torch.sqrt(env_e)
    coef = 1.0 / (width * 0.5 + 1.0)
    sm = smooth_pair(env.reshape(h * s_n, b_n).contiguous(), coef.reshape(h * s_n))
    sm = sm.reshape(h, s_n, b_n)
    freq = (torch.arange(b_n, dtype=torch.float32, device=env_e.device) + 0.5) / fft
    col = lambda x: x[:, None]
    # compensation: look up in transpose-mapped space (undoes the shift)
    fr = torch.where(
        col(formant_compensation) != 0.0,
        torch.where(freq > col(limit), freq + (col(mult) - 1.0) * col(limit), freq * col(mult)),
        freq)                                                     # [S, B]
    fm = (1.0 / col(formant_factor)) * fr
    fm = torch.where(fm > col(limit), (1.0 - col(formant_factor)) * col(limit) + fr, fm)
    pos = fm * fft - 0.5
    env_m = frac_gather(sm.reshape(h * s_n, b_n, 1).contiguous(),
                        pos.expand(h, s_n, b_n).reshape(h * s_n, b_n).contiguous())
    env_m = torch.where(pos < 0.0, 0.0, env_m.reshape(h, s_n, b_n))
    ratio = env_m / (sm + _FORMANT_TINY)
    return torch.where(active[:, None], torch.square(ratio), 1.0)


def _formant_f0(env_energy: torch.Tensor, value_ema, weighted_ema, update):
    """The auto-f0 smoothing width of one hop (formantBase == 0) for N
    rows: the top-3 peak tracker with its two harmonic folds
    (:func:`_formant_peak`), then one step of the 1/16 EMAs
    (:func:`_formant_ema`), which advance only where ``update`` (the blob
    skips step 5 for formant-neutral hops).  env_energy [N, B], the rest
    [N].  Returns (width, new_value_ema, new_weighted_ema)."""
    pv, i5 = _formant_peak(env_energy)
    return _formant_ema(pv, i5, value_ema, weighted_ema, update)


def _formant_gain(cfg: SpectralConfig, energy_c: torch.Tensor, state: SpectralState,
                  mult, limit, formant_factor, formant_compensation, formant_base):
    """The blob's step 5 for one hop of S streams: energy_c [S, C, B]
    (the channel energies before the gain), state and controls [S].
    Returns (gain [S, B], new_value_ema, new_weighted_ema); a
    formant-neutral voice gets the exact identity gain and frozen
    trackers (the blob's gate)."""
    active = (formant_factor != 1.0) | ((formant_compensation != 0.0) & (mult != 1.0))
    env_e = torch.sum(energy_c, dim=1)                                # [S, B]
    auto = formant_base <= 0.0
    w_auto, new_v, new_w = _formant_f0(env_e, state.f_value_ema, state.f_weighted_ema,
                                       active & auto)
    width = torch.where(auto, w_auto, formant_base * cfg.fft - 0.5)
    gain = _formant_gain_from_width(cfg, env_e[None], width[None], active, mult, limit,
                                    formant_factor, formant_compensation)
    return gain[0], new_v, new_w


# ------------------------------------------------------ hop-local stage
def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[..., k:] followed by k zeros."""
    return torch.cat([a[..., k:], torch.zeros_like(a[..., :k])], dim=-1)


@table_cache(maxsize=32)
def _rotation(cfg: SpectralConfig, device: torch.device) -> torch.Tensor:
    """e^{i 2 pi (b + 1/2) interval / fft}: re-references a spectrum one
    interval forward (built once per geometry and device)."""
    return unit_phase(
        2.0 * np.pi * (np.arange(cfg.bands) + 0.5) * cfg.interval / cfg.fft, device)


def _hop_pre_gather(cfg: SpectralConfig, cur, prev, input_bin_map, grad_map,
                    seq, time_factor, mult, fgain=None):
    """Steps 3-6 up to the row gathers, for all hops: the rotated
    previous-interval analysis, channel energies (times the step-5 gain
    ``fgain`` [H, S, B] where given), the map (identity where the stream
    does not transpose), and the five families' gather positions.  cur,
    prev [H, S, C, B]; maps [H, S, B]; seq [H, S, 2B-2]; time_factor, mult
    [S].  Returns (prev_rot, energy_c, input_bin, grad, families): the
    positions [H, S, B] of pred (``input_bin`` itself), down_s, down_l, us
    and ul, in the five-family table's order."""
    b_n, long_step = cfg.bands, cfg.long_step
    b_idx = torch.arange(b_n, dtype=torch.float32, device=cur.device)
    prev_rot = prev * _rotation(cfg, cur.device)
    energy_c = torch.square(torch.abs(cur))                     # [H, S, C, B]
    mapping = (mult != 1.0)[None, :, None]
    input_bin = torch.where(mapping, input_bin_map, b_idx)
    grad = torch.where(mapping, grad_map, 1.0)
    if fgain is not None:
        energy_c = energy_c * fgain[:, :, None]
    d_down, d_up = _minstd_steps(seq, time_factor[None].expand(seq.shape[:2]))
    us_pos = _shift(input_bin, 1) - d_up
    ul_pos = _shift(input_bin, long_step) - d_up * long_step
    families = (input_bin, input_bin - d_down, input_bin - d_down * long_step,
                us_pos, ul_pos)
    return prev_rot, energy_c, input_bin, grad, families


def _planes(z: torch.Tensor) -> torch.Tensor:
    """[N, C, B] complex -> [N, B, 2C] float32, plane c*2 + (re, im)."""
    n, c, b = z.shape
    return torch.view_as_real(z).permute(0, 2, 1, 3).reshape(n, b, 2 * c)


def _complex_of(p: torch.Tensor) -> torch.Tensor:
    """[N, K, 2C] float32 planes -> [N, C, K] complex64."""
    n, k, c2 = p.shape
    return torch.view_as_complex(p.reshape(n, k, c2 // 2, 2)).permute(0, 2, 1)


def _hop_post_gather(cfg: SpectralConfig, five, pe_raw, prev_interp, grad):
    """Step-7 operand assembly from the gathered rows, for all hops.
    five [H, S, C, 5B] complex, pe_raw [H, S, C, B], prev_interp
    [H, S, C, B] complex, grad [H, S, B]."""
    c_n, long_step = cfg.channels, cfg.long_step
    pred_input, down_s, down_l, us_g, ul_g = torch.chunk(five, 5, dim=-1)
    pred_energy = pe_raw * torch.clamp_min(grad, 0.0)[:, :, None]
    tw = pred_input * torch.conj(prev_interp)

    mc = torch.argmax(pred_energy, dim=2)                        # [H, S, B]
    ch = torch.arange(c_n, device=mc.device)[:, None]
    oh_f = (ch == mc[:, :, None, :]).to(torch.float32)          # [H, S, C, B]

    def sel(arr):  # leader channel per band (one nonzero term: exact)
        return torch.sum(arr * oh_f, dim=2)

    # u12 in the sequential pass is sel(shift1(timepred) * K1) +
    # sel(shiftL(timepred) * K2), with the onehot folded into the factors
    k1 = torch.conj(_shift(pred_input, 1) * torch.conj(us_g)) * oh_f
    k2 = torch.conj(_shift(pred_input, long_step) * torch.conj(ul_g)) * oh_f
    pi_mc = sel(pred_input)
    return dict(
        d1=sel(pred_input * torch.conj(down_s)),
        d2=sel(pred_input * torch.conj(down_l)),
        k1=k1, k2=k2, tw=tw, pe_mc=sel(pred_energy), pi_mc=pi_mc, mc=mc,
        lock=torch.conj(pi_mc[:, :, None] * torch.conj(pred_input)),
        pred_energy=pred_energy, pred_input=pred_input,
    )


def chainfetch_enabled() -> bool:
    """The JAX package's switch for the fused six-family fetch:
    ``BAUKLANK_CHAINFETCH`` set to anything but 0, false or off (off by
    default)."""
    return os.environ.get("BAUKLANK_CHAINFETCH", "0") not in ("0", "false", "off")


def _hop_inputs_hoisted(cfg: SpectralConfig, cur, prev, seeds, time_factor, mult, limit,
                        fgain=None, deterministic: bool | None = None, seq=None):
    """All hops' chain inputs: the peaks map for every (hop, stream) row
    in one batched pass, then the row gathers — ``spec`` planes at the
    five-family positions and ``prev | energy`` planes at ``input_bin``.

    The gathers are two launches of kernel 3, or, with
    ``BAUKLANK_CHAINFETCH`` set and every stream in the deterministic
    regime (time factor <= 2), one launch of kernel 7; the two routes give
    the same bits.  ``deterministic`` is the caller's word on the regime
    (the pool knows its rates on the host); left None, the switched-on
    route reads it from ``time_factor``, which waits for the device.
    With the regime known to be deterministic the MINSTD draw streams,
    which it discards, are not computed; ``seq`` [H, S, 2B-2] gives them
    drawn already (:func:`minstd_hops`), and ``seeds`` is then not read."""
    h, s_n, c_n, b_n = cur.shape
    n = h * s_n
    dev = cur.device

    energy_all = torch.sum(torch.square(torch.abs(cur)), dim=2)  # [H, S, B]
    coef = 1.0 / (0.5 * (cfg.fft / cfg.interval) + 1.0)
    e_flat = energy_all.reshape(n, b_n)
    sm = smooth_pair(e_flat, coef)
    mult_n = mult[None].expand(h, s_n).reshape(n)
    limit_n = limit[None].expand(h, s_n).reshape(n)
    ib_m, gr_m = _find_peaks_map_batched(e_flat, sm, mult_n, limit_n, b_n, cfg.fft)

    fused = chainfetch_enabled()
    if fused and deterministic is None:
        deterministic = bool((time_factor <= 2.0).all())
    fused = fused and bool(deterministic)

    # MINSTD draw streams of every hop (used only where tf > 2)
    if seq is None and deterministic:
        seq = torch.ones((), dtype=torch.int64, device=dev).expand(h, s_n, 2 * b_n - 2)
    elif seq is None:
        seq = _minstd_draws(seeds, 2 * b_n - 2)

    prev_rot, energy_c, input_bin, grad, families = _hop_pre_gather(
        cfg, cur, prev, ib_m.reshape(h, s_n, b_n), gr_m.reshape(h, s_n, b_n),
        seq, time_factor, mult, fgain)

    rows = lambda x: x.reshape(n, b_n).contiguous()
    spec_p = _planes(cur.reshape(n, c_n, b_n)).contiguous()      # [N, B, 2C]
    prev_p = _planes(prev_rot.reshape(n, c_n, b_n))
    en_p = energy_c.reshape(n, c_n, b_n).transpose(1, 2)         # [N, B, C]
    if fused:
        step = torch.clamp(time_factor.to(torch.float32), 0.5, 2.0)
        five_p, g1 = chainfetch(
            spec_p, prev_p.contiguous(), en_p.contiguous(), rows(input_bin),
            rows(families[3]), rows(families[4]),
            step[None].expand(h, s_n).reshape(n).contiguous(), cfg.long_step)
    else:
        comb_p = torch.cat([prev_p, en_p], dim=-1).contiguous()  # [N, B, 3C]
        five_p = frac_gather(spec_p, torch.cat(families, dim=-1).reshape(n, 5 * b_n))
        g1 = frac_gather(comb_p, rows(input_bin))

    five = _complex_of(five_p).reshape(h, s_n, c_n, 5 * b_n)
    prev_interp = _complex_of(g1[..., : 2 * c_n].contiguous()).reshape(h, s_n, c_n, b_n)
    pe_raw = g1[..., 2 * c_n:].transpose(1, 2).reshape(h, s_n, c_n, b_n)
    return _hop_post_gather(cfg, five, pe_raw, prev_interp, grad)


def _hop_local_inputs(cfg: SpectralConfig, spec_in, spec_prev, seed, time_factor, mult, limit,
                      fgain=None):
    """The hop-local part of :func:`_chain_inputs` for one hop of S
    streams: everything that does not depend on the carried spectra.
    spec_in, spec_prev [S, C, B]; seed, time_factor, mult, limit [S];
    fgain [S, B] or None.  Returns the operands of
    :func:`_hop_inputs_hoisted` without the hop axis.

    In the JAX package the hoisted serving form and this per-hop form
    differ in their gathers (one-hot block matmuls against row gathers).
    In the port both run the same stages, so one hop is the hoisted form
    at H = 1 on the two-launch gather route (kernel 3 twice), with the
    MINSTD draws computed in every regime; the tests hold H hops at once
    equal, bit for bit, to H single hops."""
    xs = _hop_inputs_hoisted(cfg, spec_in[None], spec_prev[None], seed[None], time_factor,
                             mult, limit, None if fgain is None else fgain[None],
                             deterministic=False)
    return {k: v[0] for k, v in xs.items()}


def _minstd_draws(seeds: torch.Tensor, n_draws: int) -> torch.Tensor:
    """The draw stream s·a^(k+1) mod M, k < ``n_draws``, of each seed:
    seeds [H, S] -> [H, S, n_draws] int64."""
    pows, _ = _minstd_tables(n_draws, seeds.shape[0], seeds.device)
    return _modmul31(seeds[..., None], pows)


def minstd_hops(cfg: SpectralConfig, rng: torch.Tensor, time_factor: torch.Tensor,
                n_hops: int, deterministic: bool | None = None):
    """The MINSTD part of a chunk of ``n_hops`` hops: each hop's seed (the
    carried state advanced by a whole hop's 2B-2 draws per hop where the
    stream is at time factor > 2, else held), the state carried out, and,
    unless the caller's word is that every stream is deterministic, every
    hop's draw stream.  rng, time_factor [S].  Returns (seeds [H, S],
    seq [H, S, 2B-2] or None, rng_final [S])."""
    n_draws = 2 * cfg.bands - 2
    _, hop_pows = _minstd_tables(n_draws, n_hops, rng.device)
    seeds_all = _modmul31(rng[None, :], hop_pows[:, None])        # [H+1, S]
    use = time_factor > 2.0
    seeds = torch.where(use[None, :], seeds_all[:n_hops], rng[None, :])
    rng_final = torch.where(use, seeds_all[n_hops], rng)
    seq = None if deterministic else _minstd_draws(seeds, n_draws)
    return seeds, seq, rng_final


def chain_inputs_drawn(cfg: SpectralConfig, state: SpectralState, cur, prev,
                       time_factor, mult, limit, formant_factor, formant_compensation,
                       formant_base, deterministic: bool | None, draws):
    """:func:`chain_inputs_hops` after its MINSTD part: ``draws`` is
    :func:`minstd_hops`' (seeds, seq, rng_final) for this chunk.  Returns
    ``(xs, (f_value_ema, f_weighted_ema))``."""
    h = cur.shape[0]
    seeds, seq, _ = draws
    fgain = None
    fv, fw = state.f_value_ema, state.f_weighted_ema
    if cfg.formants and formant_factor is not None:
        active = (formant_factor != 1.0) | ((formant_compensation != 0.0) & (mult != 1.0))
        env_e = torch.sum(torch.square(torch.abs(cur)), dim=2)    # [H, S, B]
        auto = formant_base <= 0.0
        s_n = env_e.shape[1]
        pv, i5 = (x.reshape(h, s_n) for x in _formant_peak(env_e.reshape(h * s_n, -1)))
        w_auto = []
        for i in range(h):
            wid, fv, fw = _formant_ema(pv[i], i5[i], fv, fw, active & auto)
            w_auto.append(wid)
        width = torch.where(auto, torch.stack(w_auto), formant_base * cfg.fft - 0.5)
        fgain = _formant_gain_from_width(cfg, env_e, width, active, mult, limit,
                                         formant_factor, formant_compensation)

    xs = _hop_inputs_hoisted(cfg, cur, prev, seeds, time_factor, mult, limit, fgain,
                             deterministic, seq)

    # stale prediction denominators: hop h sees max(pe_h, pe_{h-1}) + EPS
    pe = xs["pred_energy"]                                        # [H, S, C, B]
    prev_pe = torch.cat([state.prev_pred_energy[None], pe[:-1]], dim=0)
    xs["den"] = torch.maximum(pe, prev_pe) + EPS
    return xs, (fv, fw)


def chain_inputs_hops(cfg: SpectralConfig, state: SpectralState, cur, prev,
                      time_factor, mult, limit,
                      formant_factor=None, formant_compensation=None, formant_base=None,
                      deterministic: bool | None = None):
    """Precompute the chain inputs of ALL hops of a serving chunk in one
    batched pass: the smoothers, peak maps, MINSTD draw streams, row
    gathers and the formant chain are hop-local once the MINSTD seeds (a
    data-independent geometric sequence), the formant EMAs (a scalar
    recurrence over the hops) and the stale-prediction denominators (a
    one-hop shift of the hop-local pred_energy) are resolved up front.

    state: leading [S] axis on every leaf; cur, prev [H, S, C, B]
    complex64; time_factor, mult, limit and the formant controls [S].
    Formants run where ``cfg.formants`` and the controls are given;
    neutral controls then give the exact identity gain and frozen
    trackers.  ``deterministic``: see :func:`_hop_inputs_hoisted`.
    Returns ``(xs, carried)``: ``xs`` a dict of [H, S, ...] operands
    (including ``den``), ``carried = (rng_final, f_value_ema,
    f_weighted_ema)``.  The composition of :func:`minstd_hops` and
    :func:`chain_inputs_drawn`, which the pool step runs apart."""
    draws = minstd_hops(cfg, state.rng, time_factor, cur.shape[0], deterministic)
    xs, (fv, fw) = chain_inputs_drawn(cfg, state, cur, prev, time_factor, mult, limit,
                                      formant_factor, formant_compensation, formant_base,
                                      deterministic, draws)
    return xs, (draws[2], fv, fw)


def _div_real(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / (den + 0i)`` as ``re / den`` and ``im / den``: XLA's complex
    division by a real-valued complex64, value for value, which PyTorch's
    own complex division is not (pinned by tests/test_torch_fidelity.py)."""
    return torch.complex(num.real / den, num.imag / den)


def _hop_chain(cfg: SpectralConfig, prev_out: torch.Tensor, x: dict, den: torch.Tensor):
    """The state-coupled rest of one hop: rotate the carried spectrum
    ``prev_out`` [S, C, B] one interval forward, form the time prediction
    and ``u12``, and return the band chain's operands.  ``x``: one hop's
    hop-local operands ([S, ...]); ``den`` [S, C, B] its stale-prediction
    denominators."""
    # mdft.cmul: the carried spectrum comes out of the band chain with the
    # streams minor, and PyTorch's CPU complex product rounds a stride-1
    # stream axis by its length (scalar or vector loop), so the plain
    # product would tie a voice's bits to the pool's width
    rotated = mdft.cmul(mdft.cmul(prev_out, _rotation(cfg, prev_out.device)), x["tw"])
    timepred = _div_real(rotated, den)                                  # [S, C, B]
    u12 = (torch.sum(_shift(timepred, 1) * x["k1"], dim=1)
           + torch.sum(_shift(timepred, cfg.long_step) * x["k2"], dim=1))
    return (x["d1"], x["d2"], u12, x["pe_mc"], x["pi_mc"], x["mc"], x["lock"],
            x["pred_energy"], x["pred_input"])


def _chain_inputs(cfg: SpectralConfig, state: SpectralState, spec_in, spec_prev,
                  time_factor, mult, limit,
                  formant_factor=None, formant_compensation=None, formant_base=None):
    """Steps 3-6 and the step-7 gathers of one hop of S streams:
    everything before the sequential band chain, recomputed from this
    hop's analyses and the carried state (the JAX package's hop-exact
    path).  state [S]; spec_in, spec_prev [S, C, B]; controls [S].
    Returns ``(chain, (new_rng, new_fv, new_fw, pred_energy))`` with
    chain = (d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input),
    the operands of :func:`_band_chain_scan` and :func:`band_chain_packed`.

    The formant trackers take one EMA step and the MINSTD seed advances by
    one hop's draws where the stream is at time factor > 2.  ``u12`` folds
    the leader's one-hot into its factors as the hoisted form does, which
    gives the JAX form's selection of the products bit for bit (one
    nonzero term)."""
    fgain = None
    fv, fw = state.f_value_ema, state.f_weighted_ema
    if cfg.formants and formant_factor is not None:
        fgain, fv, fw = _formant_gain(cfg, torch.square(torch.abs(spec_in)), state, mult, limit,
                                      formant_factor, formant_compensation, formant_base)
    x = _hop_local_inputs(cfg, spec_in, spec_prev, state.rng, time_factor, mult, limit, fgain)
    _, hop_pows = _minstd_tables(2 * cfg.bands - 2, 1, spec_in.device)
    new_rng = torch.where(time_factor > 2.0, _modmul31(state.rng, hop_pows[1]), state.rng)
    den = torch.maximum(x["pred_energy"], state.prev_pred_energy) + EPS
    chain = _hop_chain(cfg, state.prev_output, x, den)
    return chain, (new_rng, fv, fw, x["pred_energy"])


def spectral_hop(cfg: SpectralConfig, state: SpectralState, spec_in, spec_prev, time_factor,
                 mult, limit, formant_factor=None, formant_compensation=None,
                 formant_base=None):
    """One hop of the blob's processSpectrum for one stream: state without
    a stream axis, spec_in and spec_prev [C, B] (the analyses at the frame
    and one interval back), scalar controls.  Returns (state, out [C, B]).
    :func:`spectral_hop_batched` at one stream: the band chain is kernel 4
    on the card and its plain version on the CPU; formant processing runs
    where ``cfg.formants`` and the formant controls are given."""
    dev = spec_in.device
    one = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
    formants = [None if v is None else one(v)
                for v in (formant_factor, formant_compensation, formant_base)]
    new, out = spectral_hop_batched(
        cfg, tree_map(lambda v: v[None], state), spec_in[None], spec_prev[None],
        one(time_factor), one(mult), one(limit), *formants)
    return tree_map(lambda v: v[0], new), out[0]


# ------------------------------------------------------------ band chain
def band_chain_packed(cfg: SpectralConfig, chain, fn=None) -> torch.Tensor:
    """Pack batched chain inputs into the band-chain layout ([planes, B, S],
    streams minor), run kernel 4 (or ``fn``, which takes the same operands),
    and unpack to [S, C, B] complex64.

    chain = (d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input)
    with [S, B] leader operands and [S, C, B] per-channel ones."""
    d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input = chain
    c_n = cfg.channels

    def bt(x):  # [S, B] real -> [B, S]
        return x.to(torch.float32).transpose(0, 1)

    def bt2(z):
        return bt(z.real), bt(z.imag)

    lead = torch.stack([*bt2(d1), *bt2(d2), *bt2(u12), *bt2(pi_mc), bt(pe_mc)])
    chan = torch.stack([
        torch.stack([
            bt((mc == c).to(torch.float32)),
            *bt2(lock[:, c]),
            bt(pred_energy[:, c]),
            *bt2(pred_input[:, c]),
        ])
        for c in range(c_n)
    ])                                                            # [C, 6, B, S]
    out = (fn or band_chain)(lead.contiguous(), chan.contiguous(), cfg.long_step)
    return torch.complex(out[:, 0], out[:, 1]).permute(2, 0, 1)   # [S, C, B]


def _band_chain_scan(cfg: SpectralConfig, chain) -> torch.Tensor:
    """The sequential Gauss-Seidel chain over bands, as a plain loop on
    every device: kernel 4's plain version (``band_chain_ref``) on the
    operands :func:`band_chain_packed` packs.  ``chain`` as that function
    takes it ([S, ...] operands).  Returns [S, C, B] complex64."""
    return band_chain_packed(cfg, chain, band_chain_ref)


def spectral_hop_batched(cfg: SpectralConfig, state: SpectralState, spec_in, spec_prev,
                         time_factor, mult, limit, formant_factor=None,
                         formant_compensation=None, formant_base=None,
                         use_kernel: bool | None = None):
    """One hop for a whole pool: :func:`_chain_inputs` over the S streams,
    then the band chain as kernel 4 (``use_kernel``, through
    :func:`band_chain_packed`) or as :func:`_band_chain_scan`.
    ``use_kernel=None`` takes the kernel on the card and the plain chain
    on the CPU.  state [S]; spec_in, spec_prev [S, C, B]; controls [S].
    Returns (state, out [S, C, B])."""
    chain, (rng, fv, fw, pe) = _chain_inputs(
        cfg, state, spec_in, spec_prev, time_factor, mult, limit,
        formant_factor, formant_compensation, formant_base)
    if use_kernel is None:
        use_kernel = spec_in.device.type == "cuda"
    out = band_chain_packed(cfg, chain) if use_kernel else _band_chain_scan(cfg, chain)
    return SpectralState(prev_output=out, prev_pred_energy=pe, rng=rng,
                         f_value_ema=fv, f_weighted_ema=fw), out
