"""Blob-exact spectral hop — the reference engine's algorithm in PyTorch.

Port of ``bauklank_tpu/engine/spectral.py`` for the serving step: the
configuration and state types, MINSTD, the bidirectional smoother, the
peaks map, the hop-local stage (``chain_inputs_hops``) and the packing
of the sequential band chain.  One hop maps (carried state, two
analyses, controls) -> (new state, output spectrum):

1. rotate carried spectra to the new frame position,
2. peak-based frequency map (channel-summed energy -> two-pass one-pole
   smoothing -> maximal runs -> smoothstep output map with gradient),
3. per-channel predictions (interpolated energy/input, time-twist against
   the previous-interval analysis, shared stale prediction buffer),
4. sequential Gauss-Seidel phase propagation over bands with short (1) and
   long (round(fft/interval)) neighbours, max-energy channel leading and
   the other channels phase-locked to it (kernel 4).

Batch axes are written out: hop-local work runs on ``[H, S, ...]``
tensors, flattened to ``N = H * S`` rows for the peaks map and the
gathers.  The TPU forms of the JAX module (one-hot block gathers, the
MXU rank count, the uint32 limb MINSTD) are replaced by what they
compute: plain indexing, exact integer counts, int64 modular products.
Formant processing (step 5) is not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bauklank_tpu_torch.kernels.bandchain import band_chain
from bauklank_tpu_torch.kernels.compsum import comp_cumsum
from bauklank_tpu_torch.ops.gather import frac_gather
from bauklank_tpu_torch.ops.mdft import unit_phase
from bauklank_tpu_torch.ops.scan import associative_scan

__all__ = [
    "EPS",
    "SpectralConfig",
    "SpectralState",
    "fft_size_for",
    "blob_window",
    "init_spectral_state",
    "chain_inputs_hops",
    "band_chain_packed",
]

EPS = 1e-15  # the blob's noise floor (measured; pymodel.EPS)
FORMANTS_TODO = "formant processing is not ported yet (ROADMAP queue 1, formants slice)"


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


@functools.lru_cache(maxsize=64)
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

    formants: the blob's step-5 formant processing (not ported yet; a
    config with it set is refused).  split: splitComputation mode — only
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


@functools.lru_cache(maxsize=16)
def _minstd_powers(n_draws: int) -> np.ndarray:
    """[n_draws] int64: 48271^(k+1) mod (2^31-1) for k = 0..n_draws-1."""
    out = np.empty(n_draws, np.int64)
    p = 1
    for k in range(n_draws):
        p = (p * MINSTD_A) % MINSTD_M
        out[k] = p
    return out


@functools.lru_cache(maxsize=32)
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


@functools.lru_cache(maxsize=32)
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


# ------------------------------------------------------- smoothing (scan)
def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of y_k = a_k y_{k-1} + b_k along the last axis, in
    JAX's ``lax.associative_scan`` order (the same combine tree, so the
    same roundings) with compose((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)."""
    def compose(x, y):
        (a1, b1), (a2, b2) = x, y
        return [a1 * a2, a2 * b1 + b2]

    return tuple(associative_scan(compose, [a, b], dim=-1))


def _smooth_bidirectional(e: torch.Tensor, coef: float, carry: torch.Tensor):
    """The blob's two-pass one-pole smoother (backward then forward) with
    the carry threaded between passes: y_b = y_prev + coef (e_b - y_prev)
    as two affine scans.  e [..., B] -> (smoothed [..., B], carry [...]).
    ``1 - coef`` is taken in float64 and then rounded, as in JAX."""
    a = torch.full_like(e, float(np.float32(1.0 - coef)))
    cf = torch.full_like(e, float(np.float32(coef)))

    def affine(vals, c0):
        aa, bb = _affine_scan(a, cf * vals)
        return aa * c0[..., None] + bb

    bwd = affine(e.flip(-1), carry).flip(-1)
    fwd = affine(bwd, bwd[..., 0])
    return fwd, fwd[..., -1]


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


# ------------------------------------------------------ hop-local stage
def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[..., k:] followed by k zeros."""
    return torch.cat([a[..., k:], torch.zeros_like(a[..., :k])], dim=-1)


@functools.lru_cache(maxsize=32)
def _rotation(cfg: SpectralConfig, device: torch.device) -> torch.Tensor:
    """e^{i 2 pi (b + 1/2) interval / fft}: re-references a spectrum one
    interval forward (built once per geometry and device)."""
    return unit_phase(
        2.0 * np.pi * (np.arange(cfg.bands) + 0.5) * cfg.interval / cfg.fft, device)


def _hop_pre_gather(cfg: SpectralConfig, cur, prev, input_bin_map, grad_map,
                    seq, time_factor, mult):
    """Steps 3-6 up to the row gathers, for all hops: the rotated
    previous-interval analysis, channel energies, the map (identity
    where the stream does not transpose), and the five-family gather
    positions.  cur, prev [H, S, C, B]; maps [H, S, B]; seq [H, S, 2B-2];
    time_factor, mult [S].  Returns (prev_rot, energy_c, input_bin, grad,
    pos5 [H, S, 5B])."""
    b_n, long_step = cfg.bands, cfg.long_step
    b_idx = torch.arange(b_n, dtype=torch.float32, device=cur.device)
    prev_rot = prev * _rotation(cfg, cur.device)
    energy_c = torch.square(torch.abs(cur))                     # [H, S, C, B]
    mapping = (mult != 1.0)[None, :, None]
    input_bin = torch.where(mapping, input_bin_map, b_idx)
    grad = torch.where(mapping, grad_map, 1.0)
    d_down, d_up = _minstd_steps(seq, time_factor[None].expand(seq.shape[:2]))
    us_pos = _shift(input_bin, 1) - d_up
    ul_pos = _shift(input_bin, long_step) - d_up * long_step
    pos5 = torch.cat([input_bin, input_bin - d_down, input_bin - d_down * long_step,
                      us_pos, ul_pos], dim=-1)
    return prev_rot, energy_c, input_bin, grad, pos5


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


def _hop_inputs_hoisted(cfg: SpectralConfig, cur, prev, seeds, time_factor, mult, limit):
    """All hops' chain inputs: the peaks map for every (hop, stream) row
    in one batched pass, then the two fractional gathers (kernel 3) —
    ``spec`` planes at the five-family positions and ``prev | energy``
    planes at ``input_bin``."""
    h, s_n, c_n, b_n = cur.shape
    n = h * s_n
    dev = cur.device

    energy_all = torch.sum(torch.square(torch.abs(cur)), dim=2)  # [H, S, B]
    coef = 1.0 / (0.5 * (cfg.fft / cfg.interval) + 1.0)
    e_flat = energy_all.reshape(n, b_n)
    sm, carry = _smooth_bidirectional(e_flat, coef, torch.zeros(n, device=dev))
    sm, _ = _smooth_bidirectional(sm, coef, carry)
    mult_n = mult[None].expand(h, s_n).reshape(n)
    limit_n = limit[None].expand(h, s_n).reshape(n)
    ib_m, gr_m = _find_peaks_map_batched(e_flat, sm, mult_n, limit_n, b_n, cfg.fft)

    # MINSTD draw streams of every hop (used only where tf > 2)
    pows, _ = _minstd_tables(2 * b_n - 2, h, dev)
    seq = _modmul31(seeds[..., None], pows)                      # [H, S, 2B-2]

    prev_rot, energy_c, input_bin, grad, pos5 = _hop_pre_gather(
        cfg, cur, prev, ib_m.reshape(h, s_n, b_n), gr_m.reshape(h, s_n, b_n),
        seq, time_factor, mult)

    spec_p = _planes(cur.reshape(n, c_n, b_n))                   # [N, B, 2C]
    comb_p = torch.cat([
        _planes(prev_rot.reshape(n, c_n, b_n)),
        energy_c.reshape(n, c_n, b_n).transpose(1, 2),
    ], dim=-1).contiguous()                                      # [N, B, 3C]
    five_p = frac_gather(spec_p.contiguous(), pos5.reshape(n, 5 * b_n).contiguous())
    g1 = frac_gather(comb_p, input_bin.reshape(n, b_n).contiguous())

    five = _complex_of(five_p).reshape(h, s_n, c_n, 5 * b_n)
    prev_interp = _complex_of(g1[..., : 2 * c_n].contiguous()).reshape(h, s_n, c_n, b_n)
    pe_raw = g1[..., 2 * c_n:].transpose(1, 2).reshape(h, s_n, c_n, b_n)
    return _hop_post_gather(cfg, five, pe_raw, prev_interp, grad)


def chain_inputs_hops(cfg: SpectralConfig, state: SpectralState, cur, prev,
                      time_factor, mult, limit):
    """Precompute the chain inputs of ALL hops of a serving chunk in one
    batched pass: the smoothers, peak maps, MINSTD draw streams and row
    gathers are hop-local once the MINSTD seeds (a data-independent
    geometric sequence) and the stale-prediction denominators (a one-hop
    shift of the hop-local pred_energy) are resolved up front.

    state: leading [S] axis on every leaf; cur, prev [H, S, C, B]
    complex64; time_factor, mult, limit [S].  Returns ``(xs, carried)``:
    ``xs`` a dict of [H, S, ...] operands (including ``den``), ``carried =
    (rng_final, f_value_ema, f_weighted_ema)``."""
    if cfg.formants:
        raise NotImplementedError(FORMANTS_TODO)
    h = cur.shape[0]
    n_draws = 2 * cfg.bands - 2
    _, hop_pows = _minstd_tables(n_draws, h, cur.device)
    seeds_all = _modmul31(state.rng[None, :], hop_pows[:, None])  # [H+1, S]
    use = time_factor > 2.0
    seeds = torch.where(use[None, :], seeds_all[:h], state.rng[None, :])
    rng_final = torch.where(use, seeds_all[h], state.rng)

    xs = _hop_inputs_hoisted(cfg, cur, prev, seeds, time_factor, mult, limit)

    # stale prediction denominators: hop h sees max(pe_h, pe_{h-1}) + EPS
    pe = xs["pred_energy"]                                        # [H, S, C, B]
    prev_pe = torch.cat([state.prev_pred_energy[None], pe[:-1]], dim=0)
    xs["den"] = torch.maximum(pe, prev_pe) + EPS
    return xs, (rng_final, state.f_value_ema, state.f_weighted_ema)


# ------------------------------------------------------------ band chain
def band_chain_packed(cfg: SpectralConfig, chain) -> torch.Tensor:
    """Pack batched chain inputs into the band-chain layout ([planes, B, S],
    streams minor), run kernel 4, and unpack to [S, C, B] complex64.

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
    out = band_chain(lead.contiguous(), chan.contiguous(), cfg.long_step)
    return torch.complex(out[:, 0], out[:, 1]).permute(2, 0, 1)   # [S, C, B]
