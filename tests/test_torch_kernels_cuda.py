"""The port's CUDA kernels on the card, against their plain versions at
small shapes (bit-equal).  Marked ``cuda``: each test skips unless a CUDA
device and ``nvcc`` are present, so they run only on a machine with the
card.  The proof at the main path's shapes is ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import pytest

import torch

from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.kernels.bandchain import (band_chain, band_chain_ref,
                                                  band_step_cycles, root_ratio_mismatches)
from bauklank_tpu_torch.kernels.chainfetch import chainfetch, chainfetch_ref
from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref, pallas_gather
from bauklank_tpu_torch.kernels.interp import (banded_interp, banded_interp_complex,
                                               banded_interp_ref)
from bauklank_tpu_torch.kernels.smooth import SMEM_LIMIT, smem_bytes, smooth_pair, smooth_pair_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


def test_frames_windowed(dev):
    rng = np.random.default_rng(0)
    audio = _t(rng.standard_normal((3, 2, 9000)).astype(np.float32), dev)
    starts = _t(np.array([[-600, 0, 131, 8900], [5, 77, 4000, -10000],
                          [1, 2, 3, 8999]], np.int32), dev)
    win = _t(rng.uniform(0.1, 1, 5292).astype(np.float32), dev)
    got = _launched("frames_windowed", lambda: frames_windowed(audio, starts, win))
    assert torch.equal(got, frames_windowed_ref(audio, starts, win))


def _same_bits(a, b):
    """Equal bit for bit (so -0 is not +0), NaNs compared by position."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


# kernel 1's two forms: the plain rows (pitch = block), rows of a pitch
# that takes 16-byte stores (a multiple of 4 floats, as every fft is) and
# rows that do not
PITCHES = {"plain": lambda block: None, "padded": lambda block: -(-(block + 300) // 4) * 4,
           "padded-odd": lambda block: block + 301 + (block % 4 == 3)}


def _frames_equal(dev, audio, starts, win, pitch):
    """Kernel 1 against its plain version: one launch, equal bit for bit."""
    got = _launched("frames_windowed", lambda: frames_windowed(audio, starts, win, pitch))
    want = frames_windowed_ref(audio, starts, win, pitch)
    assert got.shape == want.shape
    assert _same_bits(got, want)
    return got


def _edge_starts(t, block, f_n, rng):
    """Every residue mod 4 in range, negative (partly and wholly before the
    track), at T - 1, at T and past T, then random ones over the track."""
    edge = [0, 1, 2, 3, 5, 6, 7, 8, -1, -2, -3, -block + 1, -block, -block - 7, -5000,
            t - 1, t - 2, t - 3, t, t + 1, t + 4099, t - block, t - block + 1, t - block - 1]
    more = rng.integers(-block, t + 10, max(f_n, len(edge))).tolist()
    return np.asarray((edge + more)[:f_n] if f_n > len(edge) else edge[:f_n], np.int32)


@pytest.mark.parametrize("form", list(PITCHES))
@pytest.mark.parametrize("block_mod", [0, 1, 2, 3], ids=lambda v: f"b{v}")
@pytest.mark.parametrize("t_mod", [0, 1, 2, 3], ids=lambda v: f"t{v}")
def test_frames_windowed_edges(dev, t_mod, block_mod, form):
    """T % 4 and block % 4 in {0, 1, 2, 3} (a row base and a frame end off
    16 bytes), both forms, the starts of ``_edge_starts`` in each stream."""
    rng = np.random.default_rng(100 * t_mod + 10 * block_mod)
    t, block = 9000 + t_mod, 1536 + block_mod
    audio = _t(rng.standard_normal((3, 2, t)).astype(np.float32), dev)
    starts = _t(np.stack([np.roll(_edge_starts(t, block, 24, rng), 5 * i) for i in range(3)]),
                dev)
    win = _t(rng.uniform(0.1, 1, block).astype(np.float32), dev)
    pitch = PITCHES[form](block)
    got = _frames_equal(dev, audio, starts, win, pitch)
    assert got.shape[-1] == (pitch or block)
    assert form != "padded-odd" or pitch % 4 != 0


@pytest.mark.parametrize("form", ["plain", "padded"])
@pytest.mark.parametrize("f_n", [2, 9, 64], ids=lambda v: f"f{v}")
@pytest.mark.parametrize("c_n", [1, 2], ids=lambda v: f"c{v}")
@pytest.mark.parametrize("s_n", [1, 64], ids=lambda v: f"s{v}")
def test_frames_windowed_shapes(dev, s_n, c_n, f_n, form):
    """S = 1 (a node) and 64, mono and stereo, 2 to 64 frames a stream
    (several groups of frames, a ragged last group), frames close together
    as a slow voice's and spread as a fast one's."""
    rng = np.random.default_rng(1000 * s_n + 10 * c_n + f_n)
    t, block = 30000, 5292
    audio = _t(rng.standard_normal((s_n, c_n, t)).astype(np.float32), dev)
    first = rng.integers(-block, t, (s_n, 1))
    step = rng.integers(0, 2700, (s_n, 1))
    starts = _t((first + step * np.arange(f_n)).astype(np.int32), dev)
    win = _t(rng.uniform(0.1, 1, block).astype(np.float32), dev)
    _frames_equal(dev, audio, starts, win, PITCHES[form](block) if form != "plain" else None)


@pytest.mark.parametrize("form", ["plain", "padded", "padded-odd"])
def test_frames_windowed_spread_and_unsorted_starts(dev, form):
    """Groups of frames far apart: a seek between cur frames, unsorted
    starts, the prev family one interval back, frames that overlap and
    frames that only touch, and a block of 20001 samples (20 tiles)."""
    rng = np.random.default_rng(3)
    t = 200000
    audio = _t(rng.standard_normal((2, 2, t)).astype(np.float32), dev)
    for block in (1024, 5292, 20001):
        cur = np.array([1000, 1009, 150000, 150010, 7000, 6999, 90000, 1000 + block],
                       np.int64)
        starts = np.stack([np.concatenate([cur, cur - 8820]),
                           np.concatenate([cur[::-1] + 3, cur + 1024])]).astype(np.int32)
        win = _t(rng.uniform(0.1, 1, block).astype(np.float32), dev)
        _frames_equal(dev, audio, _t(starts, dev), win, PITCHES[form](block))


@pytest.mark.parametrize("form", list(PITCHES))
def test_frames_windowed_non_finite_audio(dev, form):
    """NaN and inf in the audio under zero and non-zero window samples: the
    product propagates them (NaN * 0 is NaN) inside [0, T), and a sample
    outside [0, T) or past the block is 0 whatever the audio holds."""
    rng = np.random.default_rng(4)
    t, block = 4001, 1030
    x = rng.standard_normal((2, 2, t)).astype(np.float32)
    x[0, 0, 100:108] = [np.nan, np.inf, -np.inf, np.nan, np.inf, 1.0, -np.inf, np.nan]
    x[1, 1, -3:] = np.nan
    x[1, 0, :4] = np.inf
    w = rng.uniform(0.1, 1, block).astype(np.float32)
    w[:9] = 0.0
    w[-5:] = 0.0
    starts = np.array([[95, 100, 101, 102, 103, 104, -1000, 0],
                       [t - 3, t - block + 2, -2, 0, 1, t - 10, t, -block + 3]], np.int32)
    got = _frames_equal(dev, _t(x, dev), _t(starts, dev), _t(w, dev), PITCHES[form](block))
    # NaN at start 100 (under a zero window sample), inf past the window's zeros
    assert torch.isnan(got[0, 1, 0, 0]) and torch.isinf(got[0, 0, 0, 9])
    assert not torch.isnan(got[..., block:]).any()


@pytest.mark.parametrize("form", list(PITCHES))
def test_frames_windowed_unaligned_operands(dev, form):
    """Operands that are views off 16 bytes: the audio's first sample (the
    aligned float4 of a frame's first samples then starts before the
    tensor, and is read float by float) and the window (the rows then take
    one float a column)."""
    rng = np.random.default_rng(5)
    t, block = 6000, 2048
    flat = _t(rng.standard_normal(2 * 2 * t + 3).astype(np.float32), dev)
    wflat = _t(rng.uniform(0.1, 1, block + 1).astype(np.float32), dev)
    starts = _t(np.array([[0, 1, 2, 3, -1, t - block], [t - 1, 4, 5, 6, 7, -3]], np.int32), dev)
    for off in (1, 2, 3):
        audio = flat[off:off + 2 * 2 * t].view(2, 2, t)
        _frames_equal(dev, audio, starts, wflat[1:], PITCHES[form](block))
        _frames_equal(dev, audio, starts, wflat[:block], PITCHES[form](block))


def test_frames_windowed_live_ring(dev):
    """The coupled drive's shape: the rolled input ring of the preset
    (block + 9 intervals), constant frame ends, cur and prev families."""
    from bauklank_tpu_torch.engine import fidelity as fid

    cfg, h = fid.SpectralConfig(2, 5292, 1323), 8
    ring = fid.live_fidelity_ring_len(cfg, h)
    rng = np.random.default_rng(6)
    audio = _t(rng.standard_normal((16, 2, ring)).astype(np.float32), dev)
    ends = ring - (h - np.arange(h)) * cfg.interval
    starts = np.concatenate([ends, ends - cfg.interval]) - cfg.block
    starts = _t(np.broadcast_to(starts, (16, 2 * h)).astype(np.int32), dev)
    win = fid._consts(cfg, torch.device(dev))[0]
    for pitch in (None, cfg.fft):
        _frames_equal(dev, audio, starts, win, pitch)


def test_frames_windowed_refuses_a_short_pitch(dev):
    z = lambda *shape, **kw: torch.zeros(*shape, device=dev, **kw)
    with pytest.raises(ValueError, match="shorter than the block"):
        frames_windowed(z(1, 2, 100), z(1, 2, dtype=torch.int32), z(64), 63)


def test_analyse_many_runs_no_pad_on_the_card(dev, monkeypatch):
    """The fidelity analysis on the card: one launch of the padded form and
    no pad, its spectra equal bit for bit to the plain form padded by
    PyTorch (what the step ran before)."""
    from bauklank_tpu_torch.engine import fidelity as fid

    cfg = fid.SpectralConfig(2, 5292, 1323)
    rng = np.random.default_rng(8)
    audio = _t(rng.standard_normal((8, 2, 60000)).astype(np.float32), dev)
    ends = _t(np.sort(rng.integers(0, 66000, (8, 16)), axis=1).astype(np.int32), dev)
    starts = (ends.to(torch.int64) - cfg.block).to(torch.int32)
    win = fid._consts(cfg, torch.device(dev))[0]
    want = fid._spectra(cfg, frames_windowed(audio, starts, win))

    def no_pad(*args, **kwargs):
        raise AssertionError("the fidelity analysis ran a pad")

    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    got = _launched("frames_windowed", lambda: fid._analyse_many(cfg, audio, ends))
    assert torch.equal(got, want)


def test_comp_cumsum(dev):
    x = _t(np.random.default_rng(1).standard_normal((3, 700, 300)).astype(np.float32), dev)
    hi, lo = _launched("comp_cumsum", lambda: comp_cumsum(x))
    rhi, rlo = comp_cumsum_ref(x)
    assert torch.equal(hi, rhi) and torch.equal(lo, rlo)


@pytest.mark.parametrize("n_n", [1, 31, 33, 36, 128], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("b_n", [1, 63, 64, 65, 199], ids=lambda b: f"b{b}")
def test_comp_cumsum_edges(dev, b_n, n_n):
    """Row counts under, over and at a warp's 32, with N a multiple of 4
    (16-byte copies, a partly filled last block at 36) and not (copied
    float by float); B one under, at and one over a stage's 64 bands and a
    ragged multiple; values over 40 binades with an exact-zero gap, and an
    infinity, a NaN and a negative zero planted in rows of their own."""
    rng = np.random.default_rng(1000 * b_n + n_n)
    x = (rng.standard_normal((3, b_n, n_n))
         * np.exp2(rng.integers(-20, 20, (3, b_n, n_n)))).astype(np.float32)
    x[1, b_n // 3: b_n // 2] = 0.0
    x[2, b_n // 2, 0] = np.inf
    x[0, b_n // 4, n_n // 2] = np.nan
    x[1, 0, n_n - 1] = -0.0
    x = _t(x, dev)
    hi, lo = _launched("comp_cumsum", lambda: comp_cumsum(x))
    rhi, rlo = comp_cumsum_ref(x)
    assert _same_bits(hi, rhi) and _same_bits(lo, rlo)


def test_comp_cumsum_many_planes(dev):
    """More leading planes than a grid's second axis could count."""
    x = torch.randn((70000, 3, 4), device=dev)
    hi, lo = _launched("comp_cumsum", lambda: comp_cumsum(x))
    rhi, rlo = comp_cumsum_ref(x)
    assert torch.equal(hi, rhi) and torch.equal(lo, rlo)


def test_sequential_kernels_refuse_unaligned_operands(dev):
    z = lambda *shape: torch.zeros(*shape, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        comp_cumsum(z(3 * 8 * 4 + 1)[1:].view(3, 8, 4))
    with pytest.raises(ValueError, match="aligned"):
        band_chain(z(9 * 8 * 4 + 1)[1:].view(9, 8, 4), z(2, 6, 8, 4), 1)
    with pytest.raises(ValueError, match="aligned"):
        band_chain(z(9, 8, 4), z(2 * 6 * 8 * 4 + 1)[1:].view(2, 6, 8, 4), 1)


def _gather_operands(rng, n, b, p, k, dev):
    """Random planes over 24 decades and positions that leave [0, B) on
    both sides, with the edge cases up front."""
    planes = (rng.standard_normal((n, b, p)) * 10.0 ** rng.uniform(-12, 12, (n, b, p))
              ).astype(np.float32)
    pos = rng.uniform(-3, b + 3, (n, k)).astype(np.float32)
    pos[:, :6] = [-0.5, -1.0, b - 1.0, b - 0.5, float(b), 7.0]
    pos[:, -2:] = [-2.5, b + 1.5]
    return _t(planes, dev), _t(pos, dev)


@pytest.mark.parametrize("k", [500, 777, 2501], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6], ids=lambda p: f"p{p}")
def test_frac_gather(dev, p, k):
    """Every plane count known at compile time (1, 2, 3, 4, 6) and the
    scalar form (5); K a multiple of 4 (at P = 1: four bands a thread),
    odd, and past two tiles with a ragged end (not a multiple of the
    positions a thread takes); rows 192 bands long, so that a row of n
    starts off the 16-byte grid where P * K allows."""
    planes, pos = _gather_operands(np.random.default_rng(100 * p + k), 5, 192, p, k, dev)
    got = _launched("frac_gather", lambda: frac_gather(planes, pos))
    assert torch.equal(got, frac_gather_ref(planes, pos))
    again = _launched("pallas_gather", lambda: pallas_gather(planes, pos))
    assert torch.equal(again, got)


def test_frac_gather_past_2_31_elements(dev):
    """N * K * P = 2.2e9 output elements: served by 64-bit offsets, not
    refused.  Held against the plain version a few rows at a time (whole,
    its temporaries would not fit), the last rows included."""
    n, b, p, k = 520, 64, 4, 1 << 20
    rng = np.random.default_rng(31)
    planes = _t(rng.standard_normal((n, b, p)).astype(np.float32), dev)
    pos = torch.empty((n, k), dtype=torch.float32, device=dev).uniform_(
        -2.0, b + 2.0, generator=torch.Generator(dev).manual_seed(31))
    assert n * k * p > 2 ** 31
    got = _launched("frac_gather", lambda: frac_gather(planes, pos))
    for lo in (0, 255, 511, 512):
        rows = slice(lo, min(lo + 8, n))
        assert torch.equal(got[rows], frac_gather_ref(planes[rows], pos[rows])), lo


def test_frac_gather_refuses_unaligned_operands(dev):
    z = lambda *shape: torch.zeros(*shape, device=dev)
    for gather in (frac_gather, pallas_gather):
        with pytest.raises(ValueError, match="aligned"):
            gather(z(2 * 8 * 4 + 1)[1:].view(2, 8, 4), z(2, 8))
        with pytest.raises(ValueError, match="aligned"):
            gather(z(2, 8, 4), z(17)[1:].view(2, 8))


def test_pallas_gather(dev):
    """Kernel 6's own entry point and count, at a band grid and a K the
    TPU kernel refuses; the frac_gather count stays where it was."""
    rng = np.random.default_rng(6)
    planes = _t((rng.standard_normal((4, 250, 3)) * 10.0 ** rng.uniform(-12, 12, (4, 250, 3))
                 ).astype(np.float32), dev)
    pos = rng.uniform(-3, 253, (4, 777)).astype(np.float32)
    pos[:, :6] = [-0.5, -1.0, 249.0, 249.5, 250.0, 7.0]
    pos = _t(pos, dev)
    before = kernels.LAUNCHES["frac_gather"]
    got = _launched("pallas_gather", lambda: pallas_gather(planes, pos))
    assert kernels.LAUNCHES["frac_gather"] == before
    assert torch.equal(got, frac_gather_ref(planes, pos))


@pytest.mark.parametrize("b_n,long_step,c_n", [(3072, 5, 2), (250, 4, 1), (192, 1, 3)],
                         ids=["stereo", "mono", "three_channels"])
def test_chainfetch(dev, b_n, long_step, c_n):
    """A non-monotone map with rows on the edges, steps 0.5 to 2: equal to
    the plain version and to the two frac_gather launches it replaces, bit
    for bit, on the vector paths (1 and 2 channels) and the scalar one."""
    rng = np.random.default_rng(b_n)
    n = 6
    spec = _t(rng.standard_normal((n, b_n, 2 * c_n)).astype(np.float32), dev)
    prev = _t(rng.standard_normal((n, b_n, 2 * c_n)).astype(np.float32), dev)
    energy = _t(np.abs(rng.standard_normal((n, b_n, c_n))).astype(np.float32), dev)
    ib = rng.uniform(0, b_n - 1e-3, (n, b_n)).astype(np.float32)
    ib[:, :4] = [0.0, b_n - 1.0, b_n - 0.51, 1.0]
    ib[3] = np.sort(ib[3])                                        # one monotone row
    ib = _t(ib, dev)
    step = _t(np.asarray([0.5, 0.8, 1.0, 1.3, 1.7, 2.0], np.float32), dev)
    c = step[:, None]
    zeros = lambda k: torch.zeros((n, k), device=dev)
    us = torch.cat([ib[:, 1:], zeros(1)], dim=1) - c
    ul = torch.cat([ib[:, long_step:], zeros(long_step)], dim=1) - c * long_step
    five, comb = _launched("chainfetch",
                           lambda: chainfetch(spec, prev, energy, ib, us, ul, step, long_step))
    want5, wantc = chainfetch_ref(spec, prev, energy, ib, us, ul, step, long_step)
    assert torch.equal(five, want5) and torch.equal(comb, wantc)
    pos5 = torch.cat([ib, ib - c, ib - c * long_step, us, ul], dim=1).contiguous()
    assert torch.equal(five, frac_gather(spec, pos5))
    assert torch.equal(comb, frac_gather(torch.cat([prev, energy], dim=2).contiguous(), ib))


def _chain_operands(rng, c_n, b_n, s_n):
    """Random chain operands with the leader channel switching at random
    from band to band, the EPS fallback hit on the leader (band 2) and on
    the followers (band 1), and a band whose pe is 0."""
    lead = rng.standard_normal((9, b_n, s_n)).astype(np.float32)
    lead[8] = np.abs(lead[8])
    lead[:6, min(2, b_n - 1)] = 0.0                 # a vanishing phase sum -> pi
    lead[8, b_n // 2] = 0.0                         # pe == 0
    chan = rng.standard_normal((c_n, 6, b_n, s_n)).astype(np.float32)
    mc = rng.integers(0, c_n, (b_n, s_n))
    chan[:, 0] = mc[None] == np.arange(c_n)[:, None, None]
    chan[:, 3] = np.abs(chan[:, 3])
    chan[:, 1:3, min(1, b_n - 1)] = 0.0             # a vanishing lock -> pic
    return lead, chan


@pytest.mark.parametrize("long_step", [5, 1])
def test_band_chain(dev, long_step):
    rng = np.random.default_rng(long_step)
    lead = rng.standard_normal((9, 300, 40)).astype(np.float32)
    lead[8] = np.abs(lead[8])
    lead[:6, 7] = 0.0                               # EPS fallback to pi
    chan = rng.standard_normal((2, 6, 300, 40)).astype(np.float32)
    mc = rng.integers(0, 2, (300, 40))
    chan[0, 0], chan[1, 0] = mc == 0, mc == 1
    chan[:, 3] = np.abs(chan[:, 3])
    lead_t, chan_t = _t(lead, dev), _t(chan, dev)
    got = _launched("band_chain", lambda: band_chain(lead_t, chan_t, long_step))
    assert torch.equal(got, band_chain_ref(lead_t, chan_t, long_step))


@pytest.mark.parametrize("s_n", [1, 31, 33, 36, 128], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("long_step", [1, 2, 5, 16], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("c_n", [1, 2, 3, 8], ids=lambda c: f"c{c}")
def test_band_chain_edges(dev, c_n, long_step, s_n):
    """Every channel form (1 and 2 known at compile time, 3 and 8 through
    the wide form), long_step 1 (no ring) and ringed, stream counts under,
    over and at a block's tile, with S a multiple of 4 (16-byte copies, a
    partly filled last block at 36) and not (copied float by float); B
    under long_step, one under, at and one over a stage's band tile (16
    bands, 4 in the wide form) and ragged multiples of it."""
    for b_n in (1, 3, 4, 5, 13, 15, 16, 17, 53):
        rng = np.random.default_rng(((c_n * 17 + long_step) * 131 + s_n) * 59 + b_n)
        lead, chan = (_t(a, dev) for a in _chain_operands(rng, c_n, b_n, s_n))
        got = _launched("band_chain", lambda: band_chain(lead, chan, long_step))
        assert _same_bits(got, band_chain_ref(lead, chan, long_step)), b_n


@pytest.mark.parametrize("s_n", [4, 8, 33], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("long_step", [17, 24, 32, 33, 40, 100], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("c_n", [1, 2, 3], ids=lambda c: f"c{c}")
def test_band_chain_long_steps(dev, c_n, long_step, s_n):
    """long_step past the old bound of 16: up to 32 (kHistory) band b - L
    comes from the shared history, past it from the out planes (the
    general form); B under long_step, at 2 long_step and well past it."""
    for b_n in (5, 2 * long_step, 2 * long_step + 1, 300):
        rng = np.random.default_rng(((c_n * 17 + long_step) * 131 + s_n) * 59 + b_n)
        lead, chan = (_t(a, dev) for a in _chain_operands(rng, c_n, b_n, s_n))
        got = _launched("band_chain", lambda: band_chain(lead, chan, long_step))
        assert _same_bits(got, band_chain_ref(lead, chan, long_step)), b_n


def test_band_chain_refuses_more_channels_than_its_widest_form(dev):
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="at most 8 channels"):
        band_chain(z(9, 8, 4), z(9, 6, 8, 4), 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_chain_root_ratio_rounds_as_the_library(dev, seed):
    """The chain's branch-free sqrt(a / b) against __fsqrt_rn(__fdiv_rn())
    on 2^32 random operand pairs of its range: not one differs."""
    assert root_ratio_mismatches(1 << 32, seed) == 0


def test_band_chain_step_cycles(dev):
    """The step's cycle counts from registers: the timed steps stay inside
    the shortcuts (else it raises), a step waits on more than one add, and
    the second channel's follower costs cycles."""
    cyc = band_step_cycles()
    assert 1.0 < cyc["fadd_dependent"] < 16.0
    assert cyc["step_2ch"] > cyc["step_1ch"] > 10 * cyc["fadd_dependent"]


def test_band_chain_out_of_range_energies(dev):
    """Energies outside the branch-free root's range (denormal, tiny, huge,
    negative, -0) and phase sums that leave it: those bands run through
    __fdiv_rn and __fsqrt_rn, equal bit for bit all the same."""
    b_n, s_n = 40, 36
    rng = np.random.default_rng(99)
    lead, chan = _chain_operands(rng, 2, b_n, s_n)
    scale = np.float32(2.0) ** rng.integers(-140, 120, (b_n, s_n)).astype(np.float32)
    lead[8] *= scale
    chan[:, 3] *= np.float32(2.0) ** rng.integers(-140, 120, (2, b_n, s_n)).astype(np.float32)
    lead[4:8, :, ::3] *= np.float32(2.0 ** 30)      # |ph|^2 and |pi|^2 past 2^40
    lead[4:8, :, 1::3] *= np.float32(2.0 ** -30)    # both under EPS
    lead[8, 5, :] = -0.0
    lead[8, b_n - 1, ::5] = -1.0                    # the root of a negative
    lead_t, chan_t = _t(lead, dev), _t(chan, dev)
    got = _launched("band_chain", lambda: band_chain(lead_t, chan_t, 5))
    assert _same_bits(got, band_chain_ref(lead_t, chan_t, 5))


@pytest.mark.parametrize("long_step", [1, 5], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("c_n", [1, 2, 3], ids=lambda c: f"c{c}")
def test_band_chain_non_finite_operands(dev, c_n, long_step):
    """An infinity, a NaN and a negative zero planted in lead and in chan
    (the one-hot plane included), each in streams of its own: equal bit for
    bit with NaNs compared by position, the streams they reach and the
    untouched ones alike."""
    b_n, s_n = 70, 40
    rng = np.random.default_rng(7 * c_n + long_step)
    lead, chan = _chain_operands(rng, c_n, b_n, s_n)
    lead[4, 20, 1] = np.inf            # u.re
    lead[0, 21, 2] = np.nan            # d1.re
    lead[6, 2, 3] = -0.0               # pi.re, where the fallback takes it
    lead[8, 30, 4] = np.inf            # pe
    lead[8, 31, 5] = -1.0              # pe < 0: the square root of a negative
    lead[4:6, 33, 6] = -0.0            # u = -0
    chan[0, 1, 22, 7] = np.inf         # lock.re
    chan[c_n - 1, 3, 23, 8] = np.nan   # pec
    chan[0, 4, 1, 9] = -0.0            # pic.re, where the fallback takes it
    chan[0, 0, 24, 10] = np.nan        # the one-hot plane
    chan[c_n - 1, 0, 0, 11] = np.inf   # the one-hot plane at band 0, against the zero ring
    chan[:, 0, 25, 12] = 0.0           # no leader at all
    chan[:, 0, 26, 13] = 1.0           # every channel a leader
    chan[0, 3, 27, 14] = 0.0           # pec == 0: an output of exact zeros
    lead_t, chan_t = _t(lead, dev), _t(chan, dev)
    got = _launched("band_chain", lambda: band_chain(lead_t, chan_t, long_step))
    want = band_chain_ref(lead_t, chan_t, long_step)
    assert _same_bits(got, want)
    assert bool(torch.isnan(want).any()) and bool(torch.isfinite(want[..., 20:]).all())


def _interp_positions(rng, bins, bins_out):
    """Monotone positions running out of range at both ends; row 2 a steep
    stretch whose last tile spans ~700 bands, row 3 the slope of -36
    semitones (a tile spans 1024 bands): both drop taps."""
    pos = np.sort(rng.uniform(-4, bins + 4, (4, bins_out)), axis=1)
    pos[2] = -2.0 + (bins + 8.0) * np.linspace(0.0, 1.0, bins_out) ** 3
    pos[3] = 8.0 * np.arange(bins_out) + 3.5
    return pos.astype(np.float32)


@pytest.mark.parametrize("window", [256, 768])
def test_banded_interp(dev, window):
    """37 rows (no multiple of the rows a block takes, nor of the four it
    loads at a time), 1024 bands and, at window 768, 640 bands
    (bins < window + 128: the window is the whole row)."""
    rng = np.random.default_rng(window)
    bins = 1024 if window == 256 else 640
    x = _t(rng.standard_normal((4, 37, bins)).astype(np.float32), dev)
    pos = _t(_interp_positions(rng, bins, 512), dev)
    got = _launched("banded_interp", lambda: banded_interp(x, pos, window))
    assert torch.equal(got, banded_interp_ref(x, pos, window))


@pytest.mark.parametrize("window", [256, 768])
def test_banded_interp_complex(dev, window):
    """The interleaved entry point: equal to its plain version and to the
    planar kernel on the stacked real and imaginary rows, bit for bit; it
    counts under banded_interp."""
    rng = np.random.default_rng(window + 1)
    bins = 1024 if window == 256 else 640
    x = _t(rng.standard_normal((4, 19, bins, 2)).astype(np.float32), dev)
    pos = _t(_interp_positions(rng, bins, 512), dev)
    got = _launched("banded_interp", lambda: banded_interp_complex(x, pos, window))
    assert torch.equal(got, banded_interp_ref(x, pos, window))
    planar = banded_interp(torch.cat([x[..., 0], x[..., 1]], dim=1).contiguous(), pos, window)
    assert torch.equal(got[..., 0], planar[:, :19]) and torch.equal(got[..., 1], planar[:, 19:])
    with pytest.raises(ValueError, match="aligned"):
        banded_interp_complex(
            torch.zeros(2 * 3 * 256 * 2 + 1, device=dev)[1:].view(2, 3, 256, 2),
            pos[:2, :128].contiguous())


def test_wrappers_refuse_mixed_devices(dev):
    with pytest.raises(ValueError, match="devices"):
        frac_gather(torch.zeros(2, 8, 4, device=dev), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="contiguous"):
        comp_cumsum(torch.zeros(3, 8, 4, device=dev).transpose(1, 2))
    z = lambda *shape: torch.zeros(*shape, device=dev)
    with pytest.raises(ValueError, match="devices"):
        chainfetch(z(2, 8, 4), z(2, 8, 4), z(2, 8, 2), z(2, 8), z(2, 8), z(2, 8),
                   torch.zeros(2), 2)
    with pytest.raises(ValueError, match="contiguous"):
        chainfetch(z(2, 8, 4), z(2, 8, 4), z(2, 8, 2), z(8, 2).t(), z(2, 8), z(2, 8), z(2), 2)
    with pytest.raises(ValueError, match="aligned"):
        chainfetch(z(2, 8, 4), z(2, 8, 4), z(2, 8, 2), z(17)[1:].view(2, 8), z(2, 8), z(2, 8),
                   z(2), 2)


def _smooth_rows(n_n, b_n, seed):
    """Rows of energies over a wide range, with exact zeros, denormals,
    runs of zeros (whose smoothed tails decay through the denormals) and
    large values (up to ~1e32).  B: tiny rows of both parities, the
    preset's 3072, 4608 and the kiosk pool's 5120."""
    rng = np.random.default_rng(seed)
    e = np.abs(rng.standard_normal((n_n, b_n))
               * np.exp2(rng.integers(-40, 40, (n_n, 1)))).astype(np.float32)
    e[::3, ::5] = 0.0
    e[1::3, ::7] = np.float32(3e-41)
    e[2::3, b_n // 3:] = 0.0
    e[::4] *= np.float32(1e20)
    return e


@pytest.mark.parametrize("b_n", [1, 2, 3, 7, 3072, 4608, 5120])
@pytest.mark.parametrize("n_n", [1, 5, 1024])
@pytest.mark.parametrize("form", ["scalar", "rows"])
def test_smooth_pair(dev, b_n, n_n, form):
    """Kernel 8 against its plain version on the card, bit for bit."""
    e = _t(_smooth_rows(n_n, b_n, b_n * 7 + n_n), dev)
    coef = (1.0 / (0.5 * (6144 / 1536) + 1.0) if form == "scalar" else
            _t(np.random.default_rng(n_n).uniform(0.01, 0.9, n_n).astype(np.float32), dev))
    got = _launched("smooth_pair", lambda: smooth_pair(e, coef))
    assert _same_bits(got, smooth_pair_ref(e, coef))


def test_smooth_pair_refuses_bad_operands(dev):
    e = torch.zeros(4, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        smooth_pair(e.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        smooth_pair(torch.zeros(64, 4, device=dev).t(), 0.5)
    with pytest.raises(ValueError, match="devices"):
        smooth_pair(e, torch.full((4,), 0.5))
    wide = next(b for b in range(4608, 1 << 16, 64) if smem_bytes(b) > SMEM_LIMIT)
    with pytest.raises(ValueError, match="shared memory"):
        smooth_pair(torch.zeros(2, wide, device=dev), 0.5)
