"""PyTorch port, the fast engine's ops against the JAX package on the CPU:
the banded-interp kernel's plain version (held to the Pallas kernel in
interpret mode), the pitch map, the windows, the formant envelope and
the stretch parameters.  Inputs come from ``numpy.random.default_rng``.

Bounds: the interpolation within 1e-6 of max|x| (the TPU kernel's dot
may round its two products and sum otherwise than the port's separate
roundings); the elementwise maps within 1 ulp (XLA may fuse a multiply
and an add); the window exactly; the formant chain within rtol 1e-5 (its
FFTs are the same library, its gathers and logs round apart), the
envelope also within 1e-6 of its largest value (XLA's CPU ``exp``
rounds otherwise than PyTorch's, and the inverse FFT spreads one ulp of
the transfer function over every band).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bauklank_tpu.engine.params import StretchParams as JParams
from bauklank_tpu.engine.params import semitones_to_factor as j_st2f
from bauklank_tpu.ops import formant as jformant
from bauklank_tpu.ops import pitchmap as jpm
from bauklank_tpu.ops import windows as jwin
from bauklank_tpu.ops.pallas.interp import banded_interp as j_banded_interp
from bauklank_tpu_torch.engine.params import StretchParams, semitones_to_factor
from bauklank_tpu_torch.kernels.interp import (banded_interp, banded_interp_complex,
                                               banded_interp_ref)
from bauklank_tpu_torch.ops import formant, pitchmap, windows

torch.set_num_threads(1)
SR = 44100.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _interp_close(got, want, x):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(x).max()))


def test_banded_interp_matches_pallas_kernel():
    """The positions of tests/test_pallas.py: monotone, out of range at
    both ends, window 256 at 512 bands."""
    rng = np.random.default_rng(0)
    s, p, bins = 3, 8, 512
    x = rng.standard_normal((s, p, bins)).astype(np.float32)
    pos = np.sort(rng.uniform(-4, bins + 4, size=(s, bins))).astype(np.float32)
    want = j_banded_interp(jnp.asarray(x), jnp.asarray(pos), 256, True)
    _interp_close(banded_interp_ref(_t(x), _t(pos), 256), want, x)
    _interp_close(banded_interp(_t(x), _t(pos), 256), want, x)


def _pitch_positions(semitones: float, block: int) -> np.ndarray:
    bins = block // 2
    band_f = ((np.arange(bins) + 0.5) / block).astype(np.float32)
    tf = np.float32(2.0 ** (semitones / 12.0))
    limit = jpm.effective_tonality_limit(jnp.float32(tf), jnp.float32(8000.0 / SR))
    pos, _ = jpm.source_positions(jnp.asarray(band_f), jnp.float32(tf), limit, block)
    return np.asarray(pos)


@pytest.mark.parametrize("semitones", [-36.0, -24.0, 0.0, 7.0, 24.0])
def test_banded_interp_pitch_map_positions(semitones):
    """2688 bands (the preset), window 768: where the window drops taps
    (below about -31 st) both forms drop the same ones."""
    rng = np.random.default_rng(int(semitones) + 100)
    x = rng.standard_normal((1, 4, 2688)).astype(np.float32)
    pos = _pitch_positions(semitones, 5376)[None]
    want = j_banded_interp(jnp.asarray(x), jnp.asarray(pos), 768, True)
    _interp_close(banded_interp_ref(_t(x), _t(pos), 768), want, x)


@pytest.mark.parametrize("semitones", [-24.0, 24.0])
def test_banded_interp_matches_cpu_interp_where_window_covers(semitones):
    """Against the JAX CPU path (``_interp_real``, window 768 unaligned):
    at +-24 st the window covers every tap, so both are the exact
    interpolation."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 2688)).astype(np.float32)
    pos = _pitch_positions(semitones, 5376)
    want = jpm._interp_real(jnp.asarray(x), jnp.asarray(pos), "zero", 128, 768)
    _interp_close(pitchmap.gather_fractional_real(_t(x)[None], _t(pos)[None], "zero")[0],
                  want, x)


def test_gathers_match_jax():
    """gather_fractional (complex, zeros out of range) and
    gather_fractional_real (clamped) at the test geometry, with
    bins_out off the 128 grid (padded positions)."""
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((2, 3, 512)) + 1j * rng.standard_normal((2, 3, 512))
            ).astype(np.complex64)
    pos = np.sort(rng.uniform(-3, 515, 512)).astype(np.float32)
    want = jpm.gather_fractional(jnp.asarray(spec), jnp.asarray(pos))
    got = pitchmap.gather_fractional(_t(spec)[None], _t(pos)[None])[0]
    _interp_close(got.numpy(), want, np.abs(spec))
    env = rng.uniform(0.0, 2.0, (4, 512)).astype(np.float32)
    pos_r = np.sort(rng.uniform(-3, 515, 300)).astype(np.float32)
    want = jpm.gather_fractional_real(jnp.asarray(env), jnp.asarray(pos_r), oob="clamp")
    got = pitchmap.gather_fractional_real(_t(env)[None], _t(pos_r)[None], oob="clamp")[0]
    _interp_close(got, want, env)


@pytest.mark.parametrize("window", [768, 96])
@pytest.mark.parametrize("semitones", [12.0, 0.0, -12.0, -36.0])
def test_banded_interp_complex_equals_planar_on_stacked_rows(semitones, window):
    """The plain version on interleaved complex rows against itself on the
    stacked real and imaginary rows, bit for bit: at the preset's
    2688 bands, the serving window (which drops taps only at -36 st) and
    a narrow one (which drops them from -12 st down at the least)."""
    rng = np.random.default_rng(int(semitones) + window)
    spec = (rng.standard_normal((2, 3, 2688)) + 1j * rng.standard_normal((2, 3, 2688))
            ).astype(np.complex64)
    pos = _t(np.stack([_pitch_positions(semitones, 5376),
                       _pitch_positions(semitones - 0.37, 5376)]))
    x = torch.view_as_real(_t(spec))                                    # [S, P, bins, 2]
    got = banded_interp_ref(x, pos, window)
    assert got.shape == (2, 3, 2688, 2)
    stacked = torch.cat([_t(spec.real), _t(spec.imag)], dim=1)          # [S, 2P, bins]
    want = banded_interp_ref(stacked, pos, window)
    assert torch.equal(got[..., 0], want[:, :3]) and torch.equal(got[..., 1], want[:, 3:])
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(banded_interp_complex(x, pos, window), got)
    # the serving window covers every tap down to about -31 st; the narrow
    # one cannot hold a tile that spans 256 bands
    dropped = not torch.equal(want, banded_interp_ref(stacked, pos, 1 << 20))
    if window == 768:
        assert dropped == (semitones == -36.0)
    elif semitones <= -12.0:
        assert dropped


@pytest.mark.parametrize("bins_out", [512, 300])
def test_gather_fractional_equals_its_planar_form(bins_out):
    """gather_fractional through the interleaved entry point against the
    form it had before (stacked real and imaginary parts through the planar
    gather, joined by torch.complex), bit for bit, on and off the 128 grid."""
    rng = np.random.default_rng(bins_out)
    spec = _t((rng.standard_normal((2, 3, 2, 512)) + 1j * rng.standard_normal((2, 3, 2, 512))
               ).astype(np.complex64))
    pos = _t(np.sort(rng.uniform(-3, 515, (2, bins_out))).astype(np.float32))
    got = pitchmap.gather_fractional(spec, pos)
    parts = torch.stack([spec.real, spec.imag], dim=1)
    out = pitchmap.gather_fractional_real(parts, pos, "zero")
    want = torch.complex(out[:, 0], out[:, 1])
    assert got.shape == want.shape == (2, 3, 2, bins_out) and got.dtype == torch.complex64
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    # a conjugated or strided view of the spectra is served too
    assert torch.equal(pitchmap.gather_fractional(torch.conj(spec).transpose(1, 2), pos),
                       torch.conj(want).transpose(1, 2))


def test_pitch_map_matches_jax():
    rng = np.random.default_rng(4)
    block = 5376
    band_f = ((np.arange(block // 2) + 0.5) / block).astype(np.float32)
    tf = np.float32(2.0) ** (rng.uniform(-4, 4, 6).astype(np.float32))
    tonality = np.asarray([8000, 0, 20, 22050, 4000, -1], np.float32) / np.float32(SR)
    j_lim = np.asarray(jpm.effective_tonality_limit(jnp.asarray(tf), jnp.asarray(tonality)))
    lim = pitchmap.effective_tonality_limit(_t(tf), _t(tonality))
    np.testing.assert_array_max_ulp(lim.numpy(), j_lim, maxulp=1)
    for i in range(len(tf)):
        j_pos, j_df = jpm.source_positions(jnp.asarray(band_f), jnp.float32(tf[i]),
                                           jnp.float32(j_lim[i]), block)
        pos, df = pitchmap.source_positions(_t(band_f), _t(tf[i:i + 1])[:, None],
                                            _t(j_lim[i:i + 1])[:, None], block)
        np.testing.assert_array_max_ulp(pos[0].numpy(), np.asarray(j_pos), maxulp=1)
        np.testing.assert_array_max_ulp(df[0].numpy(), np.asarray(j_df), maxulp=1)
        f_out = np.asarray(jpm.map_freq(jnp.asarray(band_f), tf[i], j_lim[i]))
        got = pitchmap.map_freq(_t(band_f), float(tf[i]), float(j_lim[i]))
        np.testing.assert_array_max_ulp(got.numpy(), f_out, maxulp=1)


def test_unit_matches_jax():
    rng = np.random.default_rng(5)
    z = (rng.standard_normal(4000) + 1j * rng.standard_normal(4000)).astype(np.complex64)
    z[:5] = [0, 1e-30, -1e-25j, 3 + 0j, 1e-21]
    want = np.asarray(jpm.unit(jnp.asarray(z)))
    got = pitchmap.unit(_t(z)).numpy()
    np.testing.assert_array_max_ulp(got.real, want.real, maxulp=1)
    np.testing.assert_array_max_ulp(got.imag, want.imag, maxulp=1)


@pytest.mark.parametrize("block,interval,beta", [(5376, 1323, None), (1024, 256, None),
                                                 (1792, 441, 6.5), (1024, 1024, None)])
def test_windows_equal_jax(block, interval, beta):
    wa, ws = windows.pr_window_pair(block, interval, beta)
    ja, js = jwin.pr_window_pair(block, interval, beta)
    np.testing.assert_array_equal(wa, ja)
    np.testing.assert_array_equal(ws, js)
    assert windows.kaiser_beta_for_overlap(block, interval) == jwin.kaiser_beta_for_overlap(
        block, interval)


def _power(rng, hops, bins):
    """A positive, harmonic-looking power spectrum per hop (the envelope
    stays well above its FFT rounding floor)."""
    k = np.arange(bins)
    spacing = rng.uniform(6, 20, (hops, 1))
    comb = 1.0 + 4.0 * np.cos(2 * np.pi * k / spacing) ** 8
    tilt = np.exp(-k / rng.uniform(80, 300, (hops, 1)))
    return (comb * tilt * rng.uniform(0.5, 1.5, (hops, bins)) + 1e-3).astype(np.float32)


def test_formant_envelope_and_f0_match_jax():
    rng = np.random.default_rng(6)
    power = _power(rng, 8, 512)
    f0 = formant.detect_f0_bands(_t(power))
    j_f0 = np.asarray(jformant.detect_f0_bands(jnp.asarray(power)))
    np.testing.assert_array_equal(f0.numpy(), j_f0)
    sigma = 0.5 * j_f0
    env = formant.spectral_envelope(_t(power), _t(sigma))
    j_env = np.asarray(jformant.spectral_envelope(jnp.asarray(power), jnp.asarray(sigma)))
    # XLA's CPU exp rounds the Gaussian transfer function otherwise than
    # PyTorch's in about 1 value in 20 (one ulp); the inverse FFT spreads
    # that over every band at the scale of the largest envelope value
    np.testing.assert_allclose(env.numpy(), j_env, rtol=1e-5, atol=1e-6 * float(j_env.max()))


def test_formant_gain_matches_jax():
    rng = np.random.default_rng(8)
    block, bins = 1024, 512
    band_f = ((np.arange(bins) + 0.5) / block).astype(np.float32)
    env = _power(rng, 4, bins)
    for tf, ff, comp in ((2 ** (-7 / 12), 2 ** (3 / 12), 1.0), (2 ** (5 / 12), 1.0, 0.0),
                         (1.0, 2 ** (-4 / 12), 0.0)):
        tf, ff, comp = np.float32(tf), np.float32(ff), np.float32(comp)
        lim = jpm.effective_tonality_limit(jnp.float32(tf), jnp.float32(8000 / SR))
        pos, _ = jpm.source_positions(jnp.asarray(band_f), jnp.float32(tf), lim, block)
        want = np.asarray(jformant.formant_gain(jnp.asarray(env), jnp.asarray(band_f), pos,
                                                ff, comp, tf, lim, block))
        col = lambda v: torch.tensor([[float(v)]], dtype=torch.float32)
        got = formant.formant_gain(_t(env)[None], _t(band_f), _t(np.asarray(pos))[None],
                                   col(ff), col(comp), col(tf), col(lim), block)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_params_match_jax():
    kw = dict(rate=0.7, semitones=-5.0, tonality_hz=6000.0, formant_semitones=3.0,
              formant_compensation=1.0, formant_base_hz=220.0, sample_rate=SR)
    got = StretchParams.make(device="cpu", **kw)
    want = JParams.make(**kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=1)
    st = np.linspace(-48, 48, 97).astype(np.float32)
    np.testing.assert_array_max_ulp(semitones_to_factor(st, device="cpu").numpy(),
                                    np.asarray(j_st2f(st)), maxulp=1)
    both = StretchParams.stack([got, StretchParams.make(device="cpu", rate=1.5)])
    assert both.rate.shape == (2,) and float(both.rate[1]) == 1.5
