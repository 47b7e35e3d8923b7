"""PyTorch port, ops layer: the same seeded inputs through the JAX function
and its port.  JAX runs on the CPU, Pallas kernels in interpret mode, every
call eager (each primitive rounded on its own, as the port rounds).

Bounds: bit-equal (maxdiff == 0) for the MDFT analysis, the frame ops and
every gather.  ``imdft`` differs by a few ulp: its constant ``0.5 / w`` is
an XLA complex division the port takes from PyTorch."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu.ops import framing as jframing
from bauklank_tpu.ops import mdft as jmdft
from bauklank_tpu.ops.pallas.frames import gather_frames_windowed
from bauklank_tpu.ops.windowgather import window_gather_taps, window_t1
from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
from bauklank_tpu_torch.ops import framing, mdft
from bauklank_tpu_torch.ops.gather import frac_gather, frac_gather_ref

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [1024, 6144])
def test_mdft_bit_equal(n):
    """Bit-equal at a batch of whole SIMD row groups: XLA's CPU FFT then
    takes pocketfft's vectorized path, which ``scipy.fft`` shares (a
    ragged batch tail goes down another path in XLA and differs in ulps)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((64, n)).astype(np.float32)
    want = np.asarray(jmdft.mdft(jnp.asarray(x)))
    got = mdft.mdft(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_imdft_within_ulps():
    rng = np.random.default_rng(1)
    spec = (rng.standard_normal((5, 512)) + 1j * rng.standard_normal((5, 512))).astype(np.complex64)
    want = np.asarray(jmdft.imdft(jnp.asarray(spec), 1024))
    got = mdft.imdft(_t(spec), 1024).numpy()
    # a few ulp of the peak: XLA's complex division 0.5 / w vs PyTorch's
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * np.spacing(np.abs(want).max()))
    # round trip
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    back = mdft.imdft(mdft.mdft(_t(x)), 1024).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_complex_product_rounds_as_xla_cpu():
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    b = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    want = np.asarray(jnp.asarray(a) * jnp.asarray(b))
    np.testing.assert_array_equal(mdft.cmul(_t(a), _t(b)).numpy(), want)


def test_gather_frames_and_overlap_add_bit_equal():
    rng = np.random.default_rng(3)
    c, t, block, interval = 2, 5000, 1024, 256
    sig = rng.standard_normal((c, t)).astype(np.float32)
    # partial on both sides, fully outside both sides, in range
    starts = np.array([-1500, -1023, -300, 0, 777, t - 500, t - 1, t, t + 40], np.int32)
    want = np.asarray(jframing.gather_frames(jnp.asarray(sig), jnp.asarray(starts), block))
    got = framing.gather_frames(_t(sig), _t(starts), block).numpy()
    np.testing.assert_array_equal(got, want)

    frames = rng.standard_normal((3, 2, 7, 1000)).astype(np.float32)  # B % I != 0
    for out_len in (7 * interval + 1000, 500, 9000):
        want = np.asarray(jframing.overlap_add(jnp.asarray(frames), interval, out_len))
        got = framing.overlap_add(_t(frames), interval, out_len).numpy()
        np.testing.assert_array_equal(got, want)


def _frame_starts(t, block):
    return np.array([
        [-block - 10, -block + 1, -300, 0, 131, t - 2000, t - block, t - 1, t, t + 99],
        [-6000, 77, 4096, 12345, t - 5, 5, 1, 2, 3, 4],
    ], np.int32)


@pytest.mark.parametrize("block", [1024, 5292])
def test_frames_windowed_ref_matches_pallas(block):
    """Kernel 1's plain version against the TPU kernel in interpret mode.
    At 5292 the TPU fetch is lane-padded to 5376 with a zero-extended
    window; its first 5292 samples must equal the port's exact fetch."""
    rng = np.random.default_rng(block)
    s, c, t = 2, 2, 20000
    audio = rng.standard_normal((s, c, t)).astype(np.float32)
    win = rng.uniform(0.1, 1.0, block).astype(np.float32)
    starts = _frame_starts(t, block)
    blk = -(-block // 128) * 128
    wp = np.zeros(blk, np.float32)
    wp[:block] = win
    want = np.asarray(gather_frames_windowed(
        jnp.asarray(audio), jnp.asarray(starts), jnp.asarray(wp), blk, True))
    got = frames_windowed_ref(_t(audio), _t(starts), _t(win)).numpy()
    assert got.shape == (s, starts.shape[1], c, block)
    np.testing.assert_array_equal(got, want[..., :block])
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(frames_windowed(_t(audio), _t(starts), _t(win)).numpy(), got)


def _positions(rng, n, k, b):
    """Adversarial gather positions: in (-1, 0), below -1, past B-1, on
    exact integers (frac == 0), and random fractional."""
    pos = rng.uniform(-3.0, b + 3.0, (n, k)).astype(np.float32)
    pos[:, :8] = np.array([-0.75, -0.5, -1.0, -2.25, b - 1, b - 0.5, b, b + 1.5], np.float32)
    pos[:, 8:40] = rng.integers(-2, b + 2, (n, 32)).astype(np.float32)
    return pos


def test_frac_gather_ref_matches_get_fractional():
    rng = np.random.default_rng(4)
    n, b, p, k = 3, 192, 6, 300
    planes = rng.standard_normal((n, b, p)).astype(np.float32)
    pos = _positions(rng, n, k, b)
    got = frac_gather_ref(_t(planes), _t(pos)).numpy()
    assert got.shape == (n, k, p)
    for i in range(n):
        want = np.asarray(jspec._get_fractional(jnp.asarray(planes[i].T), jnp.asarray(pos[i])))
        np.testing.assert_array_equal(got[i].T, want)
    np.testing.assert_array_equal(frac_gather(_t(planes), _t(pos)).numpy(), got)


def test_frac_gather_ref_matches_window_taps_pallas():
    """Against the tf <= 2 serving gather: the Pallas wintaps kernel
    (interpret mode) plus its caller's weighted combine, in the plane-major
    layout the serving path consumes."""
    rng = np.random.default_rng(7)
    n, c_n, b, long_step = 5, 2, 192, 5
    spec = rng.standard_normal((n, b, 2 * c_n)).astype(np.float32)
    prev = rng.standard_normal((n, b, 2 * c_n)).astype(np.float32)
    en = np.abs(rng.standard_normal((n, b, c_n))).astype(np.float32)
    ib = np.empty((n, b), np.float32)
    ib[0] = np.arange(b)
    ib[1] = np.sort(rng.uniform(0, b - 1, b))
    ib[2] = np.clip(np.arange(b) // 16 * 16.0, 0, b - 1)      # exact integers
    ib[3] = np.clip(np.arange(b) * 0.11, 0, 10.9)              # near band 0
    ib[4] = np.clip(np.arange(b) * 1.07 + 0.37, 0, b + 4.5)    # past B
    step = np.asarray([0.5, 1.0, 1.37, 2.0, 0.75], np.float32)
    cc = step[:, None]
    us = np.concatenate([ib[:, 1:], np.zeros((n, 1), np.float32)], 1) - cc
    ul = np.concatenate([ib[:, long_step:], np.zeros((n, long_step), np.float32)], 1) - cc * long_step
    pos5 = np.concatenate([ib, ib - cc, ib - cc * long_step, us, ul], 1).astype(np.float32)

    pa5, pb5, pac, pbc = window_gather_taps(
        jnp.asarray(spec), jnp.asarray(prev), jnp.asarray(en), jnp.asarray(ib),
        jnp.asarray(pos5), jnp.asarray(step), long_step=long_step,
        t1=window_t1(b, long_step), chunk=8, fetch="pallas", out_layout="pm")

    def weights(pos):  # engine/spectral.py _tap_weights
        i0 = jnp.floor(pos).astype(jnp.int32)
        frac = (pos - i0).astype(jnp.float32)
        ok0 = ((i0 >= 0) & (i0 < b)).astype(jnp.float32)
        ok1 = ((i0 + 1 >= 0) & (i0 + 1 < b)).astype(jnp.float32)
        return ok0 * (1.0 - frac), ok1 * frac

    w05, w15 = weights(jnp.asarray(pos5))
    w0c, w1c = weights(jnp.asarray(ib))
    five = np.asarray(pa5 * w05[:, None, :] + pb5 * w15[:, None, :])
    comb = np.asarray(pac * w0c[:, None, :] + pbc * w1c[:, None, :])

    got5 = frac_gather_ref(_t(spec), _t(pos5)).numpy()
    gotc = frac_gather_ref(_t(np.concatenate([prev, en], -1)), _t(ib)).numpy()
    np.testing.assert_array_equal(got5.transpose(0, 2, 1), five)
    np.testing.assert_array_equal(gotc.transpose(0, 2, 1), comb)
