"""PyTorch port, kernel 1's padded form and the fidelity analysis that
uses it, against the JAX package on the CPU.

The fidelity analysis fetches each frame into a row of ``fft`` samples
with a zero tail (``frames_windowed(..., pitch=fft)``), where the JAX
package's TPU path fetches a lane-padded frame with a zero-extended window
and pads it with ``jnp.pad`` (``bauklank_tpu/engine/fidelity.py``,
``_analyse_many``).  Both are held bit-equal here: the padded form's plain
version against that composition with the Pallas kernel in interpret
mode; and the port's ``_analyse_many`` / ``_analyse_cur_prev`` against the
JAX package's CPU form (the vmapped per-stream analysis), bit-equal at the
small geometry (fft 1024) and within 8 ulps of the peak at the preset's:
there the frames are equal bit for bit, but XLA's FFT of a 6144-point batch
laid out [S, C, H] rounds otherwise than pocketfft's of [S, F, C] (about
3 ulps of the peak; ``test_torch_ops.py::test_mdft_bit_equal`` has the same
caveat for ragged batches)."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu.ops.pallas.frames import gather_frames_windowed
from bauklank_tpu_torch.engine import fidelity as tfid
from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _frame_starts(t, block):
    """Frames partly before the track, wholly before and after it, at its
    last sample, and in range at every residue mod 4."""
    return np.array([
        [-block - 10, -block + 1, -300, 0, 131, t - 2000, t - block, t - 1, t, t + 99],
        [-6000, 77, 4096, 12345, t - 5, 5, 1, 2, 3, 4],
    ], np.int32)


@pytest.mark.parametrize("block", [1024, 5292, 8820])
def test_padded_form_matches_tpu_path(block):
    """The padded form's plain version against the TPU path's composition:
    the Pallas kernel on the lane-padded window, then ``jnp.pad`` to fft."""
    rng = np.random.default_rng(block)
    s, c, t = 2, 2, 20000
    fft = jspec.SpectralConfig(c, block, 256).fft
    audio = rng.standard_normal((s, c, t)).astype(np.float32)
    win = rng.uniform(0.1, 1.0, block).astype(np.float32)
    starts = _frame_starts(t, block)
    blk = -(-block // 128) * 128
    wp = np.zeros(blk, np.float32)
    wp[:block] = win
    fr = gather_frames_windowed(jnp.asarray(audio), jnp.asarray(starts), jnp.asarray(wp),
                                blk, True)
    want = np.asarray(jnp.pad(fr, ((0, 0), (0, 0), (0, 0), (0, fft - blk))))
    got = frames_windowed_ref(_t(audio), _t(starts), _t(win), fft).numpy()
    assert got.shape == (s, starts.shape[1], c, fft)
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors, and the tail is +0
    wrapped = frames_windowed(_t(audio), _t(starts), _t(win), fft)
    assert torch.equal(wrapped.view(torch.int32), _t(got).view(torch.int32))
    assert not wrapped[..., block:].view(torch.int32).any()


def test_padded_form_is_the_plain_form_padded():
    """``pitch`` only adds the zero tail: NaN and inf in the audio
    propagate as in the plain form (also under zero window samples), and
    pitch = block or None is the plain form itself."""
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((3, 1, 997)).astype(np.float32)
    audio[0, 0, 10:14] = [np.nan, np.inf, -np.inf, np.nan]
    win = rng.uniform(0.1, 1.0, 101).astype(np.float32)
    win[:3] = 0.0
    starts = np.array([[7, 9, -50], [0, 896, 997], [13, 14, 15]], np.int32)
    a, st, w = _t(audio), _t(starts), _t(win)
    plain = frames_windowed(a, st, w)
    assert torch.isnan(plain[0, 0, 0, 3]) and torch.isnan(plain[0, 1, 0, 1])  # NaN * 0
    for pitch in (None, 101):
        assert torch.equal(frames_windowed(a, st, w, pitch).view(torch.int32),
                           plain.view(torch.int32))
    for pitch in (102, 103, 104, 256):
        padded = frames_windowed(a, st, w, pitch)
        assert padded.shape == (3, 3, 1, pitch)
        want = torch.nn.functional.pad(plain, (0, pitch - 101))
        assert torch.equal(padded.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="shorter than the block"):
        frames_windowed(a, st, w, 100)


def _assert_analyses_equal(got, want, fft):
    if fft == 1024:
        np.testing.assert_array_equal(got, want)
    else:
        atol = 8 * np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _audios_ends(block, interval, split, s_n=3, h=4, seed=0):
    rng = np.random.default_rng(seed)
    audios = rng.standard_normal((s_n, 2, 30000)).astype(np.float32)
    cfg = jspec.SpectralConfig(2, block, interval, split=split)
    ends = np.stack([jfid.hop_frame_ends(cfg, 2 * h, r, 44100.0, split=split)[h:]
                     for r in np.resize([0.5, 1.3, 2.0, 0.001], s_n)]).astype(np.int32)
    # one stream sought to the track's edges: frames partly before and after it
    ends[-1] = np.resize([block // 3, 29000, 30000 + block // 2, 40000], h)
    return cfg, audios, ends


@pytest.mark.parametrize("split", [True, False], ids=["split-on", "split-off"])
@pytest.mark.parametrize("block,interval", [(1024, 256), (5292, 1323)], ids=["small", "preset"])
def test_analyses_match_jax(block, interval, split):
    """``_analyse_many`` (plain and zero-head window) and
    ``_analyse_cur_prev`` against the JAX package's."""
    cfg_j, audios, ends = _audios_ends(block, interval, split)
    cfg_t = tfid.SpectralConfig(2, block, interval, split=split)
    for zero_head in (0, interval):
        want = np.asarray(jfid._analyse_many(cfg_j, jnp.asarray(audios), jnp.asarray(ends),
                                             zero_head=zero_head))
        got = tfid._analyse_many(cfg_t, _t(audios), _t(ends), zero_head=zero_head).numpy()
        _assert_analyses_equal(got, want, cfg_t.fft)
    want = jfid._analyse_cur_prev(cfg_j, jnp.asarray(audios), jnp.asarray(ends))
    got = tfid._analyse_cur_prev(cfg_t, _t(audios), _t(ends))
    for w, g in zip(want, got):
        _assert_analyses_equal(g.numpy(), np.asarray(w), cfg_t.fft)


def test_analyse_many_fetches_padded_rows(monkeypatch):
    """The fidelity analysis asks kernel 1 for rows of ``fft`` samples and
    runs no pad of its own; the per-hop ``analyse_frames`` keeps its pad."""
    cfg, audios, ends = _audios_ends(5292, 1323, True, s_n=2, h=2)
    cfg_t = tfid.SpectralConfig(2, 5292, 1323)
    calls = []

    def fetch(*args):
        calls.append(args[3:])
        return frames_windowed(*args)

    def no_pad(*args, **kwargs):
        raise AssertionError("the fidelity analysis ran a pad")

    monkeypatch.setattr(tfid, "frames_windowed", fetch)
    want = tfid._analyse_many(cfg_t, _t(audios), _t(ends))
    assert calls == [(cfg_t.fft,)]
    # on the card the fetch writes the padded rows itself; here its plain
    # version pads, so stand it in by the rows it returns
    padded = frames_windowed(_t(audios), (_t(ends).to(torch.int64) - 5292).to(torch.int32),
                             tfid._consts(cfg_t, torch.device("cpu"))[0], cfg_t.fft)
    monkeypatch.setattr(tfid, "frames_windowed", lambda *args: padded)
    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    assert torch.equal(tfid._analyse_many(cfg_t, _t(audios), _t(ends)), want)
