"""PyTorch port, ``ops/analyze.py``: the monitoring ops on their own
(``tests/test_analyze.py``'s three cases) and against the JAX module on
the same signals.

Bounds: scope and levels within 1e-5 of the signal's peak (both take a
min, max, mean or root of the same float32 samples; only the summation
order of the mean differs); spectrum within 0.2 dB wherever it lies above
-100 dB (the FFTs differ, pocketfft against PyTorch's, by a few ulps,
which is far below 0.2 dB there; below -100 dB the spectrum is the FFT's
rounding floor)."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bauklank_tpu.ops import analyze as janalyze
from bauklank_tpu_torch.ops.analyze import levels, scope_buckets, spectrum_db
from tests.util import tone

torch.set_num_threads(1)
SR = 44100.0


def test_scope_buckets_envelope():
    x = torch.from_numpy(np.linspace(-1, 1, 1000, dtype=np.float32))
    b = scope_buckets(x, 10).numpy()
    assert b.shape == (10, 2)
    assert (b[:, 0] <= b[:, 1]).all()
    np.testing.assert_allclose(b[0, 0], -1.0, atol=1e-3)
    np.testing.assert_allclose(b[-1, 1], 1.0, atol=1e-2)


def test_spectrum_db_peak_at_tone():
    db = spectrum_db(torch.from_numpy(tone(1000.0, 16384, SR)), n_fft=2048).numpy()
    assert db.shape == (1025,)
    peak_bin = int(np.argmax(db))
    assert abs(peak_bin * SR / 2048 - 1000.0) < 30.0
    assert db[peak_bin] > -10.0
    assert np.median(db) < -60.0


def test_levels():
    x = torch.from_numpy(np.stack([tone(500.0, 8192, SR), 0.5 * tone(500.0, 8192, SR)]))
    lv = levels(x)
    np.testing.assert_allclose(lv["rms"].numpy()[0], 1 / np.sqrt(2), atol=0.01)
    np.testing.assert_allclose(lv["peak"].numpy()[1], 0.5, atol=0.01)


def _signals():
    rng = np.random.default_rng(3)
    noise = (0.3 * rng.standard_normal((2, 5000))).astype(np.float32)
    chord = (tone(440.0, 5000, SR) + 0.25 * tone(1320.0, 5000, SR)).astype(np.float32)
    return [noise, np.stack([chord, 0.5 * chord]), chord[:1000]]


@pytest.mark.parametrize("k", [0, 1, 2], ids=["noise", "chord", "short"])
def test_matches_jax(k):
    x = _signals()[k]
    peak = float(np.abs(x).max())
    n_fft = min(1 << max(4, x.shape[-1].bit_length() - 1), 2048)
    got_scope = scope_buckets(torch.from_numpy(x), 128).numpy()
    want_scope = np.asarray(janalyze.scope_buckets(jnp.asarray(x), 128))
    assert got_scope.shape == want_scope.shape
    assert np.abs(got_scope - want_scope).max() <= 1e-5 * peak
    got_lv, want_lv = levels(torch.from_numpy(x)), janalyze.levels(jnp.asarray(x))
    for key in ("rms", "peak"):
        assert np.abs(got_lv[key].numpy() - np.asarray(want_lv[key])).max() <= 1e-5 * peak
    got = spectrum_db(torch.from_numpy(x), n_fft=n_fft).numpy()
    want = np.asarray(janalyze.spectrum_db(jnp.asarray(x), n_fft=n_fft))
    assert got.shape == want.shape
    loud = want > -100.0
    assert loud.mean() > 0.05
    assert np.abs(got - want)[loud].max() <= 0.2
