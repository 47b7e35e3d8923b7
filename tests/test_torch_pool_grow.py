"""PyTorch port, the rest of ``StreamPool``: ``grow``, the pipelined fetch
with ``drain``, and ``analyze``, on the CPU (``device="cpu"``).

- After ``grow`` the existing voices' masters and streams are bit-equal to
  those of a pool that never grew (every state leaf is concatenated along
  the stream axis; fresh rows are inactive and add exact zeros).
- Fresh slot names skip taken ones, as the JAX pool names them.
- ``step(fetch="pipeline")`` then ``drain()`` gives the sample stream of
  ``fetch=True`` bit for bit, with a ``grow`` in the middle.
- ``analyze`` against the JAX pool's on the same retained streams: scope
  and levels within 1e-5 of the peak (plus the 5- and 6-decimal rounding
  both apply), spectrum within 0.2 dB above -100 dB (tests/test_torch_analyze.py).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bauklank_tpu.engine.config import StretchConfig as JStretchConfig
from bauklank_tpu.serve.pool import StreamPool as JStreamPool
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.utils.tree import keyed_leaves
from tests.util import tone

torch.set_num_threads(1)
SR = 44100.0
ENGINES = ["fast", "fidelity"]


def _pool(engine, capacity=2, cls=StreamPool, cfg=StretchConfig, **kw):
    extra = {"device": "cpu"} if cls is StreamPool else {}
    return cls(capacity=capacity, sample_rate=SR, channels=2, max_track_sec=1.0,
               config=cfg(channels=2, block=1024, interval=256), engine=engine,
               hops_per_step=2, **extra, **kw)


def _start(pool, names=("s00", "s01")):
    for i, name in enumerate(names):
        x = tone(330.0 + 110 * i, int(SR), SR)
        pool.load_track(name, [x, 0.5 * x])
        pool.start(name, rate=0.8 + 0.4 * i, semitones=3.0 * i)


@pytest.mark.parametrize("engine", ENGINES)
def test_grow_keeps_existing_voices_bit_for_bit(engine):
    plain, grown = _pool(engine), _pool(engine)
    _start(plain)
    _start(grown)
    for _ in range(2):
        np.testing.assert_array_equal(plain.step(fetch=True)[0], grown.step(fetch=True)[0])
    grown.grow(5)
    assert grown.capacity == 5 and len(grown.slots) == 5
    assert all(x.shape[0] == 5 for _, x in keyed_leaves(grown.states))
    for _ in range(3):
        (m1, s1), (m2, s2) = plain.step(fetch=True), grown.step(fetch=True)
        np.testing.assert_array_equal(m1, m2)
        assert torch.equal(s1, s2[:2]) and not s2[2:].any()
    assert np.abs(m1).max() > 1e-3
    # a fresh slot plays once loaded
    _start(grown, ("s03",))
    grown.step(fetch=True)
    assert grown._last_streams[3].abs().max() > 0


def test_grow_names_skip_taken_ones():
    names = ["s02", "s03"]
    pool = StreamPool(capacity=2, names=list(names), max_track_sec=1.0, device="cpu")
    jpool = JStreamPool(capacity=2, names=list(names), max_track_sec=1.0)
    pool.grow(4)
    jpool.grow(4)
    assert [s.name for s in pool.slots] == [s.name for s in jpool.slots] == [
        "s02", "s03", "s04", "s05"]
    pool.grow(3)   # never shrinks
    assert pool.capacity == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_pipelined_fetch_equals_blocking_fetch(engine):
    blocking, piped = _pool(engine), _pool(engine)
    _start(blocking)
    _start(piped)
    want, got = [], []
    for k in range(7):
        if k == 3:
            blocking.grow(4)
            piped.grow(4)
        want.append(blocking.step(fetch=True)[0])
        master, _ = piped.step(fetch="pipeline")
        assert (master is None) == (k < piped.pipeline_depth)
        if master is not None:
            got.append(master)
    rest = piped.drain()
    assert len(rest) == piped.pipeline_depth and piped.drain() == []
    got += rest
    assert all(isinstance(m, np.ndarray) for m in got)
    np.testing.assert_array_equal(np.concatenate(want, -1), np.concatenate(got, -1))


@pytest.mark.parametrize("engine", ENGINES)
def test_analyze_matches_jax(engine):
    pool, jpool = _pool(engine), _pool(engine, cls=JStreamPool, cfg=JStretchConfig)
    assert pool.analyze("s00") is None
    for p in (pool, jpool):
        _start(p)
        for _ in range(3):
            p.step(fetch=True)
    # the two pools' streams agree to the slice bound; the analysis is held
    # to JAX's on the same retained streams
    got_s, want_s = pool._last_streams.numpy(), np.asarray(jpool._last_streams)
    snr = 10 * np.log10(np.mean(want_s ** 2) / max(np.mean((want_s - got_s) ** 2), 1e-30))
    assert snr >= 60.0, snr
    jpool._last_streams = jnp.asarray(got_s)
    for slot in ("s00", "s01"):
        got, want = pool.analyze(slot, n_buckets=64), jpool.analyze(slot, n_buckets=64)
        assert set(got) == set(want) and got["slot"] == slot
        assert got["spectrumHzPerBin"] == want["spectrumHzPerBin"]
        peak = float(np.abs(got_s[pool._by_name[slot]]).max())
        assert peak > 1e-3
        g, w = np.asarray(got["scope"]), np.asarray(want["scope"])
        assert g.shape == w.shape == (64, 2)
        assert np.abs(g - w).max() <= 1e-5 * peak + 1e-5
        for key in ("rms", "peak"):
            assert np.abs(np.subtract(got["levels"][key], want["levels"][key])).max() \
                <= 1e-5 * peak + 1e-6
        g, w = np.asarray(got["spectrum"]), np.asarray(want["spectrum"])
        loud = w > -100.0
        assert g.shape == w.shape and loud.any()
        assert np.abs(g - w)[loud].max() <= 0.2 + 1e-9
    assert pool.analyze("nope") is None
    # after growth a fresh slot reads the silence it has not rendered yet
    pool.grow(4)
    fresh = pool.analyze("s03")
    assert max(fresh["levels"]["peak"]) == 0.0
    assert pool.analyze("s00") == pool.analyze("s00")
