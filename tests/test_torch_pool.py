"""PyTorch port, serving: ``StreamPool(engine="fast" | "fidelity",
device="cpu")`` against the JAX package's pools, driven through the same control
surface — tracks, voice starts, and ``set`` messages parsed with
``protocol.parse_line`` and mapped to pool keys as the server maps them
(``serve/server.py``: tone -> semitones, volume -> volumePercent).

A fidelity pool with formant voices is held to the same bound.

Bound: master SNR >= 60 dB.  The JAX pool step is one jitted graph,
whose fused arithmetic rounds otherwise than the eager form the port
mirrors; the fidelity renderer amplifies those ulps over the hops, and
the fast engine's formant gain sits behind a log and an exp (the JAX
package's own jitted and eager forms differ there at about 68 dB), hence
an SNR bound.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

import torch

from bauklank_tpu.engine.config import StretchConfig as JStretchConfig
from bauklank_tpu.serve.pool import StreamPool as JStreamPool
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.serve import protocol
from bauklank_tpu_torch.serve.pool import StreamPool

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
SERVER_KEYS = {"tone": "semitones", "volume": "volumePercent"}
MESSAGES = [
    '{"type": "set", "channel": "s00", "key": "rate", "value": 0.8}',
    '{"type": "set", "channel": "s01", "key": "tone", "value": -5}',
    '{"type": "set", "channel": "s02", "key": "volume", "value": 60}',
    '{"type": "set", "channel": "s01", "key": "pan", "value": 0.5}',
    '{"type": "set", "channel": "s00", "key": "rate", "value": NaN}',
]


def _drive(pool, formants=False):
    """Three voices, four steps, the ``set`` messages at step 1; with
    ``formants`` also a formant shift on s02 and formant compensation on
    s01 (under its pitch shift), both on auto f0 and in force at once."""
    x = material.case_input(2.0, 2, seconds=1.0)
    for i, (rate, st) in enumerate([(0.5, 0.0), (1.3, 3.0), (1.0, 0.0)]):
        pool.load_track(f"s{i:02d}", np.roll(x, 977 * i, axis=-1))
        pool.start(f"s{i:02d}", rate=rate, semitones=st)
    masters = []
    for step in range(4):
        if step == 1:
            for line in MESSAGES:
                msg = protocol.parse_line(line)
                key = SERVER_KEYS.get(msg["key"], msg["key"])
                ok = pool.apply_set(msg["channel"], key, msg["value"])
                assert ok == (msg["value"] == msg["value"])   # NaN refused
            if formants:
                assert pool.apply_set("s02", "formantSemitones", 4.0, lookahead=0.0)
                assert pool.apply_set("s01", "formantCompensation", True, lookahead=0.0)
        master, _ = pool.step(fetch=True)
        masters.append(np.asarray(master))
    return np.concatenate(masters, axis=-1)


def test_pool_matches_jax_pool():
    kw = dict(capacity=3, sample_rate=44100.0, channels=2, max_track_sec=2.0,
              hops_per_step=8, engine="fidelity")
    want = _drive(JStreamPool(config=JStretchConfig(block=1024, interval=256), **kw))
    pool = StreamPool(config=StretchConfig(block=1024, interval=256), device="cpu", **kw)
    assert pool.scfg.long_step == 4
    got = _drive(pool)
    assert got.shape == want.shape == (2, 4 * 8 * 256)
    assert np.abs(want).max() > 1e-3
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((want - got) ** 2), 1e-30))
    assert snr >= 60.0, snr
    m = pool.metrics()
    assert m["steps"] == 4 and m["rtf"] > 0


def test_fidelity_pool_with_a_formant_voice_matches_jax_pool(monkeypatch):
    from bauklank_tpu_torch.serve import pool as pool_mod

    kw = dict(capacity=3, sample_rate=44100.0, channels=2, max_track_sec=2.0,
              hops_per_step=8, engine="fidelity")
    want = _drive(JStreamPool(config=JStretchConfig(block=1024, interval=256), **kw), True)
    seen = []
    step = pool_mod._pool_step_fidelity
    monkeypatch.setattr(pool_mod, "_pool_step_fidelity",
                        lambda scfg, *a: (seen.append((scfg.formants, a[-1])), step(scfg, *a))[1])
    pool = StreamPool(config=StretchConfig(block=1024, interval=256), device="cpu", **kw)
    got = _drive(pool, formants=True)
    assert got.shape == want.shape == (2, 4 * 8 * 256)
    assert np.abs(want).max() > 1e-3
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((want - got) ** 2), 1e-30))
    assert snr >= 60.0, snr
    # the formant chain runs from the step the control takes effect, and
    # every step is told its regime (all rates >= 0.5: deterministic)
    formants = [f for f, _ in seen]
    assert formants == [False, True, True, True]
    assert all(det is True for _, det in seen)
    spec = pool.states[0]
    assert (spec.f_value_ema[1:] != 0).all() and spec.f_value_ema[0] == 0
    # and they are audible: the same drive without them differs
    plain = _drive(StreamPool(config=StretchConfig(block=1024, interval=256), device="cpu", **kw))
    assert 10 * np.log10(np.mean(plain ** 2) / np.mean((plain - got) ** 2)) < 30.0


def test_pool_refuses_fidelity_formants_and_unknown_engine():
    """A fidelity pool takes formant controls (it no longer refuses them);
    an unknown engine is still refused."""
    pool = StreamPool(capacity=2, config=StretchConfig(block=1024, interval=256),
                      max_track_sec=1.0, hops_per_step=4, engine="fidelity", device="cpu")
    pool.load_track("s00", [material.case_input(1.0, 1, seconds=0.5)[0]])
    pool.start("s00", rate=1.0)
    pool.step()
    assert pool.apply_set("s00", "formantSemitones", 4.0, lookahead=0.0)
    master, _ = pool.step(fetch=True)
    assert np.isfinite(master).all() and np.abs(master).max() > 0
    assert float(pool.states[0].f_value_ema[0]) != 0.0
    with pytest.raises(ValueError, match="unknown engine"):
        StreamPool(capacity=1, engine="phase-locked", device="cpu")


def test_pool_clear_voice_resets_row():
    pool = StreamPool(capacity=2, config=StretchConfig(block=1024, interval=256),
                      max_track_sec=1.0, hops_per_step=4, engine="fidelity", device="cpu")
    x = material.case_input(1.0, 2, seconds=0.5)
    for s in ("s00", "s01"):
        pool.load_track(s, x)
        pool.start(s, rate=0.25)
    pool.step()
    before = [leaf[1].clone() for leaf in (*pool.states[0], pool.states[1])]
    pool.clear_voice("s00")
    spec, tail = pool.states
    assert not spec.prev_output[0].any() and not tail[0].any() and int(spec.rng[0]) == 1
    for b, leaf in zip(before, (*spec, tail)):
        torch.testing.assert_close(leaf[1], b, rtol=0, atol=0)
    assert not pool.slots[0].loaded and pool.slots[1].loaded


def _drive_fast(pool, steps=6):
    """The fast pool: three voices, ``set`` messages at step 1 and a
    formant shift on s02 at step 2 (in force from the step its look-ahead
    reaches)."""
    x = material.case_input(1.0, 2, seconds=1.5)
    for i, (rate, st) in enumerate([(0.6, 7.0), (1.0, 0.0), (1.6, -7.0)]):
        pool.load_track(f"s{i:02d}", np.roll(x, 977 * i, axis=-1))
        pool.start(f"s{i:02d}", rate=rate, semitones=st)
    masters = []
    for step in range(steps):
        if step == 1:
            for line in MESSAGES:
                msg = protocol.parse_line(line)
                pool.apply_set(msg["channel"], SERVER_KEYS.get(msg["key"], msg["key"]),
                               msg["value"])
        if step == 2:
            assert pool.apply_set("s02", "formantSemitones", 4.0)
            assert pool.apply_set("s02", "formantCompensation", True)
        master, _ = pool.step(fetch=True)
        masters.append(np.asarray(master))
    return np.concatenate(masters, axis=-1)


def test_fast_pool_matches_jax_pool(monkeypatch):
    from bauklank_tpu_torch.serve import pool as pool_mod

    kw = dict(capacity=3, sample_rate=44100.0, channels=2, max_track_sec=2.0,
              hops_per_step=8)
    want = _drive_fast(JStreamPool(config=JStretchConfig(block=1024, interval=256), **kw))
    formants = []
    step = pool_mod._pool_step
    monkeypatch.setattr(pool_mod, "_pool_step", lambda cfg, *a: (formants.append(cfg.formants),
                                                                 step(cfg, *a))[1])
    pool = StreamPool(config=StretchConfig(block=1024, interval=256), device="cpu", **kw)
    assert pool.engine == "fast"
    got = _drive_fast(pool)
    assert got.shape == want.shape == (2, 6 * 8 * 256)
    assert np.abs(want).max() > 1e-3
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((want - got) ** 2), 1e-30))
    assert snr >= 60.0, snr
    # the formants-off step until the formant control takes effect, then the full one
    assert formants[:3] == [False] * 3 and formants[-1] is True
    assert formants == sorted(formants)
    assert pool.metrics()["steps"] == 6


def test_fast_pool_clear_voice_resets_row():
    pool = StreamPool(capacity=2, config=StretchConfig(block=1024, interval=256),
                      max_track_sec=1.0, hops_per_step=4, device="cpu")
    x = material.case_input(1.0, 2, seconds=0.5)
    for s in ("s00", "s01"):
        pool.load_track(s, x)
        pool.start(s, rate=0.75, semitones=3.0)
    pool.step()
    before = [leaf[1].clone() for leaf in pool.states]
    assert pool.states.ola_tail[0].any()
    pool.clear_voice("s00")
    rot, prev_cur, tail = pool.states
    assert torch.equal(rot[0], torch.ones_like(rot[0]))
    assert not prev_cur[0].any() and not tail[0].any()
    for b, leaf in zip(before, pool.states):
        torch.testing.assert_close(leaf[1], b, rtol=0, atol=0)
    assert not pool.slots[0].loaded and pool.slots[1].loaded
    assert pool._sizes == (1024, 256, 512 + 256)
