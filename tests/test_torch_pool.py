"""PyTorch port, serving: ``StreamPool(engine="fidelity", device="cpu")``
against the JAX package's fidelity pool, driven through the same control
surface — tracks, voice starts, and ``set`` messages parsed with
``protocol.parse_line`` and mapped to pool keys as the server maps them
(``serve/server.py``: tone -> semitones, volume -> volumePercent).

Bound: master SNR >= 60 dB over 4 steps.  The JAX pool step is one jitted
graph, whose fused arithmetic rounds otherwise than the eager form the
port mirrors; the renderer amplifies those ulps over the hops, hence an
SNR bound.
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


def _drive(pool):
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


def test_pool_refuses_formants_and_fast_engine():
    pool = StreamPool(capacity=2, config=StretchConfig(block=1024, interval=256),
                      max_track_sec=1.0, hops_per_step=4, device="cpu")
    pool.load_track("s00", [np.zeros(44100, np.float32)])
    pool.start("s00", rate=1.0)
    pool.step()
    assert pool.apply_set("s00", "formantSemitones", 4.0, lookahead=0.0)
    with pytest.raises(NotImplementedError, match="formant"):
        pool.step()
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        StreamPool(capacity=1, engine="fast")


def test_pool_clear_voice_resets_row():
    pool = StreamPool(capacity=2, config=StretchConfig(block=1024, interval=256),
                      max_track_sec=1.0, hops_per_step=4, device="cpu")
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
