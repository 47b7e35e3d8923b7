"""PyTorch port, ``serve/livepool.py`` and ``engine/live.py``: the cases of
``tests/test_livepool.py`` on the port (``device="cpu"``), with both
engines where they apply, and the port's ``LivePool`` against the JAX
package's on the same input.

Bound against JAX: output SNR >= 60 dB, the pool bound of
``tests/test_torch_pool.py`` (the JAX step is one jitted graph whose fused
arithmetic rounds otherwise than the port's eager form)."""

from __future__ import annotations

import numpy as np
import pytest

import torch

from bauklank_tpu.engine.config import StretchConfig as JStretchConfig
from bauklank_tpu.serve.livepool import LivePool as JLivePool
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.fidelity import SpectralConfig, init_batched_live_fidelity_state
from bauklank_tpu_torch.serve.livepool import LivePool, _live_fidelity_step
from tests.util import dominant_freq, snr_db, tone

torch.set_num_threads(1)
SR = 44100.0


def _pool(cfg, capacity, names, engine="fast", hops=1):
    return LivePool(capacity=capacity, sample_rate=SR, channels=1, config=cfg, names=names,
                    hops_per_step=hops, engine=engine, device="cpu")


@pytest.mark.parametrize("engine,hops", [("fast", 1), ("fidelity", 8)])
def test_livepool_per_stream_shifts_and_underrun(engine, hops):
    cfg = StretchConfig(channels=1, block=1024, interval=256, formants=False)
    pool = _pool(cfg, 3, ["a", "b", "c"], engine, hops)
    pool.schedule("a", {"output": 0.0, "active": True, "semitones": 0})
    pool.schedule("b", {"output": 0.0, "active": True, "semitones": 12})
    pool.schedule("c", {"output": 0.0, "active": True})
    n = 24576 if engine == "fast" else 12288   # the CPU's plain band chain is slow
    x = tone(440.0, n, SR)
    pool.feed("a", x)
    pool.feed("b", x)
    # c gets NO input -> silence
    outs = [pool.step() for _ in range(n // (cfg.interval * hops))]
    y = np.concatenate(outs, axis=2)  # [3, 1, T]
    seg_a = y[0, 0, 4 * cfg.block:]
    seg_b = y[1, 0, 4 * cfg.block:]
    assert abs(dominant_freq(seg_a, SR) - 440.0) < 6.0
    assert abs(dominant_freq(seg_b, SR) - 880.0) < 8.0
    assert np.abs(y[2]).max() < 1e-6
    assert np.sqrt((seg_a ** 2).mean()) > 0.1


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_livepool_control_plane_interface(engine):
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)
    pool = _pool(cfg, 2, ["a", "b"], engine)
    assert pool.apply_set("a", "tone", -100)  # clamped
    assert pool.timemaps[0].segments[-1].semitones == -48.0
    assert pool.apply_set("a", "tonalityHz", 12000)
    assert pool.apply_set("a", "volume", 50)   # acknowledged no-op for live
    assert not pool.apply_set("zz", "tone", 1)
    assert not pool.apply_set("a", "bogus", 1)
    pool.schedule("a", {"output": 0.0, "active": True})
    pool.feed("a", np.zeros(512, np.float32))
    out = pool.step()
    assert out.shape == (2, 1, 128)
    m = pool.metrics()
    assert m["steps"] == 1 and m["p50_ms"] >= 0


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_livepool_multi_hop_steps_match_single(engine):
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)
    n = 8192 if engine == "fast" else 4096
    x = tone(550.0, n, SR)

    def run(hps):
        pool = _pool(cfg, 2, ["a", "b"], engine, hps)
        pool.schedule("a", {"output": 0.0, "active": True, "semitones": 7})
        pool.schedule("b", {"output": 0.0, "active": True})
        pool.feed("a", x)
        pool.feed("b", x * 0.5)
        outs = [pool.step() for _ in range(n // (cfg.interval * hps))]
        return np.concatenate(outs, axis=2)

    np.testing.assert_allclose(run(1), run(4), atol=2e-4)


def test_livepool_fidelity_engine():
    """The blob-exact coupled mode serves live voices: the pitch shift
    applies, a starved voice is silent, and the pool's plumbing (FIFO
    chunking, parameter packing, state threading) is bit-identical to
    driving its own step with hand-built chunks."""
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)
    pool = _pool(cfg, 2, ["a", "b"], "fidelity", 8)
    pool.schedule("a", {"output": 0.0, "active": True, "semitones": 12})
    pool.schedule("b", {"output": 0.0, "active": True})
    x = tone(440.0, 10240, SR)
    pool.feed("a", x)
    n = cfg.interval * 8
    y = np.concatenate([pool.step() for _ in range(10240 // n)], axis=2)
    seg_a = y[0, 0, 4 * cfg.block:]
    assert abs(dominant_freq(seg_a, SR) - 880.0) < 8.0
    assert np.sqrt((seg_a ** 2).mean()) > 0.1
    assert np.abs(y[1]).max() < 1e-6

    scfg = SpectralConfig(1, 512, 128)
    st = init_batched_live_fidelity_state(scfg, 8, 2, "cpu")
    packed = np.zeros((2, 7), np.float32)
    packed[0] = (1.0, 1.0, 2.0 ** (12 / 12.0), 8000.0 / SR, 1.0, 0.0, 0.0)
    packed[1] = (1.0, 1.0, 1.0, 8000.0 / SR, 1.0, 0.0, 0.0)
    ref = []
    for c in range(10240 // n):
        chunk = np.zeros((2, 1, n), np.float32)
        chunk[0, 0] = x[c * n:(c + 1) * n]
        st, emit = _live_fidelity_step(scfg, st, torch.from_numpy(chunk),
                                       torch.from_numpy(packed))
        ref.append(emit.numpy())
    np.testing.assert_array_equal(y, np.concatenate(ref, axis=-1))


def test_livepool_grow_keeps_voices_and_names():
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)
    x = tone(550.0, 4096, SR)
    plain, grown = _pool(cfg, 2, ["l01", "l02"]), _pool(cfg, 2, ["l01", "l02"])
    for p in (plain, grown):
        p.schedule("l01", {"output": 0.0, "active": True, "semitones": 5})
        p.feed("l01", x)
        p.step()
    grown.grow(4)
    assert grown.names == ["l01", "l02", "l03", "l04"] and grown.capacity == 4
    for _ in range(6):
        a, b = plain.step(), grown.step()
        np.testing.assert_array_equal(a, b[:2])
    assert np.abs(a).max() > 1e-3
    grown.clear_voice("l01")
    assert not grown.step()[0].any()


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_livepool_matches_jax(engine):
    """Two voices (one shifted +7 st with formant compensation in
    force after the first steps, one plain), 4 hops a step."""
    kw = dict(capacity=2, sample_rate=SR, channels=2, names=["a", "b"], hops_per_step=4,
              engine=engine)
    jpool = JLivePool(config=JStretchConfig(channels=2, block=1024, interval=256), **kw)
    pool = LivePool(config=StretchConfig(channels=2, block=1024, interval=256), device="cpu",
                    **kw)
    rng = np.random.default_rng(5)
    x = np.stack([tone(330.0, 16384, SR), 0.3 * rng.standard_normal(16384).astype(np.float32)])
    outs = {}
    for name, p in (("jax", jpool), ("port", pool)):
        p.schedule("a", {"output": 0.0, "active": True, "semitones": 7})
        p.schedule("b", {"output": 0.0, "active": True})
        p.feed("a", x)
        p.feed("b", x[::-1] * 0.5)
        got = []
        for k in range(8):
            if k == 3:
                assert p.apply_set("a", "formantCompensation", True, lookahead=0.0)
            got.append(np.asarray(p.step()))
        outs[name] = np.concatenate(got, axis=-1)
    want, got = outs["jax"], outs["port"]
    assert got.shape == want.shape == (2, 2, 8 * 4 * 256)
    assert np.abs(want).max() > 1e-2
    assert snr_db(want, got) >= 60.0, snr_db(want, got)
