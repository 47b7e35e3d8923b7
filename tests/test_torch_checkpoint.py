"""PyTorch port, ``utils/checkpoint.py``: kill and resume in the port (bit
for bit), mismatches refused, and checkpoints carried across packages: a
``UnifiedPool`` saved by the JAX package resumes in the port, and the
reverse, each continuation >= 60 dB against the saving package's own
(the pool bound of ``tests/test_torch_pool.py``: the two packages' steps
round differently, the states they hand over are the same bits)."""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch

from bauklank_tpu.serve.unified import UnifiedPool as JUnifiedPool
from bauklank_tpu.utils import checkpoint as jcheckpoint
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.serve.unified import UnifiedPool
from bauklank_tpu_torch.utils import checkpoint
from tests.util import snr_db, tone

torch.set_num_threads(1)
SR = 8000.0
TRACK = [tone(440.0, int(2 * SR), SR)] * 2
LIVE_SRC = tone(990.0, int(2 * SR), SR)


def _unified(cls=UnifiedPool, **kw):
    kw = {"sample_rate": SR, "max_track_sec": 2.0, "quantum": 256, **kw}
    if cls is UnifiedPool:
        kw.setdefault("device", "cpu")
    return cls(**kw)


def _build(cls=UnifiedPool, engine="fast"):
    """A file voice and a live voice in two buckets, pipelined fetches."""
    pool = _unified(cls, names=["A"], pipeline_fetch=True, engine=engine)
    pool.load_track("A", TRACK)
    pool.start("A", when=0.0, offset=0.0, rate=0.8)
    pool.apply_set("A", "semitones", 3)
    pool.add_voice("L", mode="live", volume=0.5, block_ms=60.0, overlap=2.0)
    pool.schedule("L", {"output": 0.0, "active": True, "semitones": -2})
    return pool


def _run(pool, quanta: int, fed: int):
    outs = []
    for _ in range(quanta):
        pool.feed("L", LIVE_SRC[fed:fed + 256])
        fed += 256
        outs.append(pool.render(256))
    return np.concatenate(outs, axis=1), fed


def _to_checkpoint(pool, tmp_path, name):
    """Run 12 quanta, queue live input and a control change that must
    survive, save; return (path, samples of live input fed)."""
    _, fed = _run(pool, 12, 0)
    pool.feed("L", LIVE_SRC[fed:fed + 300])
    pool.apply_set("A", "rate", 0.5)
    path = tmp_path / name
    (jcheckpoint if isinstance(pool, JUnifiedPool) else checkpoint).save_pool(path, pool)
    return path, fed + 300


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_unified_kill_and_resume_bit_for_bit(tmp_path, engine):
    pool = _build(engine=engine)
    path, fed = _to_checkpoint(pool, tmp_path, "u")
    want, _ = _run(pool, 10, fed)
    fresh = _unified(pipeline_fetch=True, engine=engine)
    checkpoint.load_pool(path, fresh)
    fresh.load_track("A", TRACK)
    got, _ = _run(fresh, 10, fed)
    assert fresh.out_pos == pool.out_pos
    assert {k[0] for k in fresh.buckets} == {"file", "live"}
    assert np.abs(want).max() > 1e-3
    np.testing.assert_array_equal(want, got)


def test_stream_pool_kill_and_resume_bit_for_bit(tmp_path):
    """A fidelity pool with masters in flight: drained before the save,
    the stream continues bit for bit in a fresh pool."""
    def build():
        pool = StreamPool(capacity=3, sample_rate=SR, channels=2, max_track_sec=2.0,
                          config=StretchConfig(block=1024, interval=256), hops_per_step=2,
                          engine="fidelity", device="cpu")
        for i in range(2):
            pool.load_track(f"s0{i}", TRACK)
            pool.start(f"s0{i}", rate=0.7 + 0.5 * i, semitones=2.0 * i)
        return pool

    pool = build()
    head = [pool.step(fetch="pipeline")[0] for _ in range(4)]
    assert head[0] is None and head[2] is not None
    in_flight = pool.drain()
    assert len(in_flight) == pool.pipeline_depth
    pool.apply_set("s01", "rate", 1.4)
    path = tmp_path / "p"
    checkpoint.save_pool(path, pool)
    want = [pool.step(fetch=True)[0] for _ in range(4)]
    fresh = build()
    checkpoint.load_pool(path, fresh)
    for i in range(2):
        fresh.load_track(f"s0{i}", TRACK)
    got = [fresh.step(fetch=True)[0] for _ in range(4)]
    assert fresh.out_pos == pool.out_pos
    np.testing.assert_array_equal(np.concatenate(want, -1), np.concatenate(got, -1))
    with pytest.raises(ValueError, match="capacity"):
        checkpoint.load_pool(path, StreamPool(capacity=2, max_track_sec=2.0, device="cpu"))


def test_unified_mismatch_rejected(tmp_path):
    pool = _unified(names=["A"])
    path = tmp_path / "u2"
    checkpoint.save_pool(path, pool)
    with pytest.raises(ValueError, match="quantum"):
        checkpoint.load_pool(path, _unified(quantum=128))
    with pytest.raises(ValueError, match="engine"):
        checkpoint.load_pool(path, _unified(engine="fidelity"))
    with pytest.raises(ValueError, match="capacity"):
        checkpoint.load_pool(path, _unified(bucket_capacity=8))
    (tmp_path / "u2.meta.json").write_text(json.dumps({"kind": "pool"}))
    with pytest.raises(ValueError, match="unified"):
        checkpoint.load_unified(path, _unified())


def test_pytree_round_trip(tmp_path):
    from bauklank_tpu_torch.engine.fidelity import SpectralConfig, init_batched_fidelity_state

    state = init_batched_fidelity_state(SpectralConfig(2, 512, 128), 3, "cpu")
    state[0].prev_output.real.normal_()
    checkpoint.save_pytree(tmp_path / "t.npz", state)
    back = checkpoint.load_pytree(tmp_path / "t.npz", state)
    assert type(back[0]) is type(state[0])
    assert all(torch.equal(a, b) for a, b in zip((*back[0], back[1]), (*state[0], state[1])))
    assert sorted(np.load(tmp_path / "t.npz").files) == sorted(
        ["[0].prev_output", "[0].prev_pred_energy", "[0].rng", "[0].f_value_ema",
         "[0].f_weighted_ema", "[1]"])


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer, engine):
    """Saved by one package, resumed by the other: the next quanta against
    the saving pool's own continuation.  The npz keys and meta are the
    same in both directions."""
    src_cls, dst_cls = (JUnifiedPool, UnifiedPool) if writer == "jax" else (UnifiedPool,
                                                                            JUnifiedPool)
    pool = _build(src_cls, engine)
    path, fed = _to_checkpoint(pool, tmp_path, "x")
    keys = sorted(np.load(path.with_suffix(".state.npz")).files)
    want, _ = _run(pool, 8, fed)
    fresh = _unified(dst_cls, pipeline_fetch=True, engine=engine)
    (jcheckpoint if dst_cls is JUnifiedPool else checkpoint).load_pool(path, fresh)
    fresh.load_track("A", TRACK)
    got, _ = _run(fresh, 8, fed)
    assert fresh.out_pos == pool.out_pos
    assert np.abs(want).max() > 1e-3
    assert snr_db(want, got) >= 60.0, snr_db(want, got)
    # the other package writes the same keys
    (jcheckpoint if dst_cls is JUnifiedPool else checkpoint).save_pool(tmp_path / "y", fresh)
    assert sorted(np.load(tmp_path / "y.state.npz").files) == keys
