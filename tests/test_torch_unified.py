"""PyTorch port, ``serve/unified.py``: the cases of ``tests/test_unified.py``
that need no server, on the port (``device="cpu"``), and one render of the
port's ``UnifiedPool`` against the JAX package's.

Bound against JAX: master SNR >= 60 dB, the pool bound of
``tests/test_torch_pool.py``."""

import numpy as np
import pytest

import torch

from bauklank_tpu.serve.unified import UnifiedPool as JUnifiedPool
from bauklank_tpu_torch.serve.unified import UnifiedPool
from tests.util import snr_db, tone

torch.set_num_threads(1)
SR = 8000.0


def _pool(cls=UnifiedPool, **kw):
    kw.setdefault("sample_rate", SR)
    kw.setdefault("max_track_sec", 2.0)
    kw.setdefault("quantum", 256)
    if cls is UnifiedPool:
        kw.setdefault("device", "cpu")
    return cls(**kw)


def _dominant_hz(x, sr=SR):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.shape[-1])))
    return np.argmax(spec) * sr / x.shape[-1]


def test_file_voices_mix_and_share_bucket():
    pool = _pool(names=["A", "B"])
    pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
    pool.load_track("B", [tone(330.0, int(SR), SR)] * 2)
    assert len(pool.buckets) == 1  # same default config -> one bucket
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    pool.start("B", when=0.0, offset=0.0, rate=1.0)
    out = np.concatenate([pool.render(256) for _ in range(20)], axis=1)
    assert out.shape == (2, 5120)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3


def test_set_block_ms_moves_bucket_and_keeps_playing():
    pool = _pool(names=["A", "B"])
    for n, f in (("A", 440.0), ("B", 330.0)):
        pool.load_track(n, [tone(f, int(2 * SR), SR)] * 2)
        pool.start(n, when=0.0, offset=0.0, rate=1.0)
    for _ in range(10):
        pool.render(256)
    key_before = pool.voices["A"].bucket_key
    assert pool.apply_set("A", "blockMs", 60.0)
    assert pool.apply_set("A", "overlap", 2.0)
    key_after = pool.voices["A"].bucket_key
    assert key_after != key_before and len(pool.buckets) == 2
    cfg = pool.voice_config("A")
    assert cfg["blockSamples"] >= round(SR * 0.06)  # fft-fast rounding >= requested
    assert cfg["blockMs"] == 60.0 and cfg["overlap"] == 2.0
    # the moved voice keeps rendering its schedule (time map survived)
    out = np.concatenate([pool.render(256) for _ in range(30)], axis=1)
    assert np.isfinite(out).all()
    tail = out[0, -2048:]
    assert np.abs(tail).max() > 1e-3
    # both tones present in the mix
    spec = np.abs(np.fft.rfft(tail * np.hanning(tail.shape[0])))
    hz = np.arange(spec.shape[0]) * SR / tail.shape[0]
    assert spec[(np.abs(hz - 440) < 12)].max() > 0.05 * spec.max()
    assert spec[(np.abs(hz - 330) < 12)].max() > 0.05 * spec.max()


def test_mixed_file_and_live_pool():
    pool = _pool(names=["A"])
    pool.load_track("A", [tone(440.0, int(2 * SR), SR)] * 2)
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    pool.add_voice("L", mode="live", volume=0.5)
    pool.schedule("L", {"output": 0.0, "active": True})
    assert len(pool.buckets) == 2  # one file bucket + one live bucket
    chunks = []
    src = tone(990.0, int(2 * SR), SR)
    fed = 0
    for _ in range(40):
        pool.feed("L", src[fed : fed + 256])
        fed += 256
        chunks.append(pool.render(256))
    out = np.concatenate(chunks, axis=1)
    assert np.isfinite(out).all()
    tail = out[0, -2048:]
    spec = np.abs(np.fft.rfft(tail * np.hanning(tail.shape[0])))
    hz = np.arange(spec.shape[0]) * SR / tail.shape[0]
    assert spec[np.abs(hz - 440) < 12].max() > 0.05 * spec.max()  # file voice
    assert spec[np.abs(hz - 990) < 12].max() > 0.05 * spec.max()  # live voice


def test_live_voice_pitch_shift_applies():
    pool = _pool()
    pool.add_voice("L", mode="live", volume=1.0)
    pool.schedule("L", {"output": 0.0, "active": True})
    assert pool.apply_set("L", "semitones", 12.0)
    src = tone(300.0, int(4 * SR), SR)
    fed = 0
    chunks = []
    for _ in range(60):
        pool.feed("L", src[fed : fed + 256])
        fed += 256
        chunks.append(pool.render(256))
    tail = np.concatenate(chunks, axis=1)[0, -4096:]
    got = _dominant_hz(tail)
    assert abs(got - 600.0) < 25.0, got  # +12 st doubles the pitch


def test_bucket_growth_preserves_voices():
    pool = _pool(bucket_capacity=2)
    for k in range(5):
        name = f"v{k}"
        pool.add_voice(name)
        pool.load_track(name, [tone(200.0 + 50 * k, int(SR), SR)] * 2)
        pool.start(name, when=0.0, offset=0.0, rate=1.0)
    (b,) = pool.buckets.values()
    assert b.pool.capacity >= 5
    out = np.concatenate([pool.render(256) for _ in range(16)], axis=1)
    assert np.isfinite(out).all() and np.abs(out[0, -1024:]).max() > 1e-3


def test_apply_set_validation_and_mode_switch():
    pool = _pool(names=["A"])
    assert not pool.apply_set("A", "blockMs", float("nan"))
    assert not pool.apply_set("A", "blockMs", None)
    assert not pool.apply_set("nope", "rate", 1.0)
    assert pool.apply_set("A", "volumePercent", 50)
    assert pool.voices["A"].volume == 0.5
    # clamped to the UI range (app/multi/index.html:146-182)
    assert pool.apply_set("A", "blockMs", 10000.0)
    assert pool.voices["A"].block_ms == 500.0
    pool.set_mode("A", "live")
    assert pool.voices["A"].mode == "live"
    assert pool.voices["A"].bucket_key[0] == "live"
    pool.set_mode("A", "file")
    assert pool.voices["A"].bucket_key[0] == "file"
    # empty buckets are dropped once the last member leaves
    assert all(b.members for b in pool.buckets.values())


def test_remove_voice_frees_slot_and_bucket():
    pool = _pool(names=["A", "B"])
    pool.remove_voice("A")
    pool.remove_voice("B")
    assert not pool.buckets
    pool.add_voice("C")
    out = pool.render(256)
    assert out.shape == (2, 256)


def test_unified_pool_fidelity_engine():
    """UnifiedPool buckets honor engine="fidelity" (blob-exact voices in
    the heterogeneous pool)."""
    pool = _pool(names=["A"], engine="fidelity")
    pool.load_track("A", [tone(440.0, int(2 * SR), SR)] * 2)
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    out = np.concatenate([pool.render(256) for _ in range(30)], axis=1)
    assert np.isfinite(out).all()
    tail = out[0, -2048:]
    assert np.abs(tail).max() > 1e-3
    spec = np.abs(np.fft.rfft(tail * np.hanning(tail.shape[0])))
    hz = np.arange(spec.shape[0]) * SR / tail.shape[0]
    assert spec[np.abs(hz - 440) < 15].max() > 0.3 * spec.max()


def test_unified_live_voice_honors_fidelity_engine():
    """UnifiedPool(engine="fidelity") routes LIVE voices through the
    blob-exact coupled engine too — r4 VERDICT missing #2: live voices used
    to silently downgrade to the fast engine (old serve/unified.py:71-81)."""
    pool = _pool(names=["A"], engine="fidelity")
    pool.apply_set("A", "blockMs", 512 / 44.1)
    pool.apply_set("A", "overlap", 4.0)
    pool.schedule("A", {"output": 0.0, "active": True, "semitones": 12})
    x = tone(440.0, int(SR), SR)
    pool.feed("A", x)                      # switches the voice to live mode
    v = pool.voices["A"]
    b = pool.buckets[v.bucket_key]
    assert b.mode == "live" and b.pool.engine == "fidelity"
    out = np.concatenate([pool.render(256) for _ in range(40)], axis=1)
    tail = out[0, -4096:]
    assert np.isfinite(out).all() and np.abs(tail).max() > 1e-3
    assert abs(_dominant_hz(tail) - 880.0) < 10.0


def test_unified_pipeline_fetch_identical_stream():
    """pipeline_fetch overlaps bucket d2h with later dispatches; the
    rendered sample stream must be identical to blocking fetch."""

    def run(pipeline):
        pool = _pool(names=["A", "B"], pipeline_fetch=pipeline)
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.load_track("B", [tone(330.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=0.8)
        pool.start("B", when=0.0, offset=0.0, rate=1.2, semitones=3)
        return np.concatenate([pool.render(256) for _ in range(16)], axis=1)

    np.testing.assert_array_equal(run(False), run(True))


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_unified_matches_jax(engine):
    """Two file voices in two buckets (one moved by blockMs/overlap, one
    growing its bucket past its first capacity), a live voice, pipelined
    fetch: the master against the JAX pool's."""

    def run(cls):
        pool = _pool(cls, names=["A", "B", "C"], engine=engine, bucket_capacity=2,
                     pipeline_fetch=True)
        for k, name in enumerate(("A", "B", "C")):
            pool.load_track(name, [tone(330.0 + 110 * k, int(2 * SR), SR)] * 2)
            pool.start(name, when=0.0, offset=0.0, rate=0.8 + 0.2 * k, semitones=2.0 * k)
        pool.apply_set("B", "blockMs", 60.0)
        pool.apply_set("B", "overlap", 2.0)
        pool.add_voice("L", mode="live", volume=0.5)
        pool.schedule("L", {"output": 0.0, "active": True, "semitones": 5})
        src = tone(660.0, int(2 * SR), SR)
        out = []
        for q in range(12):
            pool.feed("L", src[q * 256:(q + 1) * 256])
            out.append(pool.render(256))
        return np.concatenate(out, axis=1), pool

    want, jpool = run(JUnifiedPool)
    got, pool = run(UnifiedPool)
    assert sorted(pool.buckets) == sorted(jpool.buckets)
    assert pool.metrics()["buckets"] == jpool.metrics()["buckets"]
    assert np.abs(want).max() > 1e-3
    assert snr_db(want, got) >= 60.0, snr_db(want, got)


def test_unified_analyze_file_and_live_voices():
    pool = _pool(names=["A"], pipeline_fetch=True)
    pool.load_track("A", [tone(440.0, int(2 * SR), SR)] * 2)
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    pool.add_voice("L", mode="live", volume=0.5)
    pool.schedule("L", {"output": 0.0, "active": True})
    assert pool.analyze("L") is None and pool.analyze("nope") is None
    for q in range(8):
        pool.feed("L", tone(990.0, 256, SR))
        pool.render(256)
    for name in ("A", "L"):
        a = pool.analyze(name, n_buckets=32)
        # a file voice's reply names its slot in the bucket, as in JAX
        assert a["slot"] == (pool.voices["A"].inner if name == "A" else name)
        assert len(a["scope"]) == 32
        assert max(a["levels"]["peak"]) > 1e-3
