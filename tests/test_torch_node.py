"""PyTorch port, ``node/node.py`` (``StretchNode``): the cases of
``tests/test_node.py`` and the node case of ``tests/test_live.py`` on the
port (``device="cpu"``), and the port's node against the JAX package's.

Bound against JAX: output SNR >= 60 dB, the pool bound of
``tests/test_torch_pool.py``.  The long-step case (``configure(block=2048,
interval=64)``, long_step 32) runs the band chain past the old limit of
16."""

import numpy as np
import pytest

import torch

from bauklank_tpu.node import StretchNode as JStretchNode
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.node import StretchNode
from tests.util import dominant_freq, snr_db, tone

torch.set_num_threads(1)
SR = 44100.0
CFG = StretchConfig(channels=1, block=1024, interval=256, formants=False)


def _node(**kw):
    cfg = StretchConfig(channels=1, block=1764, interval=441)
    return StretchNode(sample_rate=SR, channels=1, config=cfg, device="cpu", **kw)


def test_node_plays_tone_at_rate():
    node = _node()
    node.add_buffers([tone(440.0, int(4 * SR), SR)])
    node.start(when=0.0, offset=0.0, rate=0.5)
    out = node.process_output(int(1.5 * SR))
    assert out.shape == (1, int(1.5 * SR))
    seg = out[0, 2 * node.block_samples : 2 * node.block_samples + 8192]
    assert abs(dominant_freq(seg, SR) - 440.0) < 3.0
    # playhead advanced at the configured rate
    assert node.input_time == pytest.approx(
        (1.5 + node.output_latency / SR) * 0.5, abs=0.05
    )


def test_node_inactive_outputs_silence():
    node = _node()
    node.add_buffers([tone(440.0, int(SR), SR)])
    out = node.process_output(8192)  # initial segment: inactive
    assert np.max(np.abs(out)) == 0.0


def test_node_stop_silences_later_output():
    node = _node()
    node.add_buffers([tone(330.0, int(4 * SR), SR)])
    node.start(when=0.0, offset=0.0, rate=1.0)
    node.stop(when=0.5)
    out = node.process_output(int(1.5 * SR))
    head = out[0, : int(0.3 * SR)]
    tail = out[0, int(1.0 * SR) :]
    assert np.sqrt(np.mean(head**2)) > 0.05
    assert np.sqrt(np.mean(tail**2)) < 0.02


def test_node_schedule_rate_change_moves_playhead_rate():
    node = _node()
    node.add_buffers([np.random.default_rng(0).standard_normal(int(6 * SR)).astype(np.float32) * 0.2])
    node.start(when=0.0, offset=0.0, rate=1.0)
    node.schedule({"output": 0.5, "rate": 0.1})
    node.process_output(int(2.0 * SR))
    lat = node.output_latency / SR
    want = 0.5 + (2.0 + lat - 0.5) * 0.1
    assert node.input_time == pytest.approx(want, abs=0.05)


def test_node_configure_overlap_and_latency():
    node = _node()
    node.configure(blockMs=100, overlap=2.0, splitComputation=True)
    assert node.block_samples == 4608  # 4410 rounded to the FFT-fast grid
    assert node.interval_samples == 2205
    assert node.latency() == pytest.approx((2304 + 2304 + 2205) / SR)
    node.configure(preset="cheaper")
    assert node.block_samples == 4608  # round(SR*0.1) -> fast grid
    assert node.interval_samples == round(SR * 0.04)


def test_node_configure_overlap_clamped_like_reference():
    # the reference UI clamps overlap to [1, 8] (app/multi/app.mjs:410);
    # overlap < 1 would mean interval > block, where the blob's Kaiser
    # bandwidth law has no real beta (NaN window)
    node = _node()
    node.configure(blockMs=100, overlap=0.75)
    assert node.interval_samples <= node.block_samples
    node.configure(blockMs=100, overlap=100.0)
    assert node.interval_samples == round(4410 / 8.0)
    with pytest.raises(ValueError):
        node.configure(blockMs=100, intervalMs=150)


def test_node_loop_region_wraps_playhead():
    """loopStart/loopEnd wrap the input playhead during playback (reference
    loop wrap in the render loop, app/SignalsmithStretch.mjs:884-889)."""
    node = _node()
    node.add_buffers([tone(440.0, int(3 * SR), SR)])
    node.schedule({"output": 0.0, "active": True, "rate": 1.0, "input": 0.5,
                   "loopStart": 0.5, "loopEnd": 1.0})
    node.process_output(int(2.5 * SR))
    t = node.input_time
    assert 0.45 <= t <= 1.05, t  # stayed inside the loop region
    # and the audio keeps playing (not silence after the wrap)
    out = node.process_output(8192)
    assert np.sqrt((out**2).mean()) > 0.1


def test_node_update_callback_fires():
    node = _node()
    node.add_buffers([tone(220.0, int(2 * SR), SR)])
    node.start(when=0.0, offset=0.0)
    times = []
    node.set_update_interval(0.1, times.append)
    node.process_output(int(0.5 * SR))
    assert len(times) >= 3


def test_rate_schedule_rides_one_dispatch():
    """Boundaries that change only timing (rate) no longer split dispatches:
    a 9-segment rate sweep renders in big hop buckets, and the output
    matches a hop-at-a-time render (chunking invariance across segments)."""
    sr = 8000.0
    x = tone(440.0, int(4 * sr), sr)
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)

    def build():
        node = StretchNode(sample_rate=sr, channels=1, config=cfg,
                           hops_per_dispatch=1, device="cpu")
        node.add_buffers([x])
        node.start(when=0.0, offset=0.0, rate=0.5)
        for k in range(9):
            node.schedule({"output": k * 0.25, "rate": 0.5 + 1.5 * k / 8})
        return node

    fast = build()
    calls = []
    orig = fast._render_hops
    fast._render_hops = lambda n: (calls.append(n), orig(n))[1]
    out_fast = fast.process_output(int(2.0 * sr))
    assert max(calls) >= 64, calls  # big buckets despite 8 boundaries

    slow = build()
    n = int(2.0 * sr)
    out_slow = np.concatenate(
        [slow.process_output(128) for _ in range(n // 128)], axis=1)
    np.testing.assert_allclose(out_fast, out_slow, atol=1e-4)


def test_node_live_process_arbitrary_chunks():
    node = StretchNode(sample_rate=SR, channels=1, config=CFG, device="cpu")
    node.schedule({"output": 0.0, "active": True, "semitones": 0})
    x = tone(550.0, 16384, SR)
    outs = []
    pos = 0
    for size in (100, 333, 1024, 4096, 7000, 3331):
        out = node.process(x[pos : pos + size])
        assert out.shape == (1, size)
        outs.append(out)
        pos += size
    y = np.concatenate(outs, axis=1)[0]
    seg = y[CFG.block * 3 :]
    assert abs(dominant_freq(seg, SR) - 550.0) < 6.0


def _drive(node, n_out: int, formants: bool = False):
    """A stereo tone pair at rate 0.8 and +3 st from 0.5 s into the track;
    a rate change and (with ``formants``) a formant shift scheduled."""
    x = tone(330.0, int(3 * SR), SR)
    node.add_buffers([x, 0.5 * tone(495.0, int(3 * SR), SR)])
    node.start(when=0.0, offset=0.5, rate=0.8, semitones=3.0)
    node.schedule({"output": 0.15, "rate": 1.25})
    if formants:
        node.schedule({"output": 0.1, "formantSemitones": 4.0})
    outs = [node.process_output(n) for n in (1000, n_out - 1000)]
    return np.concatenate(outs, axis=1), node.input_time, node.flush()


@pytest.mark.parametrize("engine,formants", [("fast", False), ("fast", True),
                                             ("fidelity", False)])
def test_node_matches_jax(engine, formants):
    kw = dict(sample_rate=SR, channels=2, engine=engine)
    n_out = int(0.2 * SR)
    want, want_t, want_tail = _drive(JStretchNode(**kw), n_out, formants)
    got, got_t, got_tail = _drive(StretchNode(device="cpu", **kw), n_out, formants)
    assert got.shape == want.shape == (2, n_out)
    assert np.abs(want).max() > 1e-2
    assert snr_db(want, got) >= 60.0, snr_db(want, got)
    assert got_t == want_t
    assert got_tail.shape == want_tail.shape and snr_db(want_tail, got_tail) >= 60.0


def test_fidelity_node_past_the_old_long_step_bound():
    """configure(block=2048, interval=64): long_step 32, the band chain's
    shared history at its limit (the old kernel refused any long_step
    above 16, on the CPU too).  No pitch shift: at this overlap (32) a
    shifted voice renders NaN in both packages (ROADMAP, faults)."""
    kw = dict(sample_rate=SR, channels=1, engine="fidelity")
    outs = []
    for node in (JStretchNode(**kw), StretchNode(device="cpu", **kw)):
        node.configure(block=2048, interval=64)
        node.add_buffers([tone(440.0, int(SR), SR)])
        node.start(when=0.0, offset=0.3, rate=0.7)
        outs.append(node.process_output(16 * 64))
    assert node.drive.scfg.long_step == 32 and node.block_samples == 2048
    want, got = outs
    assert np.abs(want).max() > 1e-2
    assert snr_db(want, got) >= 60.0, snr_db(want, got)


def test_node_fidelity_keeps_the_raw_block_and_flushes():
    node = StretchNode(sample_rate=SR, channels=1, engine="fidelity", device="cpu")
    assert node.block_samples == round(SR * 0.12) and node.interval_samples == round(SR * 0.03)
    node.configure(blockMs=200, overlap=1.0, splitComputation=True)   # the kiosk
    assert (node.block_samples, node.interval_samples) == (8820, 8820)
    assert node.drive.scfg.long_step == 1
    node.add_buffers([tone(330.0, int(SR), SR)])
    node.start(when=0.0, offset=0.0, rate=0.25, semitones=-5)
    out = node.process_output(2 * 8820)
    tail = node.flush()
    assert out.shape == (1, 2 * 8820) and tail.shape == (1, 8820 + 8820)
    assert np.abs(tail).max() > 0 and not node.flush().any()


def test_node_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StretchNode()
