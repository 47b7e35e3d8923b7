"""PyTorch port, the kiosk's own pool: ``StreamPool(engine="fidelity",
block=8820, interval=8820)`` driven as the golden case ``kiosk_r0001_st0``
(one voice, rate 0.001, 0 semitones, the blob's seed).

The pool's time map cannot reproduce that case's drive: the pool reads
each hop's input time at the hop's own output position, the worklet (and
``hop_frame_ends``) at the start of the 128-sample quantum holding it, so
at rate 0.001 the pool's frame end lies one sample later at some hops
(hop 4 of the first ten).  Its rate also reaches the device as float32,
so its time factor is f32(1 / f32(0.001)), not f32(1000).  So the pool
is held bit-equal to ``render_fidelity`` over the pool's own frame ends
at the same float32 rate, and its frame ends to the case's within one
sample; ``test_torch_golden_kiosk.py`` holds ``render_fidelity`` to the
blob above 40 dB at this geometry.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from bauklank_tpu_torch.engine import fidelity
from bauklank_tpu_torch.serve.pool import StreamPool

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

from test_torch_golden import FIXTURES  # noqa: E402

torch.set_num_threads(1)
NAME = "kiosk_r0001_st0"
HOPS = 2


def test_kiosk_pool_is_the_serving_render_over_its_frame_ends(monkeypatch):
    golden = np.load(FIXTURES)
    _, rate, semitones, channels, extras = next(c for c in material.CASES if c[0] == NAME)
    assert (extras["block_ms"], extras["interval_ms"]) == (200.0, 200.0)
    seed = int(golden[NAME + "__seed"])
    x = material.case_input(rate, channels)
    sr = material.SR
    n_out = int(material.SECONDS * sr)

    pool = StreamPool(capacity=1, channels=channels, engine="fidelity", block=8820,
                      interval=8820, max_track_sec=x.shape[1] / sr, hops_per_step=HOPS,
                      device="cpu")
    pool.load_track("s00", list(x))
    pool.start("s00", when=0.0, rate=rate, semitones=semitones)
    pool.states[0].rng[:] = seed
    ends, outs = [], []
    while HOPS * 8820 * len(outs) < n_out:
        ends.append(pool._packed()[0, :HOPS].astype(np.int32))
        _, streams = pool.step()
        outs.append(streams[0].numpy())
    ends = np.concatenate(ends)
    got = np.concatenate(outs, axis=-1)[..., :n_out]
    assert pool.minstd_steps == len(outs)

    case_ends = fidelity.hop_frame_ends(pool.scfg, len(ends), rate, sr)
    assert np.abs(ends - case_ends).max() == 1 and (ends == case_ends).mean() >= 0.8

    monkeypatch.setattr(fidelity, "hop_frame_ends", lambda cfg, n, *a, **k: ends[:n])
    want = fidelity.render_fidelity(
        x, sr, n_out, rate=float(np.float32(rate)), semitones=semitones,
        tonality_hz=material.TONALITY_HZ, block_ms=200.0, interval_ms=200.0, seed=seed,
        hops_per_chunk=HOPS, device="cpu")
    assert np.abs(got).max() > 1e-3
    np.testing.assert_array_equal(got, want)
