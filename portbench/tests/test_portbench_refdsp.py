"""The fast reference held to the JAX package's executable specification,
``bauklank_tpu.refdsp.render_offline`` (a float64 per-hop NumPy loop), at
constant rate.  This file imports the JAX package on purpose; it runs on
the CPU only and is never run on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bauklank_tpu.engine.config import StretchConfig
from bauklank_tpu.refdsp import render_offline
from conftest import REPO

SR = 8000.0


def _snr(want, got):
    return 10.0 * np.log10(np.sum(want ** 2) / max(np.sum((want - got) ** 2), 1e-300))


@pytest.mark.parametrize("rate,semitones", [(1.0, 0.0), (0.5, 7.0), (1.7, -12.0)])
def test_fast_reference_matches_refdsp(rate, semitones):
    from portbench.core import spec

    ref = spec.reference(REPO, "fast")
    config = StretchConfig(channels=2, block=1024, interval=256, formants=False)
    geo = ref.Geometry(2, config.block, config.interval, SR)
    rng = np.random.default_rng(3)
    t = np.arange(int(3 * SR)) / SR
    audio = np.stack([np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(t.size),
                      np.sin(2 * np.pi * 331.0 * t + 0.5)]).astype(np.float32)
    hops, chunk = 40, 8
    n_out = hops * config.interval
    want = render_offline(audio, rate, config, n_out, transpose_factor=2.0 ** (semitones / 12),
                          tonality=8000.0 / SR)
    # refdsp's frame ends: round(in_start + (h I + B / 2) rate) + B // 2
    h = np.arange(hops)
    ends = (np.round((h * config.interval + config.block / 2.0) * rate).astype(np.int64)
            + config.block // 2)
    one = lambda v: torch.full((1,), float(v), dtype=torch.float64)
    ctl = dict(rate=one(rate), semitones=one(semitones), tonality_hz=one(8000.0),
               active=one(1.0))
    state, outs = ref.init_state(geo, 1, "cpu"), []
    for c in range(0, hops, chunk):
        state, out = ref.step(geo, state, torch.from_numpy(audio)[None],
                              torch.from_numpy(ends[c:c + chunk])[None], ctl)
        outs.append(out[0].numpy())
    got = np.concatenate(outs, axis=-1)
    assert _snr(want[..., config.block:], got[..., config.block:n_out]) > 100.0
