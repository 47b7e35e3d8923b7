"""The fidelity reference held to outside evidence: the blob's own renders
(``tests/golden/golden_v1.npz``, the WASM engine's output), driven hop by
hop with the worklet's frame ends, as the port's golden tests drive it.
The formant cases pass their formant controls and are compared over
their own seconds (``_compare_sec``: past it the detected f0 of any
reimplementation parts from the blob's)."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO / "tools"))
from golden_wasm import material  # noqa: E402

QUANTUM = 128   # the browser's render quantum


def _frame_ends(geo, n_hops: int, rate: float) -> np.ndarray:
    """The worklet's analysis frame ends: each hop sees the ring primed by
    the seek of the render quantum holding its output position, the
    quantum clock accumulated in float64 as the worklet keeps it."""
    sr = geo.sample_rate
    in_lat, out_lat = geo.block // 2 / sr, geo.out_lat / sr
    n_q = (n_hops * geo.interval) // QUANTUM + 1
    ends, t = np.empty(n_q, np.int64), 0.0
    for q in range(n_q):
        ends[q] = round(((t + out_lat) * rate + in_lat) * sr)
        t += QUANTUM / sr
    return ends[(np.arange(n_hops) * geo.interval) // QUANTUM]


def _render(name: str) -> float:
    from portbench.core import spec

    ref = spec.reference(REPO, "fidelity")
    golden = np.load(REPO / "tests" / "golden" / "golden_v1.npz")
    _, rate, semitones, channels, extras = next(c for c in material.CASES if c[0] == name)
    kw = material.case_render_kwargs(extras)
    sr = material.SR
    geo = ref.Geometry(channels, round(kw["block_ms"] / 1000 * sr),
                       round(kw["interval_ms"] / 1000 * sr), sr)
    n_out = int(extras.get("_compare_sec", material.SECONDS) * sr)
    n_hops = -(-n_out // geo.interval)
    seed = int(golden[name + "__seed"]) if name + "__seed" in golden.files else 1
    audio = torch.from_numpy(material.case_input(rate, channels))[None]
    state = ref.init_state(geo, 1, "cpu", seed)
    ends = torch.from_numpy(_frame_ends(geo, n_hops, rate))[None]
    one = lambda v: torch.tensor([float(v)], dtype=torch.float64)
    ctl = dict(rate=one(rate), semitones=one(semitones), tonality_hz=one(material.TONALITY_HZ),
               active=one(1.0),
               formant_factor=one(2.0 ** (extras.get("formant_semitones", 0.0) / 12.0)),
               formant_compensation=one(extras.get("formant_compensation", False)),
               formant_base=one(extras.get("formant_base_hz", 0.0) / sr))
    _, out = ref.step(geo, state, audio, ends, ctl)
    return material.snr_db(golden[name][..., :n_out], out[0].numpy()[..., :n_out],
                           material.case_skip(extras))


@pytest.mark.parametrize("name", ["r05_stp12", "stereo_r07_stp5", "r025_st0", "r20_stm12",
                                  "r10_fp7", "r10_fm5_base200", "r10_stp12_comp",
                                  "stereo_r07_stp5_f4_comp"])
def test_fidelity_reference_reaches_the_blob(name):
    snr = _render(name)
    assert snr > 40.0, f"{name}: {snr:.1f} dB"
