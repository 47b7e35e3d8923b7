"""PyTorch port against the blob driven through its live branch: the
coupled golden cases of ``tests/golden/golden_v1.npz`` through
``batched_live_fidelity_chunk``, input pushed 8 hops a chunk with carried
state, as tests/test_golden_wasm.py drives the JAX package.  Bound:
> 40 dB, skipping the latency ramp-in (one block and one interval).

``live_stp12`` runs in tier-1; the other five carry the ``slow`` marker.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

import torch

from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    batched_live_fidelity_chunk,
    init_batched_live_fidelity_state,
)

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
FIXTURES = pathlib.Path(__file__).parent / "golden" / "golden_v1.npz"
HOPS = 8


def live_snr(name: str, device: str = "cpu") -> float:
    """The coupled case ``name`` rendered by the port, in dB against the blob."""
    golden = np.load(FIXTURES)
    _, semitones, channels, extras = next(c for c in material.LIVE_CASES if c[0] == name)
    sr = material.SR
    ex = material.renderer_extras(extras)
    geom = material.case_render_kwargs(extras)
    use_formants = bool(ex.get("formant_semitones") or ex.get("formant_compensation"))
    cfg = SpectralConfig(channels, round(geom["block_ms"] / 1000 * sr),
                         round(geom["interval_ms"] / 1000 * sr), formants=use_formants,
                         split=bool(ex.get("split_computation", True)))
    n_out = int(material.SECONDS * sr)
    x = material.case_input(1.0, channels)[:, :n_out]
    one = lambda v: torch.tensor([v], dtype=torch.float32, device=device)
    mult = float(np.exp2(semitones / 12.0))
    controls = [one(mult), one((material.TONALITY_HZ / sr) / np.sqrt(mult)), one(1.0)]
    if use_formants:
        controls += [one(float(np.exp2(ex.get("formant_semitones", 0.0) / 12.0))),
                     one(1.0 if ex.get("formant_compensation") else 0.0),
                     one(ex.get("formant_base_hz", 0.0) / sr)]
    state = init_batched_live_fidelity_state(cfg, HOPS, 1, device)
    n = HOPS * cfg.interval
    emitted = []
    for c in range(-(-n_out // n)):
        chunk = np.zeros((1, channels, n), np.float32)
        lo, hi = c * n, min((c + 1) * n, n_out)
        chunk[0, :, : hi - lo] = x[:, lo:hi]
        state, emit = batched_live_fidelity_chunk(
            cfg, state, torch.from_numpy(chunk).to(device), *controls)
        emitted.append(emit[0].cpu().numpy())
    got = np.concatenate(emitted, axis=-1)[..., :n_out]
    end = int(extras.get("_compare_sec", material.SECONDS) * sr)
    return material.snr_db(golden[name][..., :end], got[..., :end],
                           material.case_skip(extras) + cfg.interval)


def test_golden_live_tier1():
    snr = live_snr("live_stp12")
    assert snr > 40.0, f"live_stp12: {snr:.1f} dB"


@pytest.mark.slow
@pytest.mark.parametrize("name", [c[0] for c in material.LIVE_CASES if c[0] != "live_stp12"])
def test_golden_live_rest(name):
    snr = live_snr(name)
    assert snr > 40.0, f"{name}: {snr:.1f} dB"
