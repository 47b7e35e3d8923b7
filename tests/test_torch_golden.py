"""PyTorch port against the blob: the golden renders of
``tests/golden/golden_v1.npz`` through the port's serving form
(``batched_fidelity_chunk`` chunk by chunk with carried state, as
tests/test_golden_wasm.py drives the JAX serving form).  Bound: > 40 dB,
the JAX package's own bar.

Tier-1 runs six cases, one per file so that no file runs long:
``r05_stp12`` here, the overlap-1 kiosk point in
test_torch_golden_kiosk.py, ``r025_st0`` (MINSTD carried across chunks)
in test_torch_golden_minstd.py, ``r10_stp12_splitoff`` in
test_torch_golden_splitoff.py, the formant case ``r10_fp7`` in
test_torch_golden_formant.py and the coupled case ``live_stp12`` in
test_torch_golden_live.py.  The other file-mode cases, formant ones
included, carry the ``slow`` marker here (about 35 s of CPU each), the
other coupled cases in test_torch_golden_live.py.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

import torch

from bauklank_tpu_torch.engine.fidelity import render_fidelity

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
FIXTURES = pathlib.Path(__file__).parent / "golden" / "golden_v1.npz"
TIER1 = ("r05_stp12", "kiosk_r0001_st0", "r025_st0", "r10_stp12_splitoff", "r10_fp7")


def golden_snr(name: str) -> float:
    """The case ``name`` rendered by the port, in dB against the blob."""
    golden = np.load(FIXTURES)
    _, rate, semitones, channels, extras = next(c for c in material.CASES if c[0] == name)
    seed_key = name + "__seed"
    got = render_fidelity(
        material.case_input(rate, channels), material.SR, int(material.SECONDS * material.SR),
        rate=rate, semitones=semitones, tonality_hz=material.TONALITY_HZ,
        seed=int(golden[seed_key]) if seed_key in golden.files else 1, device="cpu",
        **material.case_render_kwargs(extras))
    end = int(extras.get("_compare_sec", material.SECONDS) * material.SR)
    return material.snr_db(golden[name][..., :end], got[..., :end], material.case_skip(extras))


@pytest.mark.parametrize("name", ["r05_stp12"])
def test_golden_tier1(name):
    snr = golden_snr(name)
    assert snr > 40.0, f"{name}: {snr:.1f} dB"


SLOW_CASES = [c[0] for c in material.CASES if c[0] not in TIER1]


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_CASES)
def test_golden_rest(name):
    snr = golden_snr(name)
    assert snr > 40.0, f"{name}: {snr:.1f} dB"
