"""The port's CUDA kernels on the card, against their plain versions at
small shapes (bit-equal).  Marked ``cuda``: each test skips unless a CUDA
device and ``nvcc`` are present, so they run only on a machine with the
card.  The proof at the main path's shapes is ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import pytest

import torch

from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref
from bauklank_tpu_torch.kernels.interp import banded_interp, banded_interp_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


def test_frames_windowed(dev):
    rng = np.random.default_rng(0)
    audio = _t(rng.standard_normal((3, 2, 9000)).astype(np.float32), dev)
    starts = _t(np.array([[-600, 0, 131, 8900], [5, 77, 4000, -10000],
                          [1, 2, 3, 8999]], np.int32), dev)
    win = _t(rng.uniform(0.1, 1, 5292).astype(np.float32), dev)
    got = _launched("frames_windowed", lambda: frames_windowed(audio, starts, win))
    assert torch.equal(got, frames_windowed_ref(audio, starts, win))


def test_comp_cumsum(dev):
    x = _t(np.random.default_rng(1).standard_normal((3, 700, 300)).astype(np.float32), dev)
    hi, lo = _launched("comp_cumsum", lambda: comp_cumsum(x))
    rhi, rlo = comp_cumsum_ref(x)
    assert torch.equal(hi, rhi) and torch.equal(lo, rlo)


def test_frac_gather(dev):
    rng = np.random.default_rng(2)
    planes = _t(rng.standard_normal((5, 192, 6)).astype(np.float32), dev)
    pos = rng.uniform(-3, 195, (5, 500)).astype(np.float32)
    pos[:, :6] = [-0.5, -1.0, 191.0, 191.5, 192.0, 7.0]
    pos = _t(pos, dev)
    got = _launched("frac_gather", lambda: frac_gather(planes, pos))
    assert torch.equal(got, frac_gather_ref(planes, pos))


@pytest.mark.parametrize("long_step", [5, 1])
def test_band_chain(dev, long_step):
    rng = np.random.default_rng(long_step)
    lead = rng.standard_normal((9, 300, 40)).astype(np.float32)
    lead[8] = np.abs(lead[8])
    lead[:6, 7] = 0.0                               # EPS fallback to pi
    chan = rng.standard_normal((2, 6, 300, 40)).astype(np.float32)
    mc = rng.integers(0, 2, (300, 40))
    chan[0, 0], chan[1, 0] = mc == 0, mc == 1
    chan[:, 3] = np.abs(chan[:, 3])
    lead_t, chan_t = _t(lead, dev), _t(chan, dev)
    got = _launched("band_chain", lambda: band_chain(lead_t, chan_t, long_step))
    assert torch.equal(got, band_chain_ref(lead_t, chan_t, long_step))


@pytest.mark.parametrize("window", [256, 768])
def test_banded_interp(dev, window):
    """Monotone positions running out of range at both ends, plus a steep
    stretch whose tiles span more than the window (dropped taps)."""
    rng = np.random.default_rng(window)
    x = _t(rng.standard_normal((3, 8, 1024)).astype(np.float32), dev)
    pos = np.sort(rng.uniform(-4, 1028, (3, 512)), axis=1)
    pos[2] = -2.0 + 1032.0 * np.linspace(0.0, 1.0, 512) ** 3   # last tile spans ~700 bands
    pos = _t(pos.astype(np.float32), dev)
    got = _launched("banded_interp", lambda: banded_interp(x, pos, window))
    assert torch.equal(got, banded_interp_ref(x, pos, window))


def test_wrappers_refuse_mixed_devices(dev):
    with pytest.raises(ValueError, match="devices"):
        frac_gather(torch.zeros(2, 8, 4, device=dev), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="contiguous"):
        comp_cumsum(torch.zeros(3, 8, 4, device=dev).transpose(1, 2))
