"""The kiosk's overlap-1 geometry through the harness, at a tiny size on
the CPU: a cell whose configuration hands the pool a raw block and
interval (``"pool": {"block": 1600, "interval": 1600}`` at 8 kHz: FFT
2048, 1024 bands, ``long_step`` 1, the block off the FFT grid), every
voice in the MINSTD regime, comes out ``correct`` against the float64
reference; a planted fault does not; a traced run reads the
``fidelity.minstd`` range and the cell's host ranges."""

from __future__ import annotations

import functools
import json

import pytest

from conftest import SECONDS, run_tiny
from portbench.core.faults import plant

GEOMETRY = {"block": 1600, "interval": 1600, "fft": 2048, "bands": 1024, "long_step": 1,
            "split_computation": True}


def _kiosk_root(tiny_root):
    """The tiny fidelity cell at the kiosk's shape: overlap 1, raw sizes
    handed to the pool, rates 0.001-0.01, +-24 semitones, two hops a step;
    the kiosk cell's per-layer metrics listed for it."""
    root = tiny_root("fidelity", pool={"block": 1600, "interval": 1600})
    path = root / "portbench" / "configs" / "tiny-fidelity.json"
    cfg = json.loads(path.read_text())
    cfg["geometry"] = GEOMETRY
    path.write_text(json.dumps(cfg))
    path = root / "portbench" / "traffic" / "tiny-mix.json"
    mix = json.loads(path.read_text())
    mix["initial"]["rate"] = {"dist": "loguniform", "lo": 0.001, "hi": 0.01}
    mix["initial"]["semitones"] = {"dist": "uniform", "lo": -24.0, "hi": 24.0}
    mix["turn_every_s"] = 0.5
    path.write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"].endswith(".kiosk"):
            m["workloads"].append("tiny.fidelity")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_overlap_one_cell_with_raw_sizes_runs_correct(tiny_root):
    root = _kiosk_root(tiny_root)
    result, nums = run_tiny(root, "fidelity", 2**35 + 3, SECONDS["fidelity"])
    assert result["failed"] == 0 and result["attempted"] > 3
    assert result["correct"], result["checks"]
    assert nums["missing_steps"] == 0 and nums["state_rng"] == 0


def test_overlap_one_cell_reads_the_minstd_range_when_traced(tiny_root, monkeypatch):
    """Every traced step is outside the deterministic regime, so
    ``fidelity.minstd`` opens each step; on the CPU there is no device
    time to read, and that metric is left out of the line."""
    from bauklank_tpu_torch.serve import StreamPool

    built, init = [], StreamPool.__init__

    @functools.wraps(init)       # the harness reads the signature through it
    def recording(self, *args, **kwargs):
        built.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(StreamPool, "__init__", recording)
    root = _kiosk_root(tiny_root)
    result, _ = run_tiny(root, "fidelity", 13, 1.5 * SECONDS["fidelity"], trace=True)
    assert result["correct"], result["checks"]
    for name in ("minstd_host_ms", "fidelity_host_ms", "step_host_ms", "pack_ms"):
        assert result["metrics"][f"{name}.kiosk"]["value"] > 0.0, name
    assert "minstd_device_ms.kiosk" not in result["metrics"]
    assert "band_chain_roofline.kiosk" not in result["metrics"]
    pool, = built
    assert pool.scfg.block == pool.scfg.interval == 1600 and pool.scfg.long_step == 1


@pytest.mark.parametrize("fault", ["altered_answer", "silent_voice"])
def test_overlap_one_cell_with_a_fault_comes_out_not_correct(tiny_root, fault):
    undo = plant(fault, "fidelity")
    try:
        root = _kiosk_root(tiny_root)
        result, nums = run_tiny(root, "fidelity", 29, SECONDS["fidelity"])
    finally:
        undo()
    assert not result["correct"], nums
