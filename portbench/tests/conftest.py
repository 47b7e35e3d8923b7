"""Tiny cells of the benchmark for the CPU tests.

A tiny cell is the benchmark's own configuration files cut to 8 kHz, a
few voices and short tracks, written as new files into a copy of the
benchmark under a temporary root, with its own entries in that root's
``BENCHMARK.json``: the way a later change adds a cell.  It runs through
the harness's whole run with ``device="cpu"`` (the program's plain
versions of its kernels, the reference on the CPU).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

# the limits of the tiny cells, from eight seeds on the CPU: the program
# read at most 1.8e-5 / 1.1e-5 / 1.1e-5 / 1.5e-4 / 7.3e-5 (fast: the
# worst stream, all streams, master, state spectrum, tail) and 7.5e-4 /
# 4.5e-4 / 7.4e-4 / 4.5e-4 / 4.5e-4 (fidelity); the bfloat16 control at
# least 3.5e-3 / 3.3e-3 / 3.7e-3 / 4.7e-3 / 4.1e-3 and 0.72 / 0.47 / 0.40 /
# 0.38 / 0.36
TINY_LIMITS = {
    "fast": {"stream_err": 2e-4, "stream_all": 2e-4, "master_err": 2e-4,
             "state_spectrum": 1e-3, "state_tail": 1e-3},
    "fidelity": {"stream_err": 1e-2, "stream_all": 1e-2, "master_err": 1e-2,
                 "state_spectrum": 1e-2, "state_tail": 1e-2, "state_rng": 0.0},
}


def make_root(tmp: pathlib.Path, engine: str, hops: int = 2, rate_lo: float = 0.5,
              voices: int = 3, pool: dict | None = None) -> pathlib.Path:
    """A copy of the benchmark under ``tmp`` with one tiny cell added as
    new files and new entries: ``tiny.<engine>`` of configuration
    ``tiny-<engine>`` (with ``pool`` as its ``pool``, if given) and
    traffic ``tiny-mix``."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench" / "configs" / f"{engine}-preset.json").read_text())
    cfg.update(name=f"tiny-{engine}", sample_rate=8000, max_track_sec=4)
    cfg["geometry"] = ({"block": 960, "interval": 240, "split_computation": True}
                       if engine == "fidelity" else
                       {"block": 1024, "interval": 240, "split_computation": True})
    if pool is not None:
        cfg["pool"] = pool
    (root / "portbench" / "configs" / f"tiny-{engine}.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "portbench" / "traffic" / "s64h1.json").read_text())
    mix.update(voices=voices, hops_per_step=hops, track_sec=4, warmup_steps=2,
               trace_min_steps=3, trace_seconds=0.1, turn_every_s=0.3,
               loop={"start_s": 0.3, "end_margin_s": 0.5})
    mix["initial"]["rate"]["lo"] = rate_lo
    (root / "portbench" / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / f"tiny.{engine}.json").write_text(
        json.dumps(TINY_LIMITS[engine]))
    bench["configs"].append(dict(name=f"tiny-{engine}", source="test",
                                 file=f"portbench/configs/tiny-{engine}.json", reduced=[],
                                 why="test"))
    bench["workloads"].append(dict(name=f"tiny.{engine}", config=f"tiny-{engine}",
                                   traffic="tiny-mix", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("rtf", "pack_ms.batch", "device_idle_pct.batch") and "workloads" in m:
            m["workloads"].append(f"tiny.{engine}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: pathlib.Path, engine: str, seed: int, seconds: float, trace: bool = False,
             control: bool = False):
    """(result, compared numbers) of one CPU run of the tiny cell."""
    from portbench.core import cell, spec

    c = spec.load_cell(root, f"tiny.{engine}")
    # the look for JAX is held in a fresh process (test_portbench_layout.py):
    # this one may hold it for test_portbench_refdsp.py
    return cell.run(c, seed, seconds, trace, time.perf_counter(), device="cpu",
                    control=control, forbidden=())


@pytest.fixture
def tiny_root(tmp_path):
    return lambda engine, **kw: make_root(tmp_path, engine, **kw)


# the window of a tiny run on the CPU, long enough for the compared steps
SECONDS = {"fast": 1.5, "fidelity": 4.0}
