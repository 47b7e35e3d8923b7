"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
the work counts of the rooflines, and what the harness and the reference
import."""

from __future__ import annotations

import inspect
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "bauklank_tpu"}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_named_file_is_there_and_every_cell_reports_enough():
    from portbench.core import spec

    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.0 < m["bound"] <= 0.25
        assert spec.metric_path(REPO, m["name"]).exists()

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert all(reports(moved, c) for c in m["workloads"]), m["name"]
        assert spec.metric_path(REPO, m["name"]).exists()
    for name in cells:
        got = [e["name"] for e in BENCH["end_to_end"] if reports(e, name)]
        assert "setup_s" in got and len(got) >= 2, name
    for name, w in cells.items():
        assert w["chips"] == 1 and w["config"] in configs and len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "portbench" / "limits" / f"{name}.json").exists()
        assert any(name in m["workloads"] for m in BENCH["per_layer"])
    for c in configs.values():
        cfg = json.loads((REPO / c["file"]).read_text())
        assert (REPO / "portbench" / "reference" / f"{cfg['engine']}.py").exists()
        assert c["reduced"] == []


def test_every_configuration_pool_names_only_arguments_the_harness_hands_on():
    """A configuration file's ``pool`` names ``StreamPool`` parameters
    that the harness does not set from the cell."""
    from bauklank_tpu_torch.serve import StreamPool
    from portbench.core import cell

    params = set(inspect.signature(StreamPool).parameters)
    assert set(cell.HARNESS_SETS) <= params
    for c in BENCH["configs"]:
        pool = json.loads((REPO / c["file"]).read_text()).get("pool", {})
        assert isinstance(pool, dict), c["name"]
        assert set(pool) <= params - set(cell.HARNESS_SETS), c["name"]


class _Run:
    """What a roofline reads of a run."""

    def __init__(self, geo, voices, hops=1, semitones=None):
        self.geo, self.voices, self.hops = geo, voices, hops
        self.semitones = np.zeros(voices) if semitones is None else semitones


def _geo(engine, **kw):
    from portbench.core import spec

    cfg = json.loads((REPO / "portbench" / "configs" / f"{engine}-preset.json").read_text())
    cfg["geometry"].update(kw)
    return spec.reference(REPO, engine).geometry(cfg)


def test_band_chain_roofline_reproduces_the_recorded_bounds():
    """PERF.md's kernel table: the band chain's bound is its dependent
    chain, 0.1179 ms at the preset's 3072 bands and 0.1965 ms at the
    kiosk's 5120, whatever the stream count."""
    from portbench.core import spec

    mod = spec.roofline(REPO, "band_chain")
    preset = _geo("fidelity")
    kiosk = _geo("fidelity", block=9216, interval=8820)
    assert (preset.bands, kiosk.bands) == (3072, 5120)
    for voices in (64, 128):
        assert round(mod.least_seconds(_Run(preset, voices)) * 1e3, 4) == 0.1179
    assert round(mod.least_seconds(_Run(kiosk, 64)) * 1e3, 4) == 0.1965


@pytest.mark.parametrize("semitones", [0.0, 12.0, -12.0, "mixed"])
def test_banded_interp_roofline_matches_the_kernel_table_arithmetic(semitones):
    """The bytes of ``chip_smoke.py``'s bound (each tap the positions
    address read once, the positions, the output written once) for the
    fast step's call, [128, 128, 2688, 2] at H = 32, on the positions of
    each voice's transpose."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from portbench.core import spec

    mod = spec.roofline(REPO, "banded_interp")
    geo = _geo("fast")
    voices, hops = 128, 32
    st = (np.linspace(-12, 12, voices) if semitones == "mixed"
          else np.full(voices, semitones))
    f_out = (np.arange(geo.bins) + 0.5) / geo.block
    pos = []
    for s in st:
        tf = 2.0 ** (s / 12.0)
        limit = 8000.0 / geo.sample_rate / np.sqrt(tf)
        f_in = np.where(f_out <= limit * tf, f_out / tf, f_out - limit * (tf - 1.0))
        pos.append(f_in * geo.block - 0.5)
    pos = torch.tensor(np.array(pos), dtype=torch.float64)
    x = torch.zeros((voices, 2 * hops * geo.channels, geo.bins, 2))
    want = chip_smoke.bound("banded_interp_complex", (x, pos, 768))[0]
    got = mod.least_seconds(_Run(geo, voices, hops, st)) * 1e3
    assert got == pytest.approx(want, rel=1e-9)


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax_in_a_fresh_process():
    """Everything a run imports, in a process of its own: the harness, the
    program's pool, every reference, metric reader and roofline."""
    code = (
        "import sys, pathlib; sys.path.insert(0, '.')\n"
        "from portbench.core import cell, check, spec, synth, trace, traffic\n"
        "from bauklank_tpu_torch.serve import StreamPool\n"
        "from bauklank_tpu_torch.engine.config import StretchConfig\n"
        "root = pathlib.Path('.')\n"
        "for p in sorted((root / 'portbench').glob('*/*.py')):\n"
        "    if p.parent.name in ('reference', 'metrics', 'roofline'):\n"
        "        spec.load_module(p, p.parent.name)\n")
    loaded = _loaded_after(code)
    assert "bauklank_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, pathlib; sys.path.insert(0, '.')\n"
        "from portbench.core import spec\n"
        "for p in sorted(pathlib.Path('portbench/reference').glob('*.py')):\n"
        "    spec.load_module(p, 'reference')\n")
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"bauklank_tpu_torch"})
    for p in (REPO / "portbench" / "reference").glob("*.py"):
        assert "bauklank" not in "".join(
            line for line in p.read_text().splitlines() if "import" in line), p
