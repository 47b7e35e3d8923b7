"""The harness's run on the CPU at a tiny size: the loop and the reference
agree, the control and every fault the cells can have come out not
correct, a cell added as files only is found and run, and the entry
point refuses to run without a card."""

from __future__ import annotations

import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, SECONDS, TINY_LIMITS, run_tiny
from portbench.core.faults import FAULTS, plant

ENGINES = ["fast", "fidelity"]


@pytest.mark.parametrize("engine", ENGINES)
def test_loop_and_reference_agree_at_a_tiny_size(tiny_root, engine):
    root = tiny_root(engine)
    result, nums = run_tiny(root, engine, 2**33 + 17, SECONDS[engine])
    assert result["failed"] == 0 and result["attempted"] > 3
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"rtf", "step_p95_ms", "setup_s"}
    assert nums["missing_steps"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_traced_run_reports_its_per_layer_metrics(tiny_root, engine):
    """A traced run on the CPU: the host ranges are read (no device
    metric has anything to read there), and ``correct`` means the same."""
    root = tiny_root(engine, hops=1)       # the profiler slows the CPU's steps
    result, _ = run_tiny(root, engine, 5, 1.5 * SECONDS[engine], trace=True)
    assert result["correct"], result["checks"]
    assert "pack_ms.batch" in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("engine", ENGINES)
def test_control_comes_out_not_correct(tiny_root, engine):
    """The reference computed in bfloat16, put in the program's place."""
    from portbench.core import check

    root = tiny_root(engine)
    result, nums = run_tiny(root, engine, 99, SECONDS[engine], control=True)
    assert check.within(nums, TINY_LIMITS[engine])
    assert not check.within(result["control"], TINY_LIMITS[engine]), result["control"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("engine", ENGINES)
def test_faults_come_out_not_correct(tiny_root, engine, fault):
    undo = plant(fault, engine)
    try:
        root = tiny_root(engine)
        result, nums = run_tiny(root, engine, 7, SECONDS[engine])
    finally:
        undo()
    assert not result["correct"], nums


def test_cell_added_as_files_only_is_found_and_run(tiny_root):
    """A new configuration, traffic mix, limits file and per-layer metric,
    as files and entries only, run through the unchanged harness."""
    root = tiny_root("fast")
    (root / "portbench" / "metrics" / "bench_set_ms.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else run.trace.host_ms('bench.set')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="bench_set_ms", unit="ms", better="lower",
                                   source="program_span", layer="harness", moves="rtf",
                                   workloads=["tiny.fast"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run_tiny(root, "fast", 3, SECONDS["fast"], trace=True)
    assert result["correct"]
    assert result["metrics"]["bench_set_ms"]["value"] >= 0.0


class _NotBuilt(Exception):
    pass


def _record_pool(monkeypatch, build: bool = True) -> list:
    """The (positional, keyword) arguments of every ``StreamPool`` built
    from here on; without ``build`` the first one raises ``_NotBuilt``
    once its arguments are recorded."""
    from bauklank_tpu_torch.serve import StreamPool

    calls, init = [], StreamPool.__init__

    @functools.wraps(init)       # the harness reads the signature through it
    def recording(self, *args, **kwargs):
        calls.append((args, kwargs))
        if not build:
            raise _NotBuilt
        init(self, *args, **kwargs)

    monkeypatch.setattr(StreamPool, "__init__", recording)
    return calls


def test_configuration_pool_arguments_reach_the_program(tiny_root, monkeypatch):
    calls = _record_pool(monkeypatch)
    root = tiny_root("fidelity", pool={"max_rate": 4.0})
    result, _ = run_tiny(root, "fidelity", 2**32 + 9, SECONDS["fidelity"])
    assert result["correct"], result["checks"]
    assert len(calls) == 1 and calls[0][0] == ()
    assert calls[0][1]["max_rate"] == 4.0


@pytest.mark.parametrize("pool, said", [
    ({"channels": 1}, "'channels', which the harness sets from the cell"),
    ({"portbench_no_such_argument": 1},
     "'portbench_no_such_argument', which StreamPool lacks; its parameters are ["),
    ({"config": {"block": 8820}}, "'config' the value {'block': 8820}, not a number"),
], ids=["set_by_the_harness", "not_a_parameter", "not_a_scalar"])
def test_pool_argument_that_cannot_be_handed_on_is_refused_before_the_pool(
        tiny_root, monkeypatch, capsys, pool, said):
    """Refused with the key named, before ``StreamPool`` is called (so
    before any step), and with nothing on standard output."""
    calls = _record_pool(monkeypatch)
    root = tiny_root("fast", pool=pool)
    with pytest.raises(SystemExit) as refused:
        run_tiny(root, "fast", 11, SECONDS["fast"])
    assert said in str(refused.value)
    assert calls == []
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("config", ["fidelity-preset", "fast-preset"])
def test_accepted_configurations_build_the_pool_from_the_cell_alone(monkeypatch, config):
    """A configuration file without ``pool`` gives the harness's eight
    arguments, as keywords, and nothing more."""
    from portbench.core import cell, spec

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = next(w["name"] for w in bench["workloads"] if w["config"] == config)
    c = spec.load_cell(REPO, name)
    assert "pool" not in c.config
    calls = _record_pool(monkeypatch, build=False)
    with pytest.raises(_NotBuilt):
        cell._Pool(c, 5, "cpu")
    (args, kwargs), = calls
    voices = int(c.traffic["voices"])
    assert args == () and kwargs == dict(
        capacity=voices, sample_rate=float(c.config["sample_rate"]),
        channels=int(c.config["channels"]), max_track_sec=c.config["max_track_sec"],
        names=[f"v{i:03d}" for i in range(voices)],
        hops_per_step=int(c.traffic["hops_per_step"]), engine=c.config["engine"],
        device="cpu")
    assert set(kwargs) == set(cell.HARNESS_SETS)


def _bare_run(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script, "--workload", "fidelity-preset.s128h8",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _bare_run(REPO, "portbench/run.py")
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "error" in res.stderr


def test_run_in_a_directory_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _bare_run(tmp_path, "portbench/run.py")
    assert res.returncode != 0
    assert res.stdout.strip() == ""


# sha256 of repr((initial, turns of steps 1-64)) of each accepted mix at the
# seed 2**40 + 3, each at its first cell's step length, as the harness drew
# them before the choice distribution was added
ACCEPTED_TRAFFIC = {
    "s128h8": "ac9b7b5e45f934a85b2e848097a63f2203e65442d07a35c179d388dcf742c99c",
    "s128h32": "fc848e31c9df9c228761424b4f28a81865ad4acf3a72c280c8138ad1f040adfa",
    "s64h1": "b1861d65de82e06c18fa8a346b5fd80cf250b45bd00be62a8913764a3ce39c13",
    "s64h4": "66aaccff1674c1e34f6496ed22869fee664e465414ba788270d42b941f35b175",
}


def test_traffic_is_the_same_for_a_seed_and_drawn_in_output_time():
    from portbench.core.traffic import Traffic

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    sums = {}
    for w in bench["workloads"]:
        if w["traffic"] in ACCEPTED_TRAFFIC and w["traffic"] not in sums:
            cfg = json.loads((REPO / files[w["config"]]).read_text())
            mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json")
                             .read_text())
            t = Traffic(mix, 2**40 + 3, mix["hops_per_step"] * cfg["geometry"]["interval"]
                        / cfg["sample_rate"], float(mix["track_sec"]))
            drawn = repr((t.initial, [t.turns(k) for k in range(1, 65)]))
            sums[w["traffic"]] = hashlib.sha256(drawn.encode()).hexdigest()
    assert sums == ACCEPTED_TRAFFIC

    mix = json.loads((REPO / "portbench" / "traffic" / "s128h8.json").read_text())
    a = Traffic(mix, 2**40 + 3, 0.24, 30.0)
    b = Traffic(mix, 2**40 + 3, 0.24, 30.0)
    assert a.initial == b.initial
    turns = [a.turns(k) for k in range(1, 500)]
    assert turns == [b.turns(k) for k in range(1, 500)]
    n = sum(len(t) for t in turns)
    # one turn a voice every 2 s of output, over 499 steps of 0.24 s
    expect = 128 * 499 * 0.24 / 2.0
    assert abs(n - expect) < 5 * np.sqrt(expect)
    rates = [v for t in turns for _, key, v in t if key == "rate"]
    assert min(rates) >= 0.5 and max(rates) <= 2.0


@pytest.mark.cuda
def test_every_cell_runs_correct_on_the_card():
    """Each cell of BENCHMARK.json once, briefly, through the entry point."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        res = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                              "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["correct"], (w["name"], line["checks"])


def test_run_with_jax_loaded_exits_without_a_result(tmp_path):
    """A run whose process holds JAX once the window has closed fails and
    names it, printing no result."""
    code = (
        "import sys, pathlib, time\n"
        f"sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})\n"
        "import jax  # noqa: F401\n"
        "from conftest import make_root\n"
        "from portbench.core import cell, spec\n"
        f"root = make_root(pathlib.Path({str(tmp_path)!r}), 'fast')\n"
        "c = spec.load_cell(root, 'tiny.fast')\n"
        "result, _ = cell.run(c, 1, 1.0, False, time.perf_counter(), device='cpu')\n"
        "cell.emit(result)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "jax" in res.stderr.splitlines()[-1]
