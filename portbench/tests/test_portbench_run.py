"""The harness's run on the CPU at a tiny size: the loop and the reference
agree, the control and every fault the cells can have come out not
correct, a cell added as files only is found and run, and the entry
point refuses to run without a card."""

from __future__ import annotations

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


def test_traffic_is_the_same_for_a_seed_and_drawn_in_output_time():
    from portbench.core.traffic import Traffic

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
