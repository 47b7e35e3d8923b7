"""A cell of ``BENCHMARK.json``, with the files it names.

Nothing here knows a cell, configuration, traffic mix or metric by name:
each is found from ``BENCHMARK.json`` and the files under ``portbench/``.

A configuration file (``portbench/configs/<name>.json``) states one
deployment: its ``engine``, ``sample_rate``, ``channels`` and
``max_track_sec``; the ``geometry`` that the reference is built from and
that the program's pool has to run; and, where the deployment's source
sets more than the harness does, ``pool``, an object of further keyword
arguments of the program's ``StreamPool`` (numbers, strings, booleans),
handed to it as stated (``core/cell.py:pool_arguments``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``: its configuration
    file, its traffic mix (``portbench/traffic/<traffic>.json``), its
    limits (``portbench/limits/<cell>.json``) and the metrics it reports."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"error: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _load_json(root / cfg_entry["file"])
    traffic = _load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "portbench" / "limits" / f"{workload}.json")

    def reports(m):
        return workload in m.get("workloads", [workload])

    return Cell(root, workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m)],
                [m for m in bench["per_layer"] if reports(m)])


def load_module(path: pathlib.Path, tag: str):
    """Import the file ``path`` as a module of its own (file names may
    hold dots, as metric names do)."""
    name = "portbench_" + tag + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"error: {path} not found")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(root: pathlib.Path, engine: str):
    """The plain reference of an engine: ``portbench/reference/<engine>.py``."""
    return load_module(root / "portbench" / "reference" / f"{engine}.py", "reference")


def metric_path(root: pathlib.Path, name: str) -> pathlib.Path:
    """A metric's reader: ``portbench/metrics/<name>.py``, else the reader
    of its family, the name up to its first dot (``pack_ms.batch`` and
    ``pack_ms.hop`` read the same quantity in different cells)."""
    metrics = root / "portbench" / "metrics"
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def metric_reader(root: pathlib.Path, name: str):
    return load_module(metric_path(root, name), "metric")


def roofline(root: pathlib.Path, kernel: str):
    """A kernel's work count: ``portbench/roofline/<kernel>.py``."""
    return load_module(root / "portbench" / "roofline" / f"{kernel}.py", "roofline")
