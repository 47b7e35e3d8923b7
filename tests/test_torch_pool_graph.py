"""The fidelity pool step as stages (``serve/graphs.py``'s unit of
capture), on the CPU.

On the card a fidelity pool captures its step stage by stage as CUDA
graphs and replays them; the card tests (``test_torch_pool_graph_cuda.py``)
hold the replays to the eager step bit for bit.  Here, on the CPU, where
no graph is captured:

- a pool's step (``serve.pool._pool_step_fidelity``, staged) is
  ``batched_fidelity_chunk`` and the mixdown, and
  ``engine.fidelity.fidelity_stages`` composed is
  ``batched_fidelity_chunk``, bit for bit, at the preset and the kiosk's
  raw geometry, in both regimes and with a formant voice;
- the stages come in step order under the ranges of the eager step;
- a CPU pool steps as before and counts no graph in ``metrics()``;
- ``utils.metrics.tables_read``, with which a capture holds the constant
  tables its graphs read, lists each table this thread reads.
"""

from __future__ import annotations

import threading

import pytest
import torch

from bauklank_tpu_torch.engine.drive import fidelity_operands, unpack
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    _consts,
    batched_fidelity_chunk,
    fidelity_stages,
)
from bauklank_tpu_torch.serve import pool as pool_mod
from bauklank_tpu_torch.serve.pool import StreamPool, _issue_fidelity, _mixdown
from bauklank_tpu_torch.utils.metrics import tables_read
from bauklank_tpu_torch.utils.tree import keyed_leaves
from tests.util import tone

torch.set_num_threads(1)
SR = 44100.0

# (geometry, rates, formant semitones of voice 1): the preset in the
# deterministic regime, the preset with a slow voice (MINSTD) and a
# formant voice, the kiosk's raw 8820/8820 (every voice MINSTD)
CASES = {
    "preset": ({}, (0.6, 1.5), 0.0),
    "preset-minstd-formant": ({}, (0.2, 1.5), 5.0),
    "kiosk": (dict(block=8820, interval=8820), (0.001, 0.004), 0.0),
}
# a small geometry, where only the stages' order matters
SMALL = (dict(block=1024, interval=256), (0.6, 1.5), 0.0)


def _pool(geometry, rates, formant):
    pool = StreamPool(capacity=2, hops_per_step=1, engine="fidelity", max_track_sec=1.5,
                      device="cpu", **geometry)
    for i, name in enumerate(("s00", "s01")):
        x = tone(330.0 + 110 * i, int(1.5 * SR), SR)
        pool.load_track(name, [x, 0.5 * x])
        pool.start(name, when=0.0, offset=0.0, rate=rates[i], semitones=4.0 - 7.0 * i)
    if formant:
        pool.apply_set("s01", "formantSemitones", formant, lookahead=0.0)
    return pool


def _steps(pool, n, monkeypatch):
    """``n`` steps of ``pool``, each as ((scfg, states, audios, packed,
    regime), (states, master, streams)): what the pool handed
    ``_pool_step_fidelity``, with its own packing, regime and formant
    gate, and what it got back."""
    seen = []
    step = pool_mod._pool_step_fidelity

    def recorded(*args):
        seen.append((args, step(*args)))
        return seen[-1][1]

    with monkeypatch.context() as m:
        m.setattr(pool_mod, "_pool_step_fidelity", recorded)
        for _ in range(n):
            pool.step()
    return seen


def _equal(a, b) -> None:
    for (name, x), (_, y) in zip(keyed_leaves(a), keyed_leaves(b)):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_pool_step_is_the_chunk_and_mixdown(case, monkeypatch):
    """Two steps of a pool: each is ``batched_fidelity_chunk`` on the
    step's operands, then the mixdown."""
    regimes = set()
    for (scfg, states, audios, packed, det), (got_states, master, streams) in _steps(
            _pool(*CASES[case]), 2, monkeypatch):
        regimes.add(det)
        want_states, want_emit = batched_fidelity_chunk(
            scfg, states, audios, *fidelity_operands(scfg, packed), deterministic=det)
        assert torch.equal(streams, want_emit)
        _, _, gains, pans = unpack(packed)
        assert torch.equal(master, _mixdown(want_emit, gains, pans))
        _equal(got_states, want_states)
    assert regimes == {"preset": {True}}.get(case, {False})
    assert float(master.abs().max()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_composed_are_the_chunk(case, monkeypatch):
    pool = _pool(*CASES[case])
    (scfg, states, audios, packed, det), _ = _steps(pool, 1, monkeypatch)[0]
    args = fidelity_operands(scfg, packed)
    want_states, want_emit = batched_fidelity_chunk(scfg, states, audios, *args,
                                                    deterministic=det)
    v, stages = fidelity_stages(scfg, states, audios, *args, deterministic=det)
    for _, stage in stages:
        stage()
    assert torch.equal(v["emit"], want_emit)
    _equal(v["states"], want_states)


@pytest.mark.parametrize("deterministic", [True, False])
def test_stages_run_in_step_order_under_the_eager_ranges(deterministic, monkeypatch):
    pool = _pool(*SMALL)
    (scfg, states, audios, packed, _), _ = _steps(pool, 1, monkeypatch)[0]
    names = []
    _issue_fidelity(scfg, states, audios, packed, deterministic,
                    lambda name, stage: (names.append(name), stage()))
    second = "fidelity.chain_inputs" if deterministic else "fidelity.minstd"
    assert names == [None, "fidelity.analyse", second, "fidelity.chain_inputs",
                     "fidelity.hop_loop", "fidelity.synthesis", "fidelity.carry", None]


@pytest.mark.parametrize("engine", ["fidelity", "fast"])
def test_a_cpu_pool_counts_no_graph(engine):
    pool = StreamPool(capacity=2, hops_per_step=2, engine=engine, max_track_sec=1.0,
                      device="cpu", block=1024, interval=256)
    x = tone(440.0, int(SR), SR)
    pool.load_track("s00", [x, x])
    pool.start("s00", rate=0.7)
    for _ in range(3):
        pool.step(fetch=True)
    m = pool.metrics()
    assert m["steps"] == 3
    assert (m["graph_captures"], m["graph_replays"]) == (0, 0)
    assert pool._graphs is None


def test_tables_read_lists_each_table_read_built_or_cached():
    cfg = SpectralConfig(2, 1000, 250)
    _consts.cache_clear()
    with tables_read([]) as held:
        built = _consts(cfg, torch.device("cpu"))
        cached = _consts(cfg, torch.device("cpu"))
    assert cached is built
    assert sum(t is built for t in held) == 2      # besides the tables it builds from
    n = len(held)
    _consts(cfg, torch.device("cpu"))
    assert len(held) == n


def test_tables_read_lists_this_threads_reads_only():
    cfg = SpectralConfig(2, 1000, 250)
    other = threading.Thread(target=_consts, args=(cfg, torch.device("cpu")))
    with tables_read([]) as held:
        other.start()
        other.join()
    assert held == []
