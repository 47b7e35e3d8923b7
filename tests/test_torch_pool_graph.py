"""The pool step as stages (``serve/graphs.py``'s unit of capture), of
both engines, on the CPU.

On the card a pool captures its step stage by stage as CUDA graphs and
replays them; the card tests (``test_torch_pool_graph_cuda.py``) hold
the replays to the eager step bit for bit.  Here, on the CPU, where no
graph is captured:

- a pool's step (``serve.pool._pool_step`` / ``_pool_step_fidelity``,
  staged) is the engine's chunk and the mixdown, bit for bit, and so is
  ``_issue_fast`` / ``_issue_fidelity`` run eagerly on the same operands;
  the fidelity engine at the preset and the kiosk's raw geometry, in both
  regimes and with a formant voice, the fast engine at 1 and 3 hops a
  step, with a formant voice and without;
- ``engine.fidelity.fidelity_stages`` composed is
  ``batched_fidelity_chunk``, and ``engine.core.fast_stages`` composed is
  ``process_chunk`` and the public stage functions (``hop_factors``,
  ``rotation_scan``, ``synthesis``) composed as the chunk composed them
  before it was staged, bit for bit;
- the stages come in step order under the ranges of the eager step;
- a CPU pool steps as before and counts no graph in ``metrics()``;
- ``utils.metrics.tables_read``, with which a capture holds the constant
  tables its graphs read, lists each table this thread reads.
"""

from __future__ import annotations

import threading

import pytest
import torch

from bauklank_tpu_torch.engine.core import (
    StretchState,
    fast_stages,
    hop_factors,
    process_chunk,
    rotation_scan,
    synthesis,
)
from bauklank_tpu_torch.engine.drive import fidelity_operands, unpack
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    _consts,
    batched_fidelity_chunk,
    fidelity_stages,
)
from bauklank_tpu_torch.ops.pitchmap import unit
from bauklank_tpu_torch.serve import pool as pool_mod
from bauklank_tpu_torch.serve.graphs import eager
from bauklank_tpu_torch.serve.pool import StreamPool, _issue_fast, _issue_fidelity, _mixdown
from bauklank_tpu_torch.utils.metrics import tables_read
from bauklank_tpu_torch.utils.tree import keyed_leaves
from tests.util import tone

torch.set_num_threads(1)
SR = 44100.0

# (engine, geometry, hops a step, rates, formant semitones of voice 1):
# fidelity at the preset in the deterministic regime, the preset with a
# slow voice (MINSTD) and a formant voice, the kiosk's raw 8820/8820
# (every voice MINSTD); the fast engine at a small geometry, 1 and 3 hops
# a step, with and without a formant voice
FAST = dict(block=1024, interval=256)
CASES = {
    "preset": ("fidelity", {}, 1, (0.6, 1.5), 0.0),
    "preset-minstd-formant": ("fidelity", {}, 1, (0.2, 1.5), 5.0),
    "kiosk": ("fidelity", dict(block=8820, interval=8820), 1, (0.001, 0.004), 0.0),
    "fast-h1": ("fast", FAST, 1, (0.6, 1.5), 0.0),
    "fast-h1-formant": ("fast", FAST, 1, (0.2, 1.5), 5.0),
    "fast-h3": ("fast", FAST, 3, (0.6, 1.5), 0.0),
    "fast-h3-formant": ("fast", FAST, 3, (0.2, 1.5), -4.0),
}
# a small geometry, where only the stages' order matters
SMALL = (dict(block=1024, interval=256), 1, (0.6, 1.5), 0.0)
STEP = {"fidelity": "_pool_step_fidelity", "fast": "_pool_step"}


def _pool(engine, geometry, hops, rates, formant):
    pool = StreamPool(capacity=2, hops_per_step=hops, engine=engine, max_track_sec=1.5,
                      device="cpu", **geometry)
    for i, name in enumerate(("s00", "s01")):
        x = tone(330.0 + 110 * i, int(1.5 * SR), SR)
        pool.load_track(name, [x, 0.5 * x])
        pool.start(name, when=0.0, offset=0.0, rate=rates[i], semitones=4.0 - 7.0 * i)
    if formant:
        pool.apply_set("s01", "formantSemitones", formant, lookahead=0.0)
    return pool


def _steps(pool, n, monkeypatch):
    """``n`` steps of ``pool``, each as (args, (states, master, streams)):
    what the pool handed its engine's step function (program, states,
    audios, packed and, of the fidelity engine, the regime), with its own
    packing, regime and formant gate, and what it got back."""
    seen = []
    attr = STEP[pool.engine]
    step = getattr(pool_mod, attr)

    def recorded(*args, **kw):
        seen.append((args, step(*args, **kw)))
        return seen[-1][1]

    with monkeypatch.context() as m:
        m.setattr(pool_mod, attr, recorded)
        for _ in range(n):
            pool.step()
    return seen


def _equal(a, b) -> None:
    for (name, x), (_, y) in zip(keyed_leaves(a), keyed_leaves(b)):
        assert torch.equal(x, y), name


def _fast_chunk(config, state, audio, ends, params):
    """The fast chunk by the engine's public stage functions, composed as
    ``process_chunk`` composed them before it was staged."""
    v, cur_m, gain, reset = hop_factors(config, audio, ends, params, state.prev_cur)
    rot_seq = rotation_scan(state.rot, v, reset)
    emit, tail = synthesis(config, rot_seq, cur_m, gain, state.ola_tail, params.active)
    return StretchState(unit(rot_seq[:, -1]), cur_m[:, :, -1].contiguous(), tail), emit


def _chunk(engine, program, states, audios, packed, *regime):
    """(states, emit) of the engine's chunk on a step's operands, unstaged."""
    if engine == "fidelity":
        return batched_fidelity_chunk(program, states, audios, *fidelity_operands(program, packed),
                                      deterministic=regime[0])
    ends, params, _, _ = unpack(packed)
    return _fast_chunk(program, states, audios, ends.to(torch.int32), params)


def _issue(engine, program, states, audios, packed, *regime, run=eager):
    if engine == "fidelity":
        return _issue_fidelity(program, states, audios, packed, regime[0], run)
    return _issue_fast(program, states, audios, packed, run)


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_pool_step_is_the_chunk_and_mixdown(case, monkeypatch):
    """Two steps of a pool: each is the engine's chunk on the step's
    operands, then the mixdown; the staged step issued eagerly is the
    same."""
    engine, *shape = CASES[case]
    pool = _pool(engine, *shape)
    regimes, formants = set(), set()
    for args, (got_states, master, streams) in _steps(pool, 2, monkeypatch):
        program, states, audios, packed, *regime = args
        regimes.update(regime)
        formants.add(program.formants)
        want_states, want_emit = _chunk(engine, *args)
        assert torch.equal(streams, want_emit)
        _, _, gains, pans = unpack(packed)
        assert torch.equal(master, _mixdown(want_emit, gains, pans))
        _equal(got_states, want_states)
        again_states, again_master, again_streams = _issue(engine, *args)
        assert torch.equal(again_streams, streams) and torch.equal(again_master, master)
        _equal(again_states, got_states)
    if engine == "fidelity":
        assert regimes == {"preset": {True}}.get(case, {False})
    assert formants == {bool(shape[-1])}
    assert float(master.abs().max()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_composed_are_the_chunk(case, monkeypatch):
    engine, *shape = CASES[case]
    pool = _pool(engine, *shape)
    (program, states, audios, packed, *regime), _ = _steps(pool, 1, monkeypatch)[0]
    if engine == "fidelity":
        args = fidelity_operands(program, packed)
        want_states, want_emit = batched_fidelity_chunk(program, states, audios, *args,
                                                        deterministic=regime[0])
        v, stages = fidelity_stages(program, states, audios, *args, deterministic=regime[0])
    else:
        ends, params, _, _ = unpack(packed)
        ends = ends.to(torch.int32)
        want_states, want_emit = process_chunk(program, states, audios, ends, params)
        public_states, public_emit = _fast_chunk(program, states, audios, ends, params)
        assert torch.equal(public_emit, want_emit)
        _equal(public_states, want_states)
        v, stages = fast_stages(program, states, audios, ends, params)
    for _, stage in stages:
        stage()
    assert torch.equal(v["emit"], want_emit)
    _equal(v["states"], want_states)


@pytest.mark.parametrize("engine,deterministic", [
    pytest.param("fidelity", True, id="True"),
    pytest.param("fidelity", False, id="False"),
    pytest.param("fast", None, id="fast"),
])
def test_stages_run_in_step_order_under_the_eager_ranges(engine, deterministic, monkeypatch):
    pool = _pool(engine, *SMALL)
    (program, states, audios, packed, *_), _ = _steps(pool, 1, monkeypatch)[0]
    names = []
    _issue(engine, program, states, audios, packed, deterministic,
           run=lambda name, stage: (names.append(name), stage()))
    if engine == "fast":
        inner = ["fast.analyse", "fast.hop_factors", "fast.rotation_scan", "fast.synthesis",
                 "fast.carry"]
    else:
        inner = ["fidelity.analyse",
                 "fidelity.chain_inputs" if deterministic else "fidelity.minstd",
                 "fidelity.chain_inputs", "fidelity.hop_loop", "fidelity.synthesis",
                 "fidelity.carry"]
    assert names == [None, *inner, None]


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
