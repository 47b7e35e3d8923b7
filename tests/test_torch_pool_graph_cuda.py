"""The pools' step graphs on the card (``serve/graphs.py``), of both
engines.  Marked ``cuda``: each test skips unless a CUDA device and
``nvcc`` are present.

A ``StreamPool`` on the card captures its step as CUDA graphs, once per
step key, and replays them.  Each case steps such a pool beside an eager
twin, a pool built alike with its graphs taken off
(``tests.util.without_graphs``: its steps run the eager chain, as the
pool stepped before it had graphs), and holds the masters, the streams
and every state leaf equal with ``torch.equal`` after every step, and
the pool's ``graph_captures`` and ``graph_replays`` at their counts: the
fidelity engine at the preset in the deterministic regime, at H = 1 with
the regime flipping and at the kiosk's raw 8820/8820 geometry; the fast
engine at H = 1 and H = 32; either engine with a formant voice turned on
and off, across ``grow``, a checkpoint's save and load, and
``load_track``.  Beside them, of either engine: the returned tensors are
the pool's own, not the graphs' memory; a replay runs the eager step's
kernels, which the profiler sees, and the host issues none; and each
fault the benchmark plants in the pool step (``portbench/core/faults.py``)
changes what a replayed step returns.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.ops.analyze import analyze_signal
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.utils import checkpoint
from bauklank_tpu_torch.utils.tree import keyed_leaves
from portbench.core.faults import FAULTS, plant
# tests/util.py, imported by its directory: an installed package named
# ``tests`` would hide ``tests.util``
from util import without_graphs

pytestmark = pytest.mark.cuda

SR = 44100.0
STEPS = 12
ENGINES = ["fidelity", "fast"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _tone(freq: float, n: int) -> np.ndarray:
    return np.sin(2 * np.pi * freq / SR * np.arange(n) + 0.3).astype(np.float32)


def _pool(dev, capacity=8, hops=8, rates=None, semitones=None, engine="fidelity", **geometry):
    """A pool of ``engine`` with a tone a voice, every voice started."""
    pool = StreamPool(capacity=capacity, hops_per_step=hops, engine=engine,
                      max_track_sec=4.0, device=dev, **geometry)
    rates = np.linspace(0.5, 2.0, capacity) if rates is None else rates
    semitones = np.linspace(-12.0, 12.0, capacity) if semitones is None else semitones
    for i in range(capacity):
        x = _tone(220.0 * (1 + 0.37 * i), int(3.5 * SR))
        name = f"s{i:02d}"
        pool.load_track(name, [x, np.roll(x, 311 * (i + 1))])
        pool.start(name, when=0.0, offset=0.0, rate=float(rates[i]),
                   semitones=float(semitones[i]))
    return pool


def _lockstep(make, steps=STEPS, events=None):
    """Step a pool from ``make()`` and its eager twin ``steps`` times,
    applying ``events[k]`` (callables of a pool) to both before step k,
    and hold them equal after every step.  Returns the pool and the step
    keys' sequence as (capacity, regime, formants) seen by the pool."""
    graphed, eager = make(), without_graphs(make())
    keys = []
    for k in range(steps):
        for act in (events or {}).get(k, ()):
            act(graphed)
            act(eager)
        before = graphed.metrics()
        m_g, s_g = graphed.step()
        m_e, s_e = eager.step()
        after = graphed.metrics()
        keys.append((graphed.capacity, after["minstd_steps"] - before["minstd_steps"],
                     after["formant_steps"] - before["formant_steps"]))
        assert torch.equal(m_g, m_e), f"master, step {k}"
        assert torch.equal(s_g, s_e), f"streams, step {k}"
        for (name, a), (_, b) in zip(keyed_leaves(graphed.states), keyed_leaves(eager.states)):
            assert torch.equal(a, b), f"state {name}, step {k}"
    assert float(m_g.abs().max()) > 0, "a silent master"
    return graphed, keys


def _counts(pool, captures: int, steps: int = STEPS) -> None:
    m = pool.metrics()
    assert (m["graph_captures"], m["graph_replays"]) == (captures, steps - captures)


def test_preset_deterministic(dev):
    pool, keys = _lockstep(lambda: _pool(dev))
    assert {k[1] for k in keys} == {0}
    _counts(pool, 1)


def test_regime_flips_at_one_hop_a_step(dev):
    def rate(value):
        return lambda p: p.apply_set("s01", "rate", value, lookahead=0.0)

    pool, keys = _lockstep(lambda: _pool(dev, capacity=4, hops=1,
                                         rates=[0.5, 0.8, 1.25, 2.0]),
                           events={4: [rate(0.1)], 8: [rate(1.0)]})
    regimes = [k[1] for k in keys]
    assert regimes[0] == 0 and 1 in regimes and regimes[-1] == 0, regimes
    _counts(pool, 2)


def test_kiosk_raw_geometry(dev):
    pool, keys = _lockstep(lambda: _pool(dev, capacity=4, hops=2, rates=[0.001] * 4,
                                         semitones=[-24.0, -7.0, 5.0, 24.0],
                                         block=8820, interval=8820))
    assert pool.scfg.block == pool.scfg.interval == 8820
    assert {k[1] for k in keys} == {1}
    _counts(pool, 1)


@pytest.mark.parametrize("hops,steps", [(1, STEPS), (32, 6)])
def test_fast_replays_equal_the_eager_step(dev, hops, steps):
    """The fast engine as ``serve`` steps it (H = 1) and in batch (H = 32,
    fewer voices): one key, captured once, every later step a replay."""
    rates = [0.3, 0.5, 0.8, 1.2]
    pool, keys = _lockstep(lambda: _pool(dev, capacity=4, hops=hops, rates=rates, engine="fast"),
                           steps=steps)
    assert pool.engine == "fast" and keys == [(4, 0, 0)] * steps
    _counts(pool, 1, steps)


@pytest.mark.parametrize("engine", ENGINES)
def test_formant_voice_on_then_off(dev, engine):
    def formant(value):
        return lambda p: p.apply_set("s02", "formantSemitones", value, lookahead=0.0)

    pool, keys = _lockstep(lambda: _pool(dev, capacity=4, hops=2, engine=engine),
                           events={4: [formant(4.0)], 8: [formant(0.0)]})
    assert [k[2] for k in keys] == [0] * 4 + [1] * 4 + [0] * 4
    _counts(pool, 2)


@pytest.mark.parametrize("engine", ENGINES)
def test_grow_recaptures(dev, engine):
    pool, keys = _lockstep(lambda: _pool(dev, capacity=4, hops=2, engine=engine),
                           events={6: [lambda p: p.grow(6)]})
    assert [k[0] for k in keys] == [4] * 6 + [6] * 6
    _counts(pool, 2)


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_save_and_load(dev, engine, tmp_path):
    path = tmp_path / "pool"
    events = {6: [lambda p: checkpoint.save_pool(path, p),
                  lambda p: checkpoint.load_pool(path, p)]}
    pool, _ = _lockstep(lambda: _pool(dev, capacity=4, hops=2, engine=engine), events=events)
    _counts(pool, 2)


@pytest.mark.parametrize("engine", ENGINES)
def test_load_track_keeps_the_graphs(dev, engine):
    x = _tone(523.25, int(2 * SR))
    pool, _ = _lockstep(lambda: _pool(dev, capacity=4, hops=2, engine=engine),
                        events={6: [lambda p: p.load_track("s01", [x, 0.5 * x])]})
    _counts(pool, 1)
    assert pool.metrics()["audio_uploads"] == 2


@pytest.mark.parametrize("engine", ENGINES)
def test_pipelined_fetch_with_graphs(dev, engine):
    pool = _pool(dev, capacity=4, hops=2, engine=engine)
    twin = without_graphs(_pool(dev, capacity=4, hops=2, engine=engine))
    got = [m for m in (pool.step(fetch="pipeline")[0] for _ in range(8)) if m is not None]
    got += pool.drain()
    want = [twin.step(fetch=True)[0] for _ in range(8)]
    np.testing.assert_array_equal(np.concatenate(got, axis=1), np.concatenate(want, axis=1))
    _counts(pool, 1, 8)


@pytest.mark.parametrize("engine", ENGINES)
def test_returned_tensors_are_not_the_graphs_memory(dev, engine):
    pool = _pool(dev, capacity=4, hops=2, engine=engine)
    for _ in range(3):
        pool.step()
    master, streams = pool.step()
    last, analysis = pool._last_streams, pool.analyze("s01")
    held = master.clone(), streams.clone()
    assert last is streams
    pool.step()
    assert pool._last_streams.data_ptr() != streams.data_ptr()
    assert torch.equal(master, held[0]) and torch.equal(streams, held[1])
    assert torch.equal(last, held[1])
    assert analyze_signal("s01", streams[1], SR) == analysis
    _counts(pool, 1, 5)


# each engine's own kernels, launched once a step or more
OWN = {"fidelity": {"band_chain": 2, "smooth_pair": 1},
       "fast": {"frames_windowed": 1, "banded_interp": 1}}


@pytest.mark.parametrize("engine", ENGINES)
def test_replays_run_the_eager_steps_kernels(dev, engine):
    """The host issues the step's launches twice, in the eager first step
    and into the capture, and none for a replay; the profiler sees the
    replays run each kernel as often as the eager step launches it."""
    pool = _pool(dev, capacity=4, hops=2, engine=engine)
    twin = without_graphs(_pool(dev, capacity=4, hops=2, engine=engine))
    kernels.reset_launches()
    twin.step()
    per_step = dict(kernels.LAUNCHES)
    assert {k: per_step[k] for k in OWN[engine]} == OWN[engine]
    kernels.reset_launches()
    for _ in range(2):
        pool.step()
    assert kernels.LAUNCHES == {k: 2 * n for k, n in per_step.items()}
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pool.step()
        torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict.fromkeys(per_step, 0)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ran = {k: sum(bool(re.search(rf"\b{k}(_\w+)?_kernel", n)) for n in names)
           for k in per_step}
    assert ran == {k: 3 * n for k, n in per_step.items()}
    _counts(pool, 1, 5)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_change_the_replayed_steps(dev, fault, engine):
    """The benchmark's faults wrap ``serve.pool._pool_step`` or
    ``_pool_step_fidelity``, which a pool with graphs calls on every step:
    a faulted pool's third step, a replay, returns other streams or
    another master than a clean pool's."""
    clean = _pool(dev, capacity=4, hops=2, engine=engine)
    want = [clean.step() for _ in range(3)][-1]
    undo = plant(fault, engine)
    try:
        faulted = _pool(dev, capacity=4, hops=2, engine=engine)
        got = [faulted.step() for _ in range(3)][-1]
    finally:
        undo()
    _counts(faulted, 1, 3)
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])), fault
    if fault == "altered_answer":
        assert torch.equal(got[1][0], got[1][1])
