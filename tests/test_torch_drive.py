"""PyTorch port, the engine's drive (``engine/drive.py``) against the JAX
package: what ``StreamPool``, ``StretchNode`` and ``LivePool`` of each
package hand their step functions, bit for bit.

Each pair is driven alike (the same starts, one at time factor 2, the
edge of the deterministic regime, a rate turn to 0.001 into the MINSTD
regime, a ``tone`` turn and a formant turn on and off) with its
step functions replaced by recorders, so no engine runs:

- pool: ``_pool_step`` / ``_pool_step_fidelity`` in both packages;
- node: ``_chunk_jit`` / ``_fidelity_chunk_jit`` in JAX, ``_chunk`` /
  ``_fidelity_chunk`` in the port;
- live pool: ``_live_step`` / ``_live_fidelity_step`` in JAX,
  ``process_live`` / ``_live_fidelity_step`` in the port.

Every packed array must be equal bit for bit, and so must the program of
each call (block, interval, split, formant gate).  The port's fidelity
regime word must be the device's own law on the packed rates.  The JAX
pool has no raw geometry: its raw case is its pool with the raw
``SpectralConfig`` put in at test time.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bauklank_tpu.engine import StretchConfig as JStretchConfig
from bauklank_tpu.engine.spectral import SpectralConfig as JSpectralConfig
from bauklank_tpu.node import node as jnode
from bauklank_tpu.serve import livepool as jlive
from bauklank_tpu.serve import pool as jpool
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.node import node as tnode
from bauklank_tpu_torch.serve import livepool as tlive
from bauklank_tpu_torch.serve import pool as tpool
from tests.util import tone

torch.set_num_threads(1)
SR = 44100.0
STEPS = 10

CASES = [(kind, engine, geometry)
         for kind in ("pool", "node", "live")
         for engine in ("fast", "fidelity")
         for geometry in ("preset", "config", "raw")
         if not (kind == "live" and geometry == "raw")]


def _program(cfg):
    """What a step's program fixes: block, interval, split, formant gate."""
    split = cfg.split if hasattr(cfg, "split") else cfg.split_computation
    return cfg.channels, cfg.block, cfg.interval, split, cfg.formants


def _sizes(kind, obj):
    """The geometry's sizes and latencies as the object reports them."""
    if kind == "node":
        return obj.block_samples, obj.interval_samples, obj.input_latency, obj.output_latency
    if kind == "live":
        d = getattr(obj, "drive", None)
        return (d.interval, d.output_latency) if d else (obj.config.interval,
                                                         obj.config.output_latency)
    d = getattr(obj, "drive", None)
    return (d.block, d.interval, d.output_latency) if d else obj._sizes


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


class _Recorder:
    """Stands for a step function: keeps (program, packed rows, regime word)
    of each call and returns silence of the right shape."""

    def __init__(self, out_shape, zeros):
        self.calls: list = []
        self._out_shape, self._zeros = out_shape, zeros

    def __call__(self, program, state, inputs, packed, regime=None, **_):
        self.calls.append((program, _bits(packed), regime))
        return state, self._zeros(self._out_shape(program, packed))


def _np_zeros(shape):
    return np.zeros(shape, np.float32)


# --------------------------------------------------------------- building
def _pool_pair(engine, geometry, hops=2):
    kw = dict(capacity=3, sample_rate=SR, channels=2, max_track_sec=1.0, hops_per_step=hops,
              engine=engine)
    if geometry == "preset":
        return jpool.StreamPool(**kw), tpool.StreamPool(device="cpu", **kw)
    if geometry == "config":
        return (jpool.StreamPool(config=JStretchConfig(block=2048, interval=512), **kw),
                tpool.StreamPool(config=StretchConfig(block=2048, interval=512), device="cpu",
                                 **kw))
    jax_pool = jpool.StreamPool(config=JStretchConfig(block=8820, interval=8820), **kw)
    if engine == "fidelity":
        jax_pool.scfg = JSpectralConfig(2, 8820, 8820, split=True)
    return jax_pool, tpool.StreamPool(block=8820, interval=8820, device="cpu", **kw)


def _node_pair(engine, geometry):
    kw = dict(sample_rate=SR, channels=2, engine=engine)
    if geometry == "config":
        return (jnode.StretchNode(config=JStretchConfig(block=2048, interval=512), **kw),
                tnode.StretchNode(config=StretchConfig(block=2048, interval=512), device="cpu",
                                  **kw))
    pair = jnode.StretchNode(**kw), tnode.StretchNode(device="cpu", **kw)
    if geometry == "raw":
        for node in pair:
            node.configure(block=8820, interval=8820)
    return pair


def _live_pair(engine, geometry):
    kw = dict(capacity=3, sample_rate=SR, channels=2, hops_per_step=2, engine=engine)
    if geometry == "preset":
        return jlive.LivePool(**kw), tlive.LivePool(device="cpu", **kw)
    return (jlive.LivePool(config=JStretchConfig(block=2048, interval=512), **kw),
            tlive.LivePool(config=StretchConfig(block=2048, interval=512), device="cpu", **kw))


# ---------------------------------------------------------------- driving
TURNS = {1: ("rate", 0.001), 3: ("tone", -7.0), 5: ("formantSemitones", 4.0),
         7: ("formantSemitones", 0.0)}


def _drive_pool(pool):
    x = tone(330.0, int(SR), SR)
    for name in ("s00", "s01"):
        pool.load_track(name, [x, 0.5 * x])
    pool.start("s00", when=0.0, offset=0.0, rate=0.75)
    pool.start("s01", when=0.0, offset=0.1, rate=0.5, semitones=3.0)   # time factor 2
    pool.start("s02", when=0.0, rate=1.0)        # never loaded: inactive
    for k in range(STEPS):
        if k in TURNS:
            assert pool.apply_set("s00" if k == 1 else "s01", *TURNS[k], lookahead=0.0)
        if k == 2:
            pool.apply_set("s00", "volume", 0.5)
            pool.apply_set("s01", "pan", -0.25)
        pool.step()


def _drive_node(node):
    node.add_buffers([tone(330.0, 2 * int(SR), SR)] * 2)
    node.start(when=0.0, offset=0.0, rate=0.5, semitones=2.0)   # time factor 2
    for k, (key, value) in TURNS.items():   # after the first hop at every geometry
        node.schedule({"output": 0.4 + 0.2 * k, key: value})
    for n in [2205] * 8 + [60000, 30000]:
        node.process_output(n)


def _drive_live(pool):
    for k in range(STEPS):
        if k in TURNS:
            assert pool.apply_set("l01", *TURNS[k], lookahead=0.0)
        for i, name in enumerate(pool.names):
            pool.feed(name, tone(220.0 * (i + 1), 1000 + 300 * k, SR))
        pool.step()


# ----------------------------------------------------------------- the test
def _record(monkeypatch, kind, engine):
    """(JAX recorder, port recorder) with the step functions patched."""
    fid = engine == "fidelity"
    if kind == "pool":
        def streams(program, packed):
            h = packed.shape[1] - 11
            return packed.shape[0], 2, h * program.interval

        def answer(zeros):
            rec = _Recorder(streams, zeros)

            def step(program, states, audios, packed, *regime, **_):
                states, out = rec(program, states, audios, packed, *regime)
                return states, zeros((2, out.shape[-1])), out
            return rec, step

        jrec, jstep = answer(_np_zeros)
        trec, tstep = answer(torch.zeros)
        name = "_pool_step_fidelity" if fid else "_pool_step"
        monkeypatch.setattr(jpool, name, jstep)
        monkeypatch.setattr(tpool, name, tstep)
        return jrec, trec
    if kind == "node":
        def chunk(program, packed):
            return 2, (packed.shape[0] - 7) * program.interval

        jrec, trec = _Recorder(chunk, _np_zeros), _Recorder(chunk, torch.zeros)
        monkeypatch.setattr(jnode, "_fidelity_chunk_jit" if fid else "_chunk_jit", jrec)
        monkeypatch.setattr(tnode, "_fidelity_chunk" if fid else "_chunk", trec)
        return jrec, trec

    def live(program, packed):
        return packed.shape[0], 2, 2 * program.interval

    jrec, trec = _Recorder(live, _np_zeros), _Recorder(live, torch.zeros)
    monkeypatch.setattr(jlive, "_live_fidelity_step" if fid else "_live_step", jrec)
    if fid:
        monkeypatch.setattr(tlive, "_live_fidelity_step", trec)
    else:
        # process_live takes the unpacked fields: record them as the [S, 7] rows
        monkeypatch.setattr(tlive, "process_live", lambda cfg, st, chunks, params: trec(
            cfg, st, chunks, torch.stack(list(params), dim=-1)))
    return jrec, trec


@pytest.mark.parametrize("kind, engine, geometry", CASES,
                         ids=["-".join(c) for c in CASES])
def test_drive_hands_each_step_what_the_jax_package_hands_it(kind, engine, geometry,
                                                             monkeypatch):
    jax_obj, port_obj = {"pool": _pool_pair, "node": _node_pair,
                         "live": _live_pair}[kind](engine, geometry)
    jrec, trec = _record(monkeypatch, kind, engine)
    drive = {"pool": _drive_pool, "node": _drive_node, "live": _drive_live}[kind]
    drive(jax_obj)
    drive(port_obj)
    assert _sizes(kind, port_obj) == _sizes(kind, jax_obj)
    assert len(trec.calls) == len(jrec.calls) >= 5
    # the rate, the second of the seven fields: 10 columns from a pool
    # row's end (before the four ramps), 6 from a node's
    rate = -10 if kind == "pool" else -6
    for k, ((jprog, jpacked, _), (tprog, tpacked, regime)) in enumerate(
            zip(jrec.calls, trec.calls)):
        assert _program(tprog) == _program(jprog), k
        assert tpacked.shape == jpacked.shape and np.array_equal(tpacked, jpacked), k
        if engine == "fidelity" and kind != "live":
            # the device's law on the packed rates (engine.drive.fidelity_operands)
            rates = torch.from_numpy(jpacked.view(np.float32)[..., rate].copy())
            tf = torch.clamp_max(1.0 / torch.clamp_min(rates, 1e-6), float(tprog.interval))
            assert regime == bool((tf <= 2.0).all()), k
    # the fast live pool runs its config as it is, with no formant gate
    gates = {_program(p)[-1] for p, _, _ in trec.calls}
    assert gates == ({True} if (kind, engine) == ("live", "fast") else {True, False})
    if engine == "fidelity" and kind != "live":
        assert {r for _, _, r in trec.calls} == {True, False}
