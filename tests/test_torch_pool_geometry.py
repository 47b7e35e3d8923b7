"""PyTorch port, the pool's geometry and the fidelity step's MINSTD range.

- ``StreamPool(block=, interval=)``: the fidelity pool runs the raw sizes
  (the kiosk's 8820/8820: FFT 10240, 5120 bands, ``long_step`` 1) and its
  output clock uses them; the fast pool rounds them as ``StretchConfig``
  does; a half-given pair, or a pair with ``config``, is refused; a pool
  built without them has the geometry it always had.
- ``batched_fidelity_chunk`` runs the MINSTD part of stage 2 in a range of
  its own, ``fidelity.minstd``, a sibling before ``fidelity.chain_inputs``,
  only outside the deterministic regime, and its results are bit-equal to
  the one-call composition (``chain_inputs_hops``, the hop loop, the
  synthesis) in both regimes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bauklank_tpu_torch.engine import fidelity
from bauklank_tpu_torch.engine.config import StretchConfig, preset_default
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    batched_fidelity_chunk,
    init_batched_fidelity_state,
)
from bauklank_tpu_torch.engine.spectral import SpectralState, chain_inputs_hops
from bauklank_tpu_torch.serve.pool import StreamPool

SR = 44100.0


def _sizes(pool):
    """(block, interval, output latency) of the pool's engine drive."""
    d = pool.drive
    return d.block, d.interval, d.output_latency


def test_fidelity_pool_runs_the_raw_kiosk_geometry():
    pool = StreamPool(capacity=1, engine="fidelity", block=8820, interval=8820,
                      max_track_sec=1.0, device="cpu")
    s = pool.scfg
    assert s == SpectralConfig(2, 8820, 8820, split=True)
    assert (s.fft, s.bands, s.long_step) == (10240, 5120, 1)
    assert _sizes(pool) == (8820, 8820, 8820 - 4410 + 8820)
    assert pool.output_time == 13230 / SR
    assert pool.states[0].prev_output.shape == (1, 2, 5120)
    assert pool.states[1].shape == (1, 2, 8820 + 8820)
    pool.load_track("s00", [np.zeros(4410, np.float32)])
    pool.start("s00", rate=0.001)
    master, streams = pool.step(fetch=True)
    assert streams.shape == (1, 2, 8820) and master.shape == (2, 8820)
    assert pool.output_time == (8820 + 13230) / SR
    assert pool.minstd_steps == 1


def test_fast_pool_rounds_block_and_interval_as_its_config_does():
    pool = StreamPool(capacity=1, engine="fast", block=8820, interval=8820,
                      max_track_sec=1.0, device="cpu")
    assert pool.config == StretchConfig(channels=2, block=8820, interval=8820)
    assert _sizes(pool) == (9216, 8820, pool.config.output_latency)


@pytest.mark.parametrize("kw, said", [
    (dict(block=8820), "give both or neither"),
    (dict(interval=8820), "give both or neither"),
    (dict(block=8820, interval=8820, config=StretchConfig(block=8820, interval=8820)),
     "not both"),
], ids=["block_alone", "interval_alone", "config_with_block"])
@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_half_a_geometry_or_a_config_beside_it_is_refused(engine, kw, said):
    with pytest.raises(ValueError, match=said):
        StreamPool(capacity=1, engine=engine, max_track_sec=1.0, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_a_pool_without_block_or_interval_keeps_its_geometry(engine):
    pool = StreamPool(capacity=1, engine=engine, max_track_sec=1.0, device="cpu")
    assert pool.config == preset_default(2, SR)
    if engine == "fidelity":
        assert pool.scfg == SpectralConfig(2, 5292, 1323, split=True)
        assert _sizes(pool) == (5292, 1323, 5292 - 2646 + 1323)
    else:
        assert _sizes(pool) == (5376, 1323, pool.config.output_latency)
    # a given config keeps its grid block in the fidelity pool (the JAX pool's)
    cfg = StretchConfig(block=8820, interval=8820)
    pool = StreamPool(capacity=1, engine=engine, config=cfg, max_track_sec=1.0, device="cpu")
    assert pool.config is cfg
    if engine == "fidelity":
        assert pool.scfg == SpectralConfig(2, 9216, 8820, split=True)


def test_track_limit_counts_the_raw_block():
    # 2**24 samples less the raw block is just inside; one sample more is not
    limit = (2**24 - 8820 - 1) / SR
    StreamPool(capacity=1, engine="fidelity", block=8820, interval=8820, max_track_sec=limit,
               device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        StreamPool(capacity=1, engine="fidelity", block=8820, interval=8820,
                   max_track_sec=limit + 2 / SR, device="cpu")


# ------------------------------------------------- the fidelity.minstd range
def _chunk_inputs(rates):
    """A small pool step's operands: three streams at ``rates``."""
    cfg = SpectralConfig(2, 256, 64)
    s_n, h = len(rates), 3
    g = torch.Generator().manual_seed(5)
    audios = torch.randn((s_n, 2, 4096), generator=g)
    states = init_batched_fidelity_state(cfg, s_n, "cpu", seed=977)
    states = (states[0]._replace(rng=torch.tensor([977, 41, 2**30 + 3])[:s_n]), states[1])
    ends = torch.tensor([[1500 + 40 * i + 7 * k for k in range(h)] for i in range(s_n)],
                        dtype=torch.int32)
    rate = torch.tensor(rates, dtype=torch.float32)
    tf = torch.clamp_max(1.0 / rate, float(cfg.interval))
    mult = torch.tensor([1.0, 2.0 ** (3 / 12), 2.0 ** (-5 / 12)])[:s_n]
    limit = (8000.0 / SR) / torch.sqrt(mult)
    active = torch.ones(s_n)
    return cfg, states, audios, ends, tf, mult, limit, active


def _composed(cfg, states, audios, ends, tf, mult, limit, active, deterministic):
    """The step with stage 2 in one call of ``chain_inputs_hops``."""
    spec, _ = states
    cur, prev = fidelity._analyse_cur_prev(cfg, audios, ends)
    xs, (rng, fv, fw) = chain_inputs_hops(cfg, spec, cur, prev, tf, mult, limit,
                                          deterministic=deterministic)
    outs = fidelity._hop_loop(cfg, spec.prev_output, xs)
    new = SpectralState(outs[:, -1], xs["pred_energy"][-1], rng, fv, fw)
    return fidelity._finish(cfg, outs, new, states, active)


def _ranges(fn):
    """(result, [(start, end, name)] of the fidelity.* ranges) of one call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    names = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("fidelity.")]
    return got, sorted(names)


@pytest.mark.parametrize("rates, deterministic, minstd", [
    ((0.8, 1.3, 1.0), True, False),
    ((0.001, 0.25, 1.0), False, True),
    ((0.001, 0.25, 1.0), None, True),
    ((0.8, 1.3, 1.0), None, True),
], ids=["deterministic", "minstd", "minstd_no_word", "deterministic_no_word"])
def test_minstd_range_is_a_sibling_outside_the_deterministic_regime(rates, deterministic,
                                                                     minstd):
    ops = _chunk_inputs(rates)
    want = _composed(*ops, deterministic)
    got, ranges = _ranges(lambda: batched_fidelity_chunk(*ops, deterministic=deterministic))
    flat = lambda t: [x for part in t for x in (part if isinstance(part, tuple) else (part,))]
    for a, b in zip(flat(got[0]) + [got[1]], flat(want[0]) + [want[1]]):
        assert torch.equal(a, b)
    if deterministic is False:
        assert not torch.equal(got[0][0].rng, ops[1][0].rng)
    names = [n for _, _, n in ranges]
    assert names.count("fidelity.minstd") == int(minstd)
    # inside the deterministic regime the MINSTD part is a first chain_inputs range
    assert names.count("fidelity.chain_inputs") == 2 - int(minstd)
    if minstd:
        (m0, m1), (c0, _) = [(s, e) for s, e, n in ranges
                             if n in ("fidelity.minstd", "fidelity.chain_inputs")]
        assert m1 <= c0, "fidelity.minstd is nested in or after fidelity.chain_inputs"
        assert names.index("fidelity.minstd") == names.index("fidelity.chain_inputs") - 1
