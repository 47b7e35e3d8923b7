"""PyTorch port, the pool's tracing: while a profiler records, every
host moment of a ``StreamPool.step`` lies under a ``record_function``
range of the program (``pool.*`` and the engine's ``fast.*`` /
``fidelity.*``), each ``pool.*`` range opens once a step, and with no
profiler no range is entered; the pool's counters count the host's
decisions (regime, formant gating, track uploads, constant tables, late
steps)."""

from __future__ import annotations

import collections
import contextlib
import functools
import sys

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.serve import pool as pool_mod
from bauklank_tpu_torch.serve.pool import COUNTERS, StreamPool
from bauklank_tpu_torch.serve.unified import UnifiedPool
from bauklank_tpu_torch.utils import metrics
from bauklank_tpu_torch.utils.metrics import StepTimer, span, table_builds

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

PROGRAM = ("pool.", "fast.", "fidelity.")


def _pool(engine: str, rates=(0.8, 1.3), hops: int = 2) -> StreamPool:
    """Two voices at a small geometry (a profiled fidelity step records
    every op of the plain band chain)."""
    pool = StreamPool(capacity=2, config=StretchConfig(block=256, interval=64),
                      max_track_sec=1.0, hops_per_step=hops, engine=engine, device="cpu")
    x = material.case_input(1.0, 2, seconds=0.5)
    for i, rate in enumerate(rates):
        pool.load_track(f"s{i:02d}", np.roll(x, 977 * i, axis=-1))
        pool.start(f"s{i:02d}", rate=rate, semitones=3.0 * i)
    return pool


def _profiled(fn):
    """(fn's result, the profiler's raw events) of one call on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    return got, prof.profiler.kineto_results.events()


def _check_covered(events, opened: dict) -> None:
    """Every op lies under a program range, and the ``pool.*`` ranges
    opened as ``opened``.  An op's range is the innermost
    ``record_function`` range of its thread that holds its start."""
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id())
                     for e in events if e.is_user_annotation()), key=lambda r: -r[0])
    ops = [e for e in events if e.name().startswith("aten::")]
    assert ops
    where = collections.Counter(
        next((name for s, end, name, tid in ranges
              if tid == e.start_thread_id() and s <= e.start_ns() < end), None)
        for e in ops)
    stray = {w: n for w, n in where.items() if w is None or not w.startswith(PROGRAM)}
    assert not stray, stray
    got = collections.Counter(r[2] for r in ranges if r[2].startswith("pool."))
    assert dict(got) == opened


ONE_STEP = {"pool.step": 1, "pool.pack": 1, "pool.fetch": 1}


@pytest.mark.parametrize("case", ["fast", "fidelity", "fidelity-formant", "fast-formant"])
def test_every_op_of_a_fetched_step_is_under_a_program_range(case):
    """``step(fetch=True)``: the first step (the tracks' upload and the
    constant tables included) and a later one."""
    engine, _, formant = case.partition("-")
    pool = _pool(engine)
    if formant:
        assert pool.apply_set("s01", "formantSemitones", 4.0, lookahead=0.0)
    (master, _), events = _profiled(lambda: pool.step(fetch=True))
    assert isinstance(master, np.ndarray) and master.shape == (2, 2 * 64)
    _check_covered(events, ONE_STEP)
    _, events = _profiled(lambda: pool.step(fetch=True))
    _check_covered(events, ONE_STEP)
    names = {e.name() for e in events}
    assert {f"{engine}.synthesis", f"{engine}.carry"} <= names
    assert pool.formant_steps == (2 if formant else 0)


def test_pipelined_steps_and_drain_are_under_program_ranges():
    pool = _pool("fidelity")
    pool.step(fetch="pipeline")
    for _ in range(pool.pipeline_depth):
        (master, _), events = _profiled(lambda: pool.step(fetch="pipeline"))
        _check_covered(events, ONE_STEP)
    assert isinstance(master, np.ndarray)
    masters, events = _profiled(pool.drain)
    assert len(masters) == pool.pipeline_depth
    _check_covered(events, {"pool.fetch": 1})


@pytest.mark.parametrize("rates,minstd", [((0.8, 1.3), 0), ((0.25, 1.3), 3)])
def test_minstd_steps_count_the_steps_outside_the_deterministic_regime(rates, minstd):
    """A voice under rate 0.5 (time factor over 2) puts every step in the
    MINSTD regime; the fast engine has none."""
    for engine in ("fidelity", "fast"):
        pool = _pool(engine, rates)
        for _ in range(3):
            pool.step()
        assert pool.metrics()["minstd_steps"] == (minstd if engine == "fidelity" else 0)


@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_formant_steps_count_the_steps_that_ran_the_formant_chain(engine, monkeypatch):
    """The counter follows the host's gating: the configuration the step
    was given, from the step the control takes effect."""
    attr = "_pool_step_fidelity" if engine == "fidelity" else "_pool_step"
    seen = []
    step = getattr(pool_mod, attr)
    monkeypatch.setattr(pool_mod, attr,
                        lambda cfg, *a, **kw: (seen.append(cfg.formants), step(cfg, *a, **kw))[1])
    pool = _pool(engine)
    pool.step()
    assert pool.apply_set("s00", "formantSemitones", -3.0, lookahead=0.0)
    pool.step()
    pool.step()
    assert seen == [False, True, True]
    assert pool.metrics()["formant_steps"] == 2


def test_audio_uploads_and_table_builds_stop_after_the_first_step():
    pool = _pool("fidelity")
    assert pool.metrics()["audio_uploads"] == 0
    pool.step()
    first = pool.metrics()
    assert first["audio_uploads"] == 1
    for _ in range(3):
        pool.step()
    later = pool.metrics()
    assert later["audio_uploads"] == 1 and later["table_builds"] == first["table_builds"]
    assert later["steps"] == 4
    pool.load_track("s01", material.case_input(1.0, 2, seconds=0.5))
    pool.step()
    assert pool.metrics()["audio_uploads"] == 2


def test_table_builds_counts_a_new_geometry_once():
    before = table_builds()
    pool = StreamPool(capacity=1, config=StretchConfig(block=768, interval=192),
                      max_track_sec=0.5, device="cpu")
    pool.step()
    built = table_builds()
    assert built > before
    pool.step()
    assert table_builds() == built


def test_table_builders_are_every_table_cache_of_ops_and_engine():
    """Each ``lru_cache`` under ``ops/`` and ``engine/`` is a
    ``table_cache`` that ``table_builds`` counts, but the two that build
    none: the libm handle and the FFT size."""
    import importlib
    import pkgutil

    import bauklank_tpu_torch.engine as engine_pkg
    import bauklank_tpu_torch.ops as ops_pkg

    caches = set()
    for pkg in (ops_pkg, engine_pkg):
        for info in pkgutil.iter_modules(pkg.__path__):
            mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
            # a table_cache is an lru_cache behind a wrapper with its cache_info
            caches |= {f"{mod.__name__}.{n}" for n, f in vars(mod).items()
                       if (isinstance(f, functools._lru_cache_wrapper)
                           or callable(getattr(f, "cache_info", None)))
                       and f.__module__ == mod.__name__}
    counted = {f"{f.__module__}.{f.__name__}" for f in metrics._TABLE_CACHES}
    assert caches - counted == {"bauklank_tpu_torch.ops.mdft._libm",
                                "bauklank_tpu_torch.ops.fftsize.fast_fft_size"}
    assert counted <= caches


def test_span_is_a_range_only_while_a_profiler_records():
    """With no profiler the hot path enters no range at all."""
    assert isinstance(span("pool.step"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = span("pool.step")
        assert isinstance(got, record_function)
        with got:
            pass
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()] == ["pool.step"]
    assert isinstance(span("pool.step"), contextlib.nullcontext)


def test_an_unprofiled_step_enters_no_range(monkeypatch):
    """A step with no profiler on reaches ``record_function`` nowhere."""
    from torch.autograd import profiler as autograd_profiler

    pool = _pool("fidelity")
    pool.step(fetch=True)
    entered = []
    enter = autograd_profiler.record_function.__enter__
    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        lambda self: (entered.append(self.name), enter(self))[1])
    pool.step(fetch=True)
    assert entered == []


@pytest.mark.parametrize("deadline,late", [(0.0, 3), (1e6, 0), (None, 0)])
def test_step_timer_counts_steps_past_their_deadline(deadline, late):
    t = StepTimer(100.0)
    for _ in range(3):
        t.start()
        t.tick(10, deadline)
    snap = t.snapshot()
    assert snap["steps"] == 3 and snap["late"] == late


def test_unified_pool_sums_its_buckets_counters():
    pool = UnifiedPool(sample_rate=44100.0, engine="fidelity", max_track_sec=1.0, quantum=220,
                       device="cpu")
    x = material.case_input(1.0, 2, seconds=0.5)
    for name, block_ms in (("A", 20.0), ("B", 10.0)):
        pool.add_voice(name, block_ms=block_ms)
        pool.load_track(name, x)
        pool.start(name, rate=0.25 if name == "B" else 1.0)
    pool.add_voice("L", mode="live", block_ms=10.0)
    pool.render(pool.quantum)
    m = pool.metrics()
    assert len(m["buckets"]) == 3 and m["steps"] == 1
    per = [b.pool.metrics() for b in pool.buckets.values()]
    assert m["bucket_counters"] == {k: sum(p.get(k, 0) for p in per) for k in COUNTERS}
    assert m["bucket_counters"]["audio_uploads"] == 2
    assert m["bucket_counters"]["minstd_steps"] >= 1
    assert m["bucket_counters"]["steps"] >= 3
    assert m["table_builds"] == table_builds()
