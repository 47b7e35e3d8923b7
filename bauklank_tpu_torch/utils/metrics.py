"""Observability: step timing, real-time factor, late steps, rate
meters, the program's profiler ranges, and the count of constant tables
built.

From ``bauklank_tpu/utils/metrics.py``, without its ``profile_trace``
exporter: the port's ranges (:func:`span`) are read by whoever runs
``torch.profiler`` around the steps.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["StepTimer", "RateMeter", "span", "table_cache", "table_builds", "tables_read"]

_NO_SPAN = contextlib.nullcontext()
_TABLE_CACHES: list = []
_READS = threading.local()      # .into: the list tables_read fills, on this thread


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else a context that does nothing: a range entered
    with no profiler still costs microseconds on the hot path."""
    return record_function(name) if torch._C._autograd._profiler_enabled() else _NO_SPAN


class StepTimer:
    """Rolling per-step latency stats + aggregate real-time factor, and
    the steps that took longer than the audio they render (``late``: an
    underrun where the output plays as it is rendered)."""

    def __init__(self, sample_rate: float, window: int = 512) -> None:
        self.sample_rate = float(sample_rate)
        self.durations = deque(maxlen=window)
        self.samples = deque(maxlen=window)
        self.total_steps = 0
        self.total_samples = 0
        self.late = 0
        self._t0: float | None = None

    def tick(self, out_samples: int, deadline_s: float | None = None) -> float:
        """Record one step that produced ``out_samples`` *per-stream-summed*
        output samples; a step longer than ``deadline_s`` (the seconds of
        audio it renders) counts as late.  Returns its duration."""
        dt = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        self._t0 = None
        self.durations.append(dt)
        self.samples.append(out_samples)
        self.total_steps += 1
        self.total_samples += out_samples
        if deadline_s is not None and dt > deadline_s:
            self.late += 1
        return dt

    def start(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def p50_ms(self) -> float:
        return 1e3 * float(np.percentile(self.durations, 50)) if self.durations else 0.0

    @property
    def p99_ms(self) -> float:
        return 1e3 * float(np.percentile(self.durations, 99)) if self.durations else 0.0

    @property
    def rtf(self) -> float:
        """Aggregate real-time factor over the rolling window."""
        dur = sum(self.durations)
        if dur <= 0:
            return 0.0
        return (sum(self.samples) / dur) / self.sample_rate

    def snapshot(self) -> dict:
        return {
            "steps": self.total_steps,
            "late": self.late,
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "rtf": round(self.rtf, 1),
        }


class RateMeter:
    """Events-per-second meter (the reference UI's msg/s badge)."""

    def __init__(self, window_sec: float = 2.0) -> None:
        self.window = window_sec
        self.stamps: deque[float] = deque()

    def pulse(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.stamps.append(now)
        self._trim(now)

    def rate(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        self._trim(now)
        return len(self.stamps) / self.window

    def _trim(self, now: float) -> None:
        while self.stamps and now - self.stamps[0] > self.window:
            self.stamps.popleft()


def table_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a builder of a constant table
    (windows, twiddles, rotations, MINSTD powers), counted by
    :func:`table_builds`; each table it returns is listed by
    :func:`tables_read` too."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        _TABLE_CACHES.append(cached)

        @functools.wraps(fn)
        def read(*args, **kwargs):
            out = cached(*args, **kwargs)
            into = getattr(_READS, "into", None)
            if into is not None:
                into.append(out)
            return out

        read.cache_info, read.cache_clear = cached.cache_info, cached.cache_clear
        return read
    return wrap


@contextlib.contextmanager
def tables_read(into: list):
    """Append to ``into`` every table that this thread reads from a
    :func:`table_cache` builder inside the block, built or cached."""
    prev = getattr(_READS, "into", None)
    _READS.into = into
    try:
        yield into
    finally:
        _READS.into = prev


def table_builds() -> int:
    """Constant tables built so far in this process, by every pool and
    caller in it: the summed cache misses of the :func:`table_cache`
    builders.  A count that rises while a pool steps means tables built
    (and copied to the device) on the hot path: a geometry or device the
    caches do not hold."""
    return sum(f.cache_info().misses for f in _TABLE_CACHES)
