"""Observability: step timing, real-time factor, rate meters.

Copied from ``bauklank_tpu/utils/metrics.py``; ``profile_trace`` runs
``torch.profiler`` where the JAX module runs ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

__all__ = ["StepTimer", "RateMeter", "profile_trace"]


class StepTimer:
    """Rolling per-step latency stats + aggregate real-time factor."""

    def __init__(self, sample_rate: float, window: int = 512) -> None:
        self.sample_rate = float(sample_rate)
        self.durations = deque(maxlen=window)
        self.samples = deque(maxlen=window)
        self.total_steps = 0
        self.total_samples = 0
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # callers that don't know the sample count use tick() instead
        return False

    def tick(self, out_samples: int) -> float:
        """Record one step that produced ``out_samples`` *per-stream-summed*
        output samples; returns its duration."""
        dt = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        self._t0 = None
        self.durations.append(dt)
        self.samples.append(out_samples)
        self.total_steps += 1
        self.total_samples += out_samples
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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace around a region, written under ``log_dir``
    by the TensorBoard trace handler (``*.pt.trace.json``, also readable in
    Perfetto): the host's ops and, where a CUDA device is visible, the
    card's kernels."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
