"""``core/split.py`` on a synthetic trace of two steps with nested host
ranges and device operations: the idle split sums to the window less the
busy time and shares a gap among every range it runs through; the
launches are counted by range; ``core/trace.py``'s reduction of the same
trace reads as it always has (a gap charged whole to the range open at
its start)."""

from __future__ import annotations

import types

import pytest
import torch

from conftest import REPO  # noqa: F401  (puts the checkout on the path)
from portbench.core import split as split_mod
from portbench.core import trace as trace_mod

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1000                                  # ns


class _Event:
    def __init__(self, name, start, end, device=CPU, annotation=False, tid=1, corr=0,
                 linked=0):
        self._v = (name, start * US, (end - start) * US, device, annotation, tid, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


def _range(name, start, end, tid=1):
    return _Event(name, start, end, annotation=True, tid=tid)


def _launch(corr, at, start, end, kernel="k"):
    """A host op at ``at`` and the device operation it launched."""
    return [_Event("aten::mul", at, at + 1, corr=corr),
            _Event(kernel, start, end, device=CUDA, linked=corr)]


def _timeline():
    """Two steps, in microseconds.  Step one's device work runs to 90,
    inside ``pool.fetch``; the device then idles through the rest of the
    fetch, ``bench.set`` between the steps and into step two's
    ``pool.pack`` (90 -> 125).  Busy: 22-90, 125-180, 181-190."""
    ev = [
        _range("bench.step", 0, 100), _range("pool.step", 1, 99),
        _range("pool.pack", 2, 20), _range("fidelity.analyse", 25, 40),
        _range("pool.fetch", 45, 98),
        _range("bench.set", 100, 110),
        _range("bench.step", 110, 200), _range("pool.step", 111, 199),
        _range("pool.pack", 112, 130), _range("fidelity.analyse", 135, 150),
        _range("pool.fetch", 150, 198),
        _range("other.thread", 0, 200, tid=2),
    ]
    ev += _launch(1, 21, 22, 30) + _launch(2, 26, 30, 60) + _launch(3, 41, 60, 90)
    ev += _launch(4, 124, 125, 140) + _launch(5, 136, 140, 180)
    ev += _launch(6, 101, 181, 185)                           # from the harness's bench.set
    ev.append(_Event("cudaLaunchKernel", 137, 138, corr=7))  # a launch bound with ctypes
    ev.append(_Event("kernel7", 185, 190, device=CUDA, corr=7))
    return ev


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


# idle: 0-22, 90-125, 180-181, 190-200, moment by moment
IDLE_SPLIT = {"bench.step": 4, "pool.step": 3 + 1 + 1 + 1, "pool.pack": 18 + 13,
              "pool.fetch": 8 + 1 + 8, "bench.set": 10}


def test_idle_split_shares_a_gap_among_every_range_it_spans():
    sp = split_mod.split(_prof(_timeline()))
    assert sp.steps == 2 and sp.window_s == pytest.approx(200e-6)
    assert sp.busy_s == pytest.approx((68 + 55 + 9) * 1e-6)
    assert sum(sp.idle_split.values()) == pytest.approx(sp.window_s - sp.busy_s, abs=1e-6)
    assert sp.idle_split.keys() == IDLE_SPLIT.keys()
    for name, us in IDLE_SPLIT.items():
        assert sp.idle_split[name] == pytest.approx(us * 1e-6, abs=1e-12), name
    assert sp.pool_idle_pct() == pytest.approx(100 * (6 + 31 + 17) / 200)


def test_device_operations_are_counted_by_their_launching_range():
    sp = split_mod.split(_prof(_timeline()))
    assert sp.device_n == {"pool.step": 2, "fidelity.analyse": 3, "pool.pack": 1,
                           "bench.set": 1}
    assert sp.launches_per_step() == 3.0


def test_trace_reduction_of_the_same_trace_reads_as_before():
    """``trace.reduce`` charges each gap whole to the range open at its
    start: the gap of 90 -> 125 to ``pool.fetch``."""
    tr = trace_mod.reduce(_prof(_timeline()))
    sp = split_mod.split(_prof(_timeline()))
    assert (tr.steps, tr.window_s, tr.busy_s) == (sp.steps, sp.window_s, sp.busy_s)
    assert tr.host_s == sp.host_s
    assert [n for n, _ in tr.idle_by_range] == ["pool.fetch", "bench.step"]
    idle = dict(tr.idle_by_range)
    assert idle["pool.fetch"] == pytest.approx((35 + 1 + 10) * 1e-6)
    assert idle["bench.step"] == pytest.approx(22e-6)
    assert tr.device_ms("pool.") == pytest.approx((8 + 30 + 15) * 1e-6 / 2 * 1e3)
    assert tr.device_s["bench.set"] == pytest.approx(4e-6)
    assert tr.host_ms("pool.step") == pytest.approx((98 + 88) * 1e-6 / 2 * 1e3)
    assert tr.kernel("kernel7") == (pytest.approx(5e-6), 1)
