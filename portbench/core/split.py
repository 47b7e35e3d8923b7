"""Two readings of a ``torch.profiler`` trace beside ``core/trace.py``'s,
from the same raw events and the same window (the first ``bench.step``
range's start to the last one's end):

- ``idle_split``: each idle stretch of the device split over the
  innermost host ranges of the main thread that held it, moment by
  moment.  ``trace.reduce``'s ``idle_by_range`` charges a whole stretch
  to the range open when it began; a stretch that begins in
  ``pool.fetch`` and runs on through ``bench.set`` into the next step's
  ``pool.pack`` is here shared by all three.
- ``device_n``: the device operations (kernels, copies, sets) charged to
  each range, counted: the innermost range open on the launching thread
  at the launch, as ``trace.reduce`` charges their time.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

from portbench.core.trace import _innermost, _nest, _union

PROGRAM = ("pool.", "fidelity.", "fast.")


@dataclasses.dataclass
class Split:
    steps: int
    window_s: float
    busy_s: float
    host_s: dict                     # range name -> summed host seconds
    idle_split: dict                 # innermost main-thread range -> idle seconds
    device_n: dict                   # innermost launching range -> device operations

    def pool_idle_pct(self) -> float:
        """The window's share, in %, in which the device ran nothing while
        the main thread's innermost range was one of the pool's."""
        idle = sum(s for n, s in self.idle_split.items() if n.startswith("pool."))
        return 100.0 * idle / self.window_s

    def launches_per_step(self) -> float:
        """Device operations a step launched from the program's ranges."""
        return sum(c for n, c in self.device_n.items() if n.startswith(PROGRAM)) / self.steps


def idle_split(ranges, busy, w0: int, w1: int) -> dict:
    """Idle seconds of ``[w0, w1)`` outside ``busy`` (sorted disjoint
    ``[start, end]`` intervals inside the window), by the innermost of
    ``ranges`` (one thread's, from ``_nest``) at each moment;
    ``"(no range)"`` where none is open.  Times in ns."""
    starts = [r[0] for r in ranges]
    cuts = sorted({t for s, e, _, _ in ranges for t in (s, e) if w0 < t < w1})
    out: dict = {}

    def charge(a, b):
        where = _innermost(ranges, starts, a) or "(no range)"
        out[where] = out.get(where, 0.0) + (b - a) * 1e-9

    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        for c in cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]:
            charge(a, c)
            a = c
        charge(a, b)
    return out


def split(prof, step_range: str = "bench.step") -> Split:
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges_by_thread: dict = {}
    ops, runtime = {}, {}
    device = []
    host_s: dict = {}
    for e in events:
        name, t0, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((t0, t0 + dur, e.linked_correlation_id(), e.correlation_id()))
            continue
        if e.is_user_annotation():
            ranges_by_thread.setdefault(e.start_thread_id(), []).append((t0, t0 + dur, name))
            host_s[name] = host_s.get(name, 0.0) + dur * 1e-9
        if e.correlation_id():
            # as in trace.reduce: a device operation links to its host op,
            # or shares its correlation id with the runtime's launch call
            table = runtime if name.startswith("cu") else ops
            table[e.correlation_id()] = (t0, e.start_thread_id())
    ranges_by_thread = {tid: _nest(r) for tid, r in ranges_by_thread.items()}
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges_by_thread.items()}
    steps = [r for rs in ranges_by_thread.values() for r in rs if r[2] == step_range]
    if not steps:
        raise RuntimeError(f"the trace holds no {step_range!r} range")
    w0, w1 = min(r[0] for r in steps), max(r[1] for r in steps)

    device_n: dict = {}
    inside = []
    for s, e, linked, corr in device:
        if e <= w0 or s >= w1:
            continue
        inside.append((max(s, w0), min(e, w1)))
        where = None
        launch = ops.get(linked) or runtime.get(corr)
        if launch is not None and launch[1] in ranges_by_thread:
            tid = launch[1]
            where = _innermost(ranges_by_thread[tid], starts[tid], launch[0])
        where = where or "(no range)"
        device_n[where] = device_n.get(where, 0) + 1
    busy = _union(inside)
    main = max(ranges_by_thread, key=lambda tid: len(ranges_by_thread[tid]))
    return Split(len(steps), (w1 - w0) * 1e-9, sum(e - s for s, e in busy) * 1e-9, host_s,
                 idle_split(ranges_by_thread[main], busy, w0, w1), device_n)
