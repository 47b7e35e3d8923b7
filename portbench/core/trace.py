"""Reduce a ``torch.profiler`` trace of a stretch of steps, in memory.

From the profiler's raw events: the host ranges (``record_function``,
the program's and the harness's ``bench.step`` / ``bench.set``), the
device operations (kernels, copies, sets), and the host op or range each
device operation was launched from, linked to it by the profiler's
correlation id.  Each device
operation is charged to the innermost host range open on its launching
thread when it was launched; each idle stretch of the device to the
innermost range open when it began.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float                  # first traced step's start to the last one's end
    busy_s: float                    # union of device operations inside the window
    host_s: dict                     # range name -> summed host seconds
    device_s: dict                   # innermost range name -> device seconds launched in it
    kernels: dict                    # device op name -> [seconds, count]
    top_ops: list                    # [[range/op, seconds], ...] most time first
    idle_by_range: list              # [[range, idle seconds], ...] most idle first

    def host_ms(self, prefix: str) -> float | None:
        hit = [s for n, s in self.host_s.items() if n.startswith(prefix)]
        return sum(hit) / self.steps * 1e3 if hit else None

    def device_ms(self, prefix: str) -> float | None:
        hit = [s for n, s in self.device_s.items() if n.startswith(prefix)]
        return sum(hit) / self.steps * 1e3 if hit else None

    def kernel(self, fragment: str):
        """(seconds, launches) of the device ops whose name holds ``fragment``."""
        hit = [v for n, v in self.kernels.items() if fragment in n]
        if not hit:
            return None
        return sum(s for s, _ in hit), sum(c for _, c in hit)


def _innermost(ranges, starts, t):
    """The name of the innermost range of ``ranges`` ((start, end, name,
    depth), sorted by start, properly nested) that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name, depth = ranges[i]
        if e > t:
            return name
        if depth == 0:
            return None      # no earlier range reaches past a closed outermost one
        i -= 1
    return None


def _nest(ranges):
    """Sort ranges by start (outer first) and give each its depth."""
    out, stack = [], []
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1] <= s:
            stack.pop()
        out.append((s, e, name, len(stack)))
        stack.append(e)
    return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, step_range: str = "bench.step", top: int = 10) -> Trace:
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
                device.append((t0, t0 + dur, name, e.linked_correlation_id(),
                               e.correlation_id()))
            continue
        if e.is_user_annotation():
            ranges_by_thread.setdefault(e.start_thread_id(), []).append((t0, t0 + dur, name))
            host_s[name] = host_s.get(name, 0.0) + dur * 1e-9
        if e.correlation_id():
            # a device operation links to the host op it was launched from;
            # one launched outside any op (the kernels bound with ctypes)
            # shares its correlation id with the runtime's launch call
            table = runtime if name.startswith("cu") else ops
            table[e.correlation_id()] = (t0, e.start_thread_id())
    ranges_by_thread = {tid: _nest(r) for tid, r in ranges_by_thread.items()}
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges_by_thread.items()}
    steps = [r for rs in ranges_by_thread.values() for r in rs if r[2] == step_range]
    if not steps:
        raise RuntimeError(f"the trace holds no {step_range!r} range")
    w0, w1 = min(r[0] for r in steps), max(r[1] for r in steps)

    device_s: dict = {}
    kernels: dict = {}
    by_op: dict = {}
    inside = []
    for s, e, name, linked, corr in device:
        if e <= w0 or s >= w1:
            continue
        inside.append((max(s, w0), min(e, w1)))
        sec = (e - s) * 1e-9
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += sec
        k[1] += 1
        where = None
        launch = ops.get(linked) or runtime.get(corr)
        if launch is not None:
            lt, tid = launch
            if tid in ranges_by_thread:
                where = _innermost(ranges_by_thread[tid], starts[tid], lt)
        where = where or "(no range)"
        device_s[where] = device_s.get(where, 0.0) + sec
        key = f"{where}/{name[:80]}"
        by_op[key] = by_op.get(key, 0.0) + sec
    busy = _union(inside)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    # idle stretches: before, between and after the device's busy intervals
    main = max(ranges_by_thread, key=lambda tid: len(ranges_by_thread[tid]))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            where = _innermost(ranges_by_thread[main], starts[main], a) or "(no range)"
            idle[where] = idle.get(where, 0.0) + (b - a) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return Trace(len(steps), (w1 - w0) * 1e-9, busy_s, host_s, device_s, kernels,
                 rank(by_op), rank(idle))
