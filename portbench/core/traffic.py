"""The traffic of a cell, from its mix file and the seed.

A mix file gives the pool's width and step (``voices``,
``hops_per_step``), the distributions of each voice's controls at the
start (``initial``: key -> distribution), the mean output time between
one voice's knob turns (``turn_every_s``) and the keys a turn redraws
(``turn_keys``), and the loop.  A distribution is ``{"dist": "uniform" |
"loguniform", "lo": a, "hi": b}``, ``{"dist": "choice", "values": [v, ...]}``
(each value as likely; repeat one to weight it) or ``{"value": v}``.

Turns are placed in each voice's output time, not wall time: a voice
turns at output times drawn from its own stream of the seed, and a turn
is sent before the step that renders that time.  So a seed gives the same
audio however fast the program runs.
"""

from __future__ import annotations

import numpy as np

HORIZON_STEPS = 4096   # turns are drawn this many steps ahead at a time


def _draw(rng: np.random.Generator, dist: dict, n: int | None = None):
    if "value" in dist:
        v = dist["value"]
        return v if n is None else np.full(n, v)
    if dist["dist"] == "choice":
        values = np.asarray(dist["values"], dtype=float)
        return values[rng.integers(len(values), size=n)]
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "loguniform":
        return np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    if dist["dist"] == "uniform":
        return rng.uniform(lo, hi, n)
    raise ValueError(f"unknown distribution {dist!r}")


class Traffic:
    """The sets of one run: ``initial`` before the first step, then
    :meth:`turns` before each later one."""

    def __init__(self, mix: dict, seed: int, step_out_s: float, track_sec: float):
        self.mix = mix
        self.voices = int(mix["voices"])
        self.hops = int(mix["hops_per_step"])
        self.step_out_s = step_out_s
        root = np.random.SeedSequence(int(seed) % 2**128)
        init_ss, self._turn_ss = root.spawn(2)
        rng = np.random.Generator(np.random.PCG64(init_ss))
        loop = mix["loop"]
        loop_end = track_sec - float(loop["end_margin_s"])
        start = _draw(rng, {"dist": "uniform", "lo": loop["start_s"], "hi": loop_end - 1.0},
                      self.voices)
        draws = {k: _draw(rng, d, self.voices) for k, d in mix["initial"].items()}
        # the order matters: "input" goes last, since a set of another key
        # at the same output time takes its input time from the segment before
        self.initial = []
        for v in range(self.voices):
            for k in mix["initial"]:
                self.initial.append((v, k, float(draws[k][v])))
            self.initial += [(v, "loopStart", float(loop["start_s"])),
                             (v, "loopEnd", float(loop_end)),
                             (v, "active", True), (v, "input", float(start[v]))]
        self._rngs = [np.random.Generator(np.random.PCG64(s))
                      for s in self._turn_ss.spawn(self.voices)]
        self._next = np.array([self._gap(v) for v in range(self.voices)])
        self._by_step: dict = {}
        self._drawn_to = 0

    def _gap(self, v: int) -> float:
        return float(self._rngs[v].exponential(self.mix["turn_every_s"]))

    def _extend(self) -> None:
        """Draw every turn of the next HORIZON_STEPS steps, voice by voice."""
        first, last = self._drawn_to, self._drawn_to + HORIZON_STEPS
        end_t = last * self.step_out_s
        keys = self.mix["turn_keys"]
        for v in range(self.voices):
            rng = self._rngs[v]
            while self._next[v] < end_t:
                k = max(1, int(self._next[v] // self.step_out_s))
                key = keys[int(rng.integers(len(keys)))]
                value = float(_draw(rng, self.mix["initial"][key]))
                self._by_step.setdefault(k, []).append((v, key, value))
                self._next[v] += self._gap(v)
        self._drawn_to = last
        for k in range(first, last):
            self._by_step.setdefault(k, [])

    def turns(self, step: int) -> list:
        """The (voice, key, value) sets sent before ``step`` (>= 1)."""
        while step >= self._drawn_to:
            self._extend()
        return self._by_step.pop(step)
