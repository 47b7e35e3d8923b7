"""The time-map scheduler: piecewise-linear output-time -> input-time.

Re-implements the control model of the reference worklet's ``schedule``
machinery (reference: app/SignalsmithStretch.mjs:656-701, advance loop
:840-844, loop wrap :884-889, start/stop sugar :617-654; semantics summary
SURVEY.md §2.6):

- A voice's playback is a list of segments; each segment pins an
  (output time, input time) pair and carries the controls that apply from
  that output time on (rate, semitones, tonality, formant settings, loop
  points, active flag).
- ``schedule`` inserts a new segment: existing segments at/after the new
  output time are removed, the new segment inherits unspecified controls
  from the latest removed (or last remaining) segment, a missing input time
  is extrapolated from the previous segment's rate (rate counts as 0 while
  inactive), and ``adjust_previous`` retro-fits the previous segment's rate
  so input positions meet exactly.
- The renderer advances the map each chunk and evaluates the input time for
  the current output time, wrapping into the loop region when configured.

This is deliberately host-side Python: the map is tiny control state mutated
at human/controller rates; the device only ever sees the per-chunk sampled
(input position, params) tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Segment", "TimeMap"]

# control keys a segment carries (reference initial segment:
# app/SignalsmithStretch.mjs:588-601)
_DEFAULTS = dict(
    active=False,
    input=0.0,
    output=0.0,
    rate=1.0,
    semitones=0.0,
    tonality_hz=8000.0,
    formant_semitones=0.0,
    formant_compensation=False,
    formant_base_hz=0.0,  # 0 = attempt to detect
    loop_start=0.0,
    loop_end=0.0,
)

# accepted aliases for incoming dict keys (camelCase wire names from the
# reference protocol, §2.5)
_ALIASES = {
    "outputTime": "output",
    "inputTime": "input",
    "tonalityHz": "tonality_hz",
    "formantSemitones": "formant_semitones",
    "formantCompensation": "formant_compensation",
    "formantBaseHz": "formant_base_hz",
    "loopStart": "loop_start",
    "loopEnd": "loop_end",
    "tone": "semitones",  # hardware encoder name (app/multi/app.mjs:566-575)
}


@dataclasses.dataclass
class Segment:
    active: bool = False
    input: float = 0.0
    output: float = 0.0
    rate: float = 1.0
    semitones: float = 0.0
    tonality_hz: float = 8000.0
    formant_semitones: float = 0.0
    formant_compensation: bool = False
    formant_base_hz: float = 0.0
    loop_start: float = 0.0
    loop_end: float = 0.0

    def copy(self) -> "Segment":
        return dataclasses.replace(self)


def _normalize(obj: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in obj.items():
        k = _ALIASES.get(k, k)
        if k in _DEFAULTS:
            out[k] = v
    return out


class TimeMap:
    """Per-voice schedule state."""

    def __init__(self) -> None:
        self.segments: list[Segment] = [Segment()]

    # ------------------------------------------------------------------ edit
    def schedule(self, obj: dict[str, Any], adjust_previous: bool = False) -> Segment:
        """Insert a segment at ``obj['output']`` (required).

        Unspecified controls inherit from the latest segment at/after that
        time (which gets removed) or from the last remaining segment.
        Missing ``input`` is extrapolated at the previous segment's rate
        (0 while inactive).
        """
        obj = _normalize(obj)
        out_t = float(obj.get("output", self.segments[-1].output))

        latest = self.segments[-1]
        while len(self.segments) > 1 and self.segments[-1].output >= out_t:
            latest = self.segments.pop()
        if self.segments[-1].output >= out_t and len(self.segments) == 1:
            latest = self.segments[0]

        new = latest.copy()
        for k, v in obj.items():
            setattr(new, k, type(_DEFAULTS[k])(v))
        new.output = out_t

        prev = self.segments[-1]
        if "input" not in obj:
            eff_rate = prev.rate if prev.active else 0.0
            new.input = prev.input + (out_t - prev.output) * eff_rate
        if adjust_previous and prev is not new:
            dt = new.output - prev.output
            if dt > 0:
                prev.rate = (new.input - prev.input) / dt

        if self.segments[-1].output >= out_t:
            # degenerate: replacing the only (initial) segment
            self.segments[-1] = new
        else:
            self.segments.append(new)
        return new

    def start(
        self,
        when: float,
        offset: float = 0.0,
        duration: float | None = None,
        rate: float | None = None,
        semitones: float | None = None,
    ) -> None:
        """Sugar over schedule (reference: app/SignalsmithStretch.mjs:617-646)."""
        seg: dict[str, Any] = {"output": when, "input": offset, "active": True}
        if rate is not None:
            seg["rate"] = rate
        if semitones is not None:
            seg["semitones"] = semitones
        self.schedule(seg)
        if duration is not None:
            self.schedule({"output": when + duration, "active": False})

    def stop(self, when: float) -> None:
        self.schedule({"output": when, "active": False})

    # ----------------------------------------------------------------- query
    def advance_to(self, output_time: float) -> Segment:
        """Drop segments the playhead has passed; return the current one
        (reference advance loop: app/SignalsmithStretch.mjs:840-844)."""
        while len(self.segments) > 1 and self.segments[1].output <= output_time:
            self.segments.pop(0)
        return self.segments[0]

    def input_time_at(self, output_time: float) -> float:
        """Input time for an output time, applying loop wraparound.

        Mutates the current segment's anchor on wrap, like the reference
        (app/SignalsmithStretch.mjs:884-889).
        """
        seg = self.advance_to(output_time)
        t = seg.input + (output_time - seg.output) * (seg.rate if seg.active else 0.0)
        loop_len = seg.loop_end - seg.loop_start
        if loop_len > 0 and t >= seg.loop_end:
            seg.input -= loop_len
            t -= loop_len
        return t

    def current(self) -> Segment:
        return self.segments[0]
