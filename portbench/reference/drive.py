"""The host side of a pool step, worked out again from the traffic.

Plain Python, NumPy and PyTorch, importing nothing of the program.  From the
``set``s the benchmark sent (which step they came before, which voice,
key and value, with what look-ahead) it replays each voice's time map
as the serving pool keeps one, and gives for any step each voice's
analysis frame ends, its controls and its mix ramps.  The rules are those
of the reference app's scheduler (SURVEY.md section 2.6): a ``set``
inserts a segment at the output time it names, inheriting the controls
it does not set from the segment it replaces or the last one before it,
with its input time extrapolated at the previous segment's rate (0 while
inactive); the playhead drops passed segments and wraps once into the
loop when it reaches the loop's end.  The formant controls
(``formantSemitones``, ``formantCompensation``, ``formantBaseHz``) are
fields of the time map like the others, with the program's defaults (0,
off, 0 = detect the base) and clamps, and are given for each voice as the
program packs them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# control keys of the wire protocol and their segment fields
_FIELDS = {"rate": "rate", "semitones": "semitones", "tone": "semitones",
           "tonalityHz": "tonality_hz", "loopStart": "loop_start", "loopEnd": "loop_end",
           "active": "active", "input": "input", "formantSemitones": "formant_semitones",
           "formantCompensation": "formant_compensation", "formantBaseHz": "formant_base_hz"}
_CLAMPS = {"rate": (1e-5, 2.0), "semitones": (-48.0, 48.0), "tone": (-48.0, 48.0),
           "tonalityHz": (20.0, 22050.0), "formantSemitones": (-48.0, 48.0),
           "formantBaseHz": (0.0, 2000.0)}
# the wire keys of the formant controls: a reference replays them only
# where it declares ``FORMANTS``
FORMANT_KEYS = ("formantSemitones", "formantCompensation", "formantBaseHz")


@dataclasses.dataclass
class _Seg:
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


class _Voice:
    def __init__(self, track_sec: float):
        self.segs = [_Seg()]
        self.volume, self.pan = 0.1, 0.0
        self.prev_volume, self.prev_pan = 0.1, 0.0
        self.track_sec = track_sec

    def schedule(self, field: str, value, out_t: float) -> None:
        segs = self.segs
        latest = segs[-1]
        while len(segs) > 1 and segs[-1].output >= out_t:
            latest = segs.pop()
        if segs[-1].output >= out_t and len(segs) == 1:
            latest = segs[0]
        new = dataclasses.replace(latest)
        setattr(new, field, type(getattr(_Seg(), field))(value))
        new.output = out_t
        prev = segs[-1]
        if field != "input":
            new.input = prev.input + (out_t - prev.output) * (prev.rate if prev.active else 0.0)
        if segs[-1].output >= out_t:
            segs[-1] = new
        else:
            segs.append(new)

    def input_time_at(self, t_out: float) -> float:
        segs = self.segs
        while len(segs) > 1 and segs[1].output <= t_out:
            segs.pop(0)
        seg = segs[0]
        t = seg.input + (t_out - seg.output) * (seg.rate if seg.active else 0.0)
        loop_len = seg.loop_end - seg.loop_start
        if loop_len > 0 and t >= seg.loop_end:
            seg.input -= loop_len
            t -= loop_len
        return t


def _set(v: _Voice, key: str, value, out_time: float, lookahead: float) -> None:
    """One ``set`` as the pool takes it: volume and pan at once, the rest
    into the time map at the output time plus the look-ahead."""
    if key in ("volume", "pan"):
        lo = 0.0 if key == "volume" else -1.0
        setattr(v, key, float(np.clip(float(value), lo, 1.0)))
        return
    if key != "active":
        value = float(value)
    if key == "input":
        value = float(np.clip(value, 0.0, v.track_sec))
    if key in _CLAMPS:
        value = float(np.clip(value, *_CLAMPS[key]))
    v.schedule(_FIELDS[key], value, out_time + lookahead)


CONTROLS = ("rate", "semitones", "tonality_hz", "active", "formant_factor",
            "formant_compensation", "formant_base")


def _controls(seg: _Seg, sr: float) -> dict:
    """A segment's controls as a step takes them (``CONTROLS``)."""
    return dict(rate=seg.rate, semitones=seg.semitones, tonality_hz=seg.tonality_hz,
                active=float(seg.active), formant_factor=2.0 ** (seg.formant_semitones / 12.0),
                formant_compensation=1.0 if seg.formant_compensation else 0.0,
                formant_base=seg.formant_base_hz / sr)


def replay(geo, n_voices: int, hops: int, track_sec: float, sets, wanted):
    """Each wanted step's host side.  ``sets``: (step, voice, key, value,
    lookahead) in the order they were sent, each before its step; ``geo``
    carries sample_rate, interval, out_lat, centre and block.  Returns
    {step: dict(ends [S, H] int64, rate, semitones, tonality_hz, active,
    formant_factor (2^(st/12)), formant_compensation (1 or 0),
    formant_base (Hz over the sample rate), gains [S, 2], pans [S, 2])}."""
    sr, interval, block = geo.sample_rate, geo.interval, geo.block
    last = max(wanted)
    by_voice = [[] for _ in range(n_voices)]
    for st, voice, key, value, la in sets:
        by_voice[voice].append((st, key, value, la))
    out = {k: dict(ends=np.zeros((n_voices, hops), np.int64),
                   gains=np.zeros((n_voices, 2)), pans=np.zeros((n_voices, 2)),
                   **{c: np.zeros(n_voices) for c in CONTROLS})
           for k in wanted}
    for s in range(n_voices):
        v = _Voice(track_sec)
        events = by_voice[s]
        j = 0
        for k in range(last + 1):
            out_pos = k * hops * interval
            while j < len(events) and events[j][0] <= k:
                _, key, value, la = events[j]
                _set(v, key, value, out_pos / sr + geo.out_lat / sr, la)
                j += 1
            ends = [int(round(v.input_time_at((out_pos + h * interval + geo.centre) / sr
                                              + geo.out_lat / sr) * sr)) + block // 2
                    for h in range(hops)]
            seg = v.segs[0]
            if k in out:
                o = out[k]
                o["ends"][s] = ends
                for c, value in _controls(seg, sr).items():
                    o[c][s] = value
                o["gains"][s] = (v.prev_volume, v.volume)
                o["pans"][s] = (v.prev_pan, v.pan)
            v.prev_volume, v.prev_pan = v.volume, v.pan
    return out


def mixdown(streams, gains, pans):
    """streams [S, C, n] (a float64 tensor) with each voice's gain and pan
    ramped linearly over the step -> the stereo master [2, n]."""
    n = streams.shape[-1]
    t = torch.linspace(0.0, 1.0, n, dtype=streams.dtype, device=streams.device)[None]
    g = gains[:, :1] + (gains[:, 1:] - gains[:, :1]) * t
    p = pans[:, :1] + (pans[:, 1:] - pans[:, :1]) * t
    mono = streams.mean(dim=1)
    return torch.stack([(mono * g * torch.clamp_max(1.0 - p, 1.0)).sum(0),
                        (mono * g * torch.clamp_max(1.0 + p, 1.0)).sum(0)])
