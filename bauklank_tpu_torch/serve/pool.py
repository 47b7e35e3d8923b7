"""StreamPool: many voices, one batched device step per pool step.

Port of ``bauklank_tpu/serve/pool.py`` for both engines: ``"fast"`` (the
default; the hop-parallel engine of ``engine/core.py``) and
``"fidelity"`` (the blob-exact core).  All voices share one engine
configuration, one device step and one mixdown; per-voice rate/pitch
state is data.  Control semantics mirror the
reference app's ``applyIncomingSet``: control keys route into each
voice's time map with a look-ahead (0.1 s); volume/pan ramp linearly
over the step; clamps follow the reference (rate [1e-5, 2], semitones
±48, tonalityHz [20, 22050], formantBaseHz [0, 2000]).

Per step the host builds one packed ``[S, H + 11]`` float32 array (frame
ends, the seven StretchParams fields, gain and pan ramps) and copies it
to the device once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from bauklank_tpu_torch.engine.batched import (
    batched_process_chunk,
    formants_off,
    init_batched_state,
)
from bauklank_tpu_torch.engine.config import StretchConfig, preset_default
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    batched_fidelity_chunk,
    init_batched_fidelity_state,
)
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.schedule.timemap import TimeMap
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import StepTimer

__all__ = ["StreamPool", "VoiceSlot", "CONTROL_CLAMPS"]

SCHEDULE_LOOKAHEAD_SEC = 0.1  # reference: app/multi/app.mjs:494

CONTROL_CLAMPS = {
    "rate": (1e-5, 2.0),          # app/multi/app.mjs:483
    "semitones": (-48.0, 48.0),   # :484
    "tonalityHz": (20.0, 22050.0),
    "formantSemitones": (-48.0, 48.0),
    "formantBaseHz": (0.0, 2000.0),  # 0 = auto-detect stays allowed
}

_TIMEMAP_KEYS = {
    "active", "rate", "semitones", "tone", "tonalityHz", "formantSemitones",
    "formantCompensation", "formantBaseHz", "loopStart", "loopEnd",
    # playback-slider seek: the reference drag handler schedules {input: v}
    "input",
}

# keys whose values must be finite numbers (everything except the booleans)
_NUMERIC_KEYS = (_TIMEMAP_KEYS | {"volume", "volumePercent", "pan"}) - {
    "active", "formantCompensation",
}


@dataclasses.dataclass
class VoiceSlot:
    name: str
    timemap: TimeMap = dataclasses.field(default_factory=TimeMap)
    volume: float = 0.1      # kiosk default (app/multi/app.mjs:106-130)
    pan: float = 0.0
    _prev_volume: float = 0.1
    _prev_pan: float = 0.0
    track_len: int = 0
    loaded: bool = False


def _mixdown(out, gains, pans):
    """Linear per-step mix ramp + stereo mixdown (reference graph gain ->
    panL/panR -> ChannelMerger).  out [S, C, n], gains/pans [S, 2]."""
    n = out.shape[-1]
    t = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=out.device)[None, :]
    g = gains[:, :1] + (gains[:, 1:] - gains[:, :1]) * t      # [S, n]
    p = pans[:, :1] + (pans[:, 1:] - pans[:, :1]) * t          # [S, n]
    mono = torch.mean(out, dim=1)                              # [S, n]
    pan_l = torch.clamp_max(1.0 - p, 1.0)
    pan_r = torch.clamp_max(1.0 + p, 1.0)
    return torch.stack([torch.sum(mono * g * pan_l, dim=0),
                        torch.sum(mono * g * pan_r, dim=0)])


def _pool_step(config: StretchConfig, states, audios, packed):
    """One fast-engine pool step from the packed ``[S, H + 11]`` array:
    [:H] frame ends, [H:H+7] StretchParams fields, [H+7:H+9] gain (start,
    end), [H+9:H+11] pan (start, end).  Returns (states, master [2, n],
    streams [S, C, n])."""
    h = packed.shape[1] - 11
    ends = packed[:, :h].to(torch.int32)
    params = StretchParams.unpack(packed, h)
    states, out = batched_process_chunk(config, states, audios, ends, params)
    return states, _mixdown(out, packed[:, h + 7: h + 9], packed[:, h + 9: h + 11]), out


def _pool_step_fidelity(scfg: SpectralConfig, states, audios, packed,
                        deterministic: bool | None = None):
    """One fidelity pool step from the same packed layout as
    :func:`_pool_step`.  With ``scfg.formants`` the packed formant fields
    drive the blob's step 5 per stream.  ``deterministic``: the host's
    word that every voice is at time factor <= 2 (:func:`_deterministic`)."""
    h = packed.shape[1] - 11
    ends = packed[:, :h].to(torch.int32)
    params = StretchParams.unpack(packed, h)
    # blob seek law: the effective timeFactor saturates at `interval` when
    # the rate advances < 1 input sample per hop
    tf = torch.clamp_max(1.0 / torch.clamp_min(params.rate, 1e-6), float(scfg.interval))
    limit = params.tonality / torch.sqrt(params.transpose_factor)
    formants = ((params.formant_factor, params.formant_compensation, params.formant_base)
                if scfg.formants else (None, None, None))
    states, out = batched_fidelity_chunk(
        scfg, states, audios, ends, tf, params.transpose_factor, limit, params.active,
        *formants, deterministic=deterministic)
    return states, _mixdown(out, packed[:, h + 7: h + 9], packed[:, h + 9: h + 11]), out


def _deterministic(rates: np.ndarray, interval: int) -> bool:
    """Whether every voice's time factor, as :func:`_pool_step_fidelity`
    computes it on the device from the packed float32 rates, is <= 2 (the
    deterministic regime): the same float32 operations on the host, so the
    step need not wait for the device to learn its regime."""
    tf = np.minimum(np.float32(1.0) / np.maximum(rates, np.float32(1e-6)),
                    np.float32(interval))
    return bool(np.all(tf <= np.float32(2.0)))


class StreamPool:
    """Fixed-capacity batched voice pool on one device.

    Slots are named (defaults "s00"..., or pass ``names``).  ``engine``:
    "fast" (hop-parallel, ``engine/core.py``) or "fidelity" (blob-exact,
    ``engine/spectral.py``).  It runs on
    ``device``, the card unless the caller passes another."""

    def __init__(
        self,
        capacity: int = 64,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        max_track_sec: float = 30.0,
        names: list[str] | None = None,
        hops_per_step: int = 1,
        engine: str = "fast",
        max_rate: float = 2.0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if engine not in ("fast", "fidelity"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.device = resolve_device(device)
        self.clamps = dict(CONTROL_CLAMPS)
        self.clamps["rate"] = (CONTROL_CLAMPS["rate"][0], float(max_rate))
        self.sample_rate = float(sample_rate)
        self.config = config or preset_default(channels, sample_rate)
        if engine == "fidelity":
            # a given StretchConfig has its block already rounded onto the
            # FFT grid (engine/config.py); taken as it is, for parity with
            # the JAX pool (ROADMAP "Faults found")
            block = round(sample_rate * 0.12) if config is None else config.block
            interval = round(sample_rate * 0.03) if config is None else config.interval
            self.scfg = SpectralConfig(channels, block, interval,
                                       split=self.config.split_computation)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.max_track = int(max_track_sec * sample_rate)
        # frame-end sample indices ride the packed float32 array; float32
        # is integer-exact only below 2**24 (~380 s at 44.1 kHz)
        if self.max_track + self.config.block >= 2**24:
            raise ValueError(
                f"max_track_sec={max_track_sec} exceeds float32-exact frame "
                f"positioning (track + block must stay < 2**24 samples)"
            )
        self.slots = [VoiceSlot(names[i] if names else f"s{i:02d}") for i in range(capacity)]
        self._by_name = {s.name: i for i, s in enumerate(self.slots)}
        self._audio_host = np.zeros((capacity, channels, self.max_track), np.float32)
        self._audio_dev: torch.Tensor | None = None
        self.states = self._init_states(capacity)
        self.out_pos = 0  # output samples stepped so far
        self.timer = StepTimer(sample_rate)

    # ------------------------------------------------------------- loading
    def load_track(self, slot: str, channel_arrays) -> int:
        i = self._by_name[slot]
        arrs = [np.asarray(a, np.float32) for a in channel_arrays]
        n = min(arrs[0].shape[0], self.max_track)
        c = self._audio_host.shape[1]
        self._audio_host[i] = 0.0
        for ch in range(c):
            self._audio_host[i, ch, :n] = arrs[ch % len(arrs)][:n]
        self.slots[i].track_len = n
        self.slots[i].loaded = True
        self._audio_dev = None
        return n

    def drop_track(self, slot: str) -> None:
        i = self._by_name[slot]
        self._audio_host[i] = 0.0
        self.slots[i].track_len = 0
        self.slots[i].loaded = False
        self._audio_dev = None

    # -------------------------------------------------- slot lifecycle
    def _init_states(self, n: int):
        if self.engine == "fidelity":
            return init_batched_fidelity_state(self.scfg, n, self.device)
        return init_batched_state(self.config, n, self.device)

    def _leaves(self, states) -> tuple:
        if self.engine == "fidelity":
            spec, tail = states
            return (*spec, tail)
        return tuple(states)

    def clear_voice(self, slot: str) -> None:
        """Fully reset one voice (engine state, audio, time map, mix) so its
        batch row can be reused."""
        i = self._by_name[slot]
        self._audio_host[i] = 0.0
        self._audio_dev = None
        self.slots[i] = VoiceSlot(slot)
        for leaf, fresh in zip(self._leaves(self.states), self._leaves(self._init_states(1))):
            leaf[i] = fresh[0]

    def _device_audio(self) -> torch.Tensor:
        if self._audio_dev is None:
            self._audio_dev = torch.from_numpy(self._audio_host).to(self.device)
        return self._audio_dev

    # ------------------------------------------------------------- control
    @property
    def _sizes(self):
        """(block, interval, output_latency) of the pool's engine."""
        if self.engine == "fidelity":
            b, i = self.scfg.block, self.scfg.interval
            return b, i, (b - b // 2) + (i if self.scfg.split else 0)
        c = self.config
        return c.block, c.interval, c.output_latency

    @property
    def output_time(self) -> float:
        return self.out_pos / self.sample_rate + self._sizes[2] / self.sample_rate

    def apply_set(self, slot: str, key: str, value: Any,
                  lookahead: float = SCHEDULE_LOOKAHEAD_SEC) -> bool:
        """Route one control change (the ``set`` message) to a voice.

        Returns False for unknown slots/keys or malformed values: values
        arrive from unauthenticated JSON, where NaN/Infinity and nulls are
        representable, so non-finite and non-numeric values are rejected
        rather than clamped."""
        if slot not in self._by_name:
            return False
        s = self.slots[self._by_name[slot]]
        if key in _NUMERIC_KEYS:
            try:
                value = float(value)
            except (TypeError, ValueError):
                return False
            if not math.isfinite(value):
                return False
        if key in ("volume", "volumePercent"):
            v = value / (100.0 if key == "volumePercent" else 1.0)
            s.volume = float(np.clip(v, 0.0, 1.0))
            return True
        if key == "pan":
            s.pan = float(np.clip(value, -1.0, 1.0))
            return True
        if key not in _TIMEMAP_KEYS:
            return False
        if key == "input" and s.track_len > 0:
            # the reference slider clamps the seek to [0, duration]
            value = float(np.clip(value, 0.0, s.track_len / self.sample_rate))
        if key in self.clamps or key == "tone":
            lo, hi = self.clamps.get("semitones" if key == "tone" else key, (None, None))
            if lo is not None:
                value = float(np.clip(value, lo, hi))
        s.timemap.schedule({key: value, "output": self.output_time + lookahead})
        return True

    def schedule(self, slot: str, obj: dict, adjust_previous: bool = False):
        return self.slots[self._by_name[slot]].timemap.schedule(obj, adjust_previous)

    def start(self, slot: str, when: float | None = None, **kw) -> None:
        self.slots[self._by_name[slot]].timemap.start(
            self.output_time if when is None else when, **kw)

    def stop(self, slot: str, when: float | None = None) -> None:
        self.slots[self._by_name[slot]].timemap.stop(
            self.output_time if when is None else when)

    def input_time(self, slot: str) -> float:
        return self.slots[self._by_name[slot]].timemap.input_time_at(self.output_time)

    def is_playing(self, slot: str) -> bool:
        if slot not in self._by_name:
            return False
        s = self.slots[self._by_name[slot]]
        return s.loaded and bool(s.timemap.current().active)

    # --------------------------------------------------------------- step
    def _packed(self) -> np.ndarray:
        """Host side of a step: each voice's hop frame ends, params and mix
        ramps, in one [S, H + 11] float32 array.  The fidelity engine's
        worklet drive samples inputTime at the hop's output-counter
        position, the fast engine at the output frame's centre."""
        sr = self.sample_rate
        h = self.hops_per_step
        block, interval, out_lat = self._sizes
        centre = 0 if self.engine == "fidelity" else block // 2
        packed = np.zeros((self.capacity, h + 11), np.float32)
        for i, s in enumerate(self.slots):
            seg = None
            for k in range(h):
                out_t = (self.out_pos + k * interval + centre) / sr + out_lat / sr
                in_t = s.timemap.input_time_at(out_t)
                packed[i, k] = float(int(round(in_t * sr)) + block // 2)
                seg = s.timemap.current()
            packed[i, h: h + 7] = (
                1.0 if (seg.active and s.loaded) else 0.0,
                seg.rate,
                2.0 ** (seg.semitones / 12.0),
                seg.tonality_hz / sr,
                2.0 ** (seg.formant_semitones / 12.0),
                1.0 if seg.formant_compensation else 0.0,
                seg.formant_base_hz / sr,
            )
            packed[i, h + 7: h + 9] = (s._prev_volume, s.volume)
            packed[i, h + 9: h + 11] = (s._prev_pan, s.pan)
            s._prev_volume = s.volume
            s._prev_pan = s.pan
        return packed

    def step(self, fetch: bool = False):
        """Render the next chunk for every voice.

        Returns (master [2, n], streams [S, C, n]); n = hops_per_step *
        interval.  With ``fetch=True`` the master mix is copied to numpy,
        which waits for the device work (honest latency accounting)."""
        if fetch == "pipeline":
            raise NotImplementedError(
                'fetch="pipeline" is not ported yet (ROADMAP queue 1, pool slice)')
        self.timer.start()
        h = self.hops_per_step
        with record_function("pool.pack"):
            packed = self._packed()
        formants = bool(np.any(packed[:, h + 4] != 1.0) or np.any(packed[:, h + 5] != 0.0))
        dev_packed = torch.from_numpy(packed).to(self.device)
        if self.engine == "fidelity":
            # host-side formant gating, as below: the formant chain runs
            # only in a step where some voice uses a formant control
            scfg = self.scfg._replace(formants=True) if formants else self.scfg
            self.states, master, streams = _pool_step_fidelity(
                scfg, self.states, self._device_audio(), dev_packed,
                _deterministic(packed[:, h + 1], scfg.interval))
        else:
            # host-side formant gating: when no voice uses formant controls
            # this step, run the step without the formant chain (same state;
            # the reference engine gates the same way)
            cfg = self.config
            if cfg.formants and not formants:
                cfg = formants_off(cfg)
            self.states, master, streams = _pool_step(
                cfg, self.states, self._device_audio(), dev_packed)
        self.out_pos += h * self._sizes[1]
        self._last_streams = streams
        if fetch:
            master = master.cpu().numpy()
        self.timer.tick(self.capacity * h * self._sizes[1])
        return master, streams

    def metrics(self) -> dict:
        """Rolling serving metrics: step p50/p99 latency + aggregate RTF."""
        return self.timer.snapshot()
