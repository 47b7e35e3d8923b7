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
to the device once.  The geometry, the rows, the formant gate and the
regime word are the engine's drive (``engine/drive.py``), which the node
and the live pool share.

While a profiler records, :meth:`StreamPool.step` runs under a
``pool.step`` range (``utils.metrics.span``), and inside it
``pool.pack`` (the packed array), the engine's own ranges (``fast.*`` or
``fidelity.*``) and ``pool.fetch`` (the wait for the device and the
master's copy to the host; also around :meth:`drain`); the packed
array's copy, the tracks' copy and the mixdown are ``pool.step``'s own.
:meth:`StreamPool.metrics` carries the pool's counters beside the step
times: ``steps``, ``late``, ``minstd_steps``, ``formant_steps``,
``audio_uploads``, ``graph_captures``, ``graph_replays`` and the
process-wide ``table_builds``; the server's ``/status`` and heartbeat
publish them.

A pool of either engine on the card replays its step as CUDA graphs
(``serve/graphs.py``), captured once per step key after that key's
first, eager step: the gated program and the packed array's shape
(capacity, hops a step), and for the fidelity engine also the regime
and the fused-fetch switch.  The step goes through :func:`_pool_step` or
:func:`_pool_step_fidelity` either way.  The state and the tracks stay
in the pool's own tensors, which the graphs read: each step's new state
is copied into them, and a changed track into the tracks' tensor.  New
tensors (``grow``, a checkpoint's load, tracks of another shape) make
the graphs capture again.  ``metrics()`` counts them:
``graph_captures`` and ``graph_replays``.  On the CPU the step runs
eagerly as it always has.

``step(fetch="pipeline")`` overlaps the master's copy to the host with
the next steps: each master is copied into one of ``pipeline_depth + 1``
pinned host buffers with ``non_blocking=True`` and an event recorded
behind the copy, and the step returns the master of ``pipeline_depth``
steps ago once its event has completed.  The ring has one buffer more
than the copies in flight, so no buffer is written while its copy is
still being read.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import fast_stages
from bauklank_tpu_torch.engine.drive import (deterministic_regime, fidelity_operands, geometry,
                                              packed_rows, unpack, uses_formants)
from bauklank_tpu_torch.engine.fidelity import SpectralConfig, fidelity_stages
from bauklank_tpu_torch.engine.spectral import chainfetch_enabled
from bauklank_tpu_torch.ops.analyze import analyze_signal
from bauklank_tpu_torch.schedule.timemap import TimeMap
from bauklank_tpu_torch.serve.graphs import StepGraphs, eager
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import StepTimer, span, table_builds
from bauklank_tpu_torch.utils.tree import keyed_leaves, tree_map

__all__ = ["StreamPool", "VoiceSlot", "CONTROL_CLAMPS", "COUNTERS"]

SCHEDULE_LOOKAHEAD_SEC = 0.1  # reference: app/multi/app.mjs:494
RAMP_SEC = 0.03               # reference: app/multi/app.mjs:454

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

# the counters of StreamPool.metrics() that a UnifiedPool sums over its buckets
COUNTERS = ("steps", "late", "minstd_steps", "formant_steps", "audio_uploads",
            "graph_captures", "graph_replays")


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


def _pool_step(config: StretchConfig, states, audios, packed, *,
               graphs: StepGraphs | None = None):
    """One fast-engine pool step from the packed ``[S, H + 11]`` array
    (``engine.drive.unpack``: frame ends, the seven StretchParams fields,
    gain and pan ramps).  ``graphs``: the pool's step graphs on the card,
    with ``packed`` still on the host, as for :func:`_pool_step_fidelity`;
    a step key is the gated program and the packed array's shape.
    Returns (states, master [2, n], streams)."""
    if graphs is None:
        return _issue_fast(config, states, audios, packed, eager)
    operands = [leaf for _, leaf in keyed_leaves(states)] + [audios]
    return graphs.step((config, tuple(packed.shape)), packed, operands,
                       lambda run, dev: _issue_fast(config, states, audios, dev, run))


def _issue_fast(config: StretchConfig, states, audios, packed, run):
    """:func:`_pool_step`'s work, through :func:`_issue`: the frame ends
    and the fields, then ``engine.core.fast_stages`` in their ``fast.*``
    ranges."""
    def operands():
        ends, params, _, _ = unpack(packed)
        return ends.to(torch.int32), params

    return _issue(run, packed, operands,
                  lambda ends, params: fast_stages(config, states, audios, ends, params))


def _pool_step_fidelity(scfg: SpectralConfig, states, audios, packed,
                        deterministic: bool | None = None, *, graphs: StepGraphs | None = None):
    """One fidelity pool step from the same packed layout as
    :func:`_pool_step`.  With ``scfg.formants`` the packed formant fields
    drive the blob's step 5 per stream.  ``deterministic``: the host's
    word that every voice is at time factor <= 2
    (``engine.drive.deterministic_regime``).
    ``graphs``: the pool's step graphs on the card, with ``packed`` still
    on the host; the step's stages are then replayed as CUDA graphs, one
    set per step key (``serve/graphs.py``), and the new state returned is
    the graphs' memory, which the caller copies into ``states`` before the
    next step.  Returns (states, master, streams)."""
    if graphs is None:
        return _issue_fidelity(scfg, states, audios, packed, deterministic, eager)
    key = (scfg, tuple(packed.shape), deterministic, chainfetch_enabled())
    operands = [leaf for _, leaf in keyed_leaves(states)] + [audios]
    return graphs.step(key, packed, operands, lambda run, dev: _issue_fidelity(
        scfg, states, audios, dev, deterministic, run))


def _issue_fidelity(scfg: SpectralConfig, states, audios, packed, deterministic, run):
    """:func:`_pool_step_fidelity`'s work, through :func:`_issue`: the
    blob's operands of the rows, then ``engine.fidelity.fidelity_stages``
    in their ``fidelity.*`` ranges."""
    return _issue(run, packed, lambda: fidelity_operands(scfg, packed),
                  lambda *args: fidelity_stages(scfg, states, audios, *args,
                                                deterministic=deterministic))


def _issue(run, packed, operands, stages):
    """A pool step's work as stages handed to ``run(range name or None,
    stage)`` in step order: the unpacking (``operands()``), the engine's
    stages (``stages(*operands)``: v and the (range name, stage) list),
    the mixdown (the unpacking and the mixdown with no range of their own:
    they are ``pool.step``'s).  Returns (states, master, streams) once
    every stage has run."""
    out: dict = {}
    run(None, lambda: out.update(args=operands()))
    v, staged = stages(*out["args"])
    for name, stage in staged:
        run(name, stage)
    run(None, lambda: out.update(master=_mixdown(v["emit"], *unpack(packed)[2:])))
    return v["states"], out["master"], v["emit"]


class StreamPool:
    """Fixed-capacity batched voice pool on one device.

    Slots are named (defaults "s00"..., or pass ``names``).  ``engine``:
    "fast" (hop-parallel, ``engine/core.py``) or "fidelity" (blob-exact,
    ``engine/spectral.py``).  It runs on
    ``device``, the card unless the caller passes another.

    The geometry (``config``, or ``block`` and ``interval``, which the
    fidelity engine runs raw, or neither: the 120/30 ms preset) is
    ``engine.drive.geometry``'s, kept as ``drive``."""

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
        block: int | None = None,
        interval: int | None = None,
    ) -> None:
        self.drive = geometry(engine, channels, sample_rate, config, block, interval)
        self.config, self.scfg = self.drive.config, self.drive.scfg
        self.engine = engine
        self.device = resolve_device(device)
        self.clamps = dict(CONTROL_CLAMPS)
        self.clamps["rate"] = (CONTROL_CLAMPS["rate"][0], float(max_rate))
        self.sample_rate = float(sample_rate)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.max_track = int(max_track_sec * sample_rate)
        # frame-end sample indices ride the packed float32 array; float32
        # is integer-exact only below 2**24 (~380 s at 44.1 kHz)
        if self.max_track + self.drive.block >= 2**24:
            raise ValueError(
                f"max_track_sec={max_track_sec} exceeds float32-exact frame "
                f"positioning (track + block must stay < 2**24 samples)"
            )
        self.slots = [VoiceSlot(names[i] if names else f"s{i:02d}") for i in range(capacity)]
        self._by_name = {s.name: i for i, s in enumerate(self.slots)}
        self._audio_host = np.zeros((capacity, channels, self.max_track), np.float32)
        self._audio_dev: torch.Tensor | None = None
        self._audio_kept: torch.Tensor | None = None  # the tracks the step graphs read
        # the step on the card replays CUDA graphs (serve/graphs.py)
        self._graphs = StepGraphs(self.device) if self.device.type == "cuda" else None
        self.states = self.drive.states(capacity, self.device)
        self.out_pos = 0  # output samples stepped so far
        self._last_streams: torch.Tensor | None = None  # [S, C, n] of the last step
        # masters in flight for step(fetch="pipeline"): (host tensor, event or None)
        self.pipeline_depth = 2
        self._fetch_q: collections.deque = collections.deque()
        self._pinned: list[torch.Tensor] = []  # ring of pipeline_depth + 1 buffers
        self._pinned_next = 0
        self.timer = StepTimer(sample_rate)
        # decisions of the host about its steps, counted for metrics()
        self.minstd_steps = 0     # fidelity steps outside the deterministic regime
        self.formant_steps = 0    # steps that ran the formant chain
        self.audio_uploads = 0    # copies of every track to the device

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
    def clear_voice(self, slot: str) -> None:
        """Fully reset one voice (engine state, audio, time map, mix) so its
        batch row can be reused."""
        i = self._by_name[slot]
        self._audio_host[i] = 0.0
        self._audio_dev = None
        self.slots[i] = VoiceSlot(slot)

        def reset(leaf, fresh):
            leaf[i] = fresh[0]

        tree_map(reset, self.states, self.drive.states(1, self.device))

    def grow(self, new_capacity: int) -> None:
        """Extend capacity in place (config-bucket growth in the unified
        pool): every state leaf is concatenated with fresh rows along the
        stream axis, so every existing voice keeps its state bit for bit;
        fresh slots take the next free ``sNN`` names.  Masters in flight
        are [2, n] and not touched; the last step's streams gain silent
        rows, so ``analyze`` of a fresh slot reads silence."""
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        c, t = self._audio_host.shape[1:]
        self._audio_host = np.concatenate([self._audio_host, np.zeros((pad, c, t), np.float32)])
        self._audio_dev = None
        taken = set(self._by_name)
        k = self.capacity
        while len(self.slots) < new_capacity:
            name = f"s{k:02d}"
            k += 1
            if name not in taken:
                self.slots.append(VoiceSlot(name))
        self._by_name = {s.name: i for i, s in enumerate(self.slots)}
        self.states = tree_map(lambda a, b: torch.cat([a, b]), self.states,
                               self.drive.states(pad, self.device))
        if self._last_streams is not None:
            last = self._last_streams
            self._last_streams = torch.cat([last, last.new_zeros((pad,) + last.shape[1:])])
        self.capacity = new_capacity

    def _device_audio(self) -> torch.Tensor:
        """The tracks on the device, copied there again after a change.  A
        pool with step graphs copies them into the tensor its graphs read
        where the shape allows (a new tensor makes them capture again)."""
        if self._audio_dev is None:
            host = torch.from_numpy(self._audio_host)
            kept = self._audio_kept
            if kept is not None and kept.shape == host.shape:
                self._audio_dev = kept.copy_(host)
            else:
                self._audio_dev = host.to(self.device)
                if self._graphs is not None:
                    self._audio_kept = self._audio_dev
            self.audio_uploads += 1
        return self._audio_dev

    # ------------------------------------------------------------- control
    @property
    def output_time(self) -> float:
        return self.out_pos / self.sample_rate + self.drive.output_latency / self.sample_rate

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
        """Host side of a step: each voice's row of hop frame ends, params
        and mix ramps (``engine.drive``) in one [S, H + 11] float32 array."""
        h, drive = self.hops_per_step, self.drive
        packed = packed_rows(self.capacity, h)
        for row, s in zip(packed, self.slots):
            drive.fill(row, s.timemap, self.out_pos, h, self.sample_rate, s.loaded,
                       (s._prev_volume, s.volume, s._prev_pan, s.pan))
            s._prev_volume, s._prev_pan = s.volume, s.pan
        return packed

    def step(self, fetch: bool | str = False):
        """Render the next chunk for every voice.

        Returns (master [2, n], streams [S, C, n]); n = hops_per_step *
        interval.  With ``fetch=True`` the master mix is copied to numpy,
        which waits for the device work (honest latency accounting).
        ``fetch="pipeline"`` starts the master's copy to the host and
        returns, as numpy, the master of ``pipeline_depth`` steps ago
        (None while the pipeline fills); :meth:`drain` returns the rest."""
        with span("pool.step"):
            self.timer.start()
            h, interval = self.hops_per_step, self.drive.interval
            with span("pool.pack"):
                packed = self._packed()
            # host-side formant gating: the formant chain runs only in a
            # step where some voice uses a formant control
            _, fields, _, _ = unpack(packed)
            program = self.drive.gated(uses_formants(fields))
            self.formant_steps += program.formants
            audios = self._device_audio()
            graphs = self._graphs
            # with step graphs the packed array stays on the host until the
            # graphs copy it into their own buffer
            packed_t = torch.from_numpy(packed)
            if graphs is None:
                packed_t = packed_t.to(self.device)
            if self.engine == "fidelity":
                deterministic = deterministic_regime(fields.rate, program.interval)
                self.minstd_steps += not deterministic
                states, master, streams = _pool_step_fidelity(
                    program, self.states, audios, packed_t, deterministic, graphs=graphs)
            else:
                states, master, streams = _pool_step(program, self.states, audios, packed_t,
                                                     graphs=graphs)
            if graphs is None:
                self.states = states
            else:
                # the step graphs read the pool's own state tensors
                tree_map(lambda mine, new: mine if mine is new else mine.copy_(new),
                         self.states, states)
            self.out_pos += h * interval
            self._last_streams = streams
            if fetch == "pipeline":
                with span("pool.fetch"):
                    self._fetch_q.append(self._start_fetch(master))
                    master = (self._finish_fetch(*self._fetch_q.popleft())
                              if len(self._fetch_q) > self.pipeline_depth else None)
            elif fetch:
                with span("pool.fetch"):
                    master = master.cpu().numpy()
            self.timer.tick(self.capacity * h * interval, h * interval / self.sample_rate)
        return master, streams

    def _start_fetch(self, master: torch.Tensor):
        """Start the master's copy to the host: into the next pinned buffer
        of the ring with an event behind it on the card, as it is on the
        CPU."""
        if master.device.type != "cuda":
            return master, None
        if not self._pinned or self._pinned[0].shape != master.shape:
            self._pinned = [torch.empty(master.shape, dtype=master.dtype, pin_memory=True)
                            for _ in range(self.pipeline_depth + 1)]
            self._pinned_next = 0
        buf = self._pinned[self._pinned_next]
        self._pinned_next = (self._pinned_next + 1) % len(self._pinned)
        buf.copy_(master, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    @staticmethod
    def _finish_fetch(buf: torch.Tensor, event) -> np.ndarray:
        """Wait for one copy and take the master out of its buffer (the
        buffer is written again pipeline_depth + 1 steps later)."""
        if event is not None:
            event.synchronize()
        return buf.numpy().copy()

    def drain(self) -> list[np.ndarray]:
        """The masters still in the fetch pipeline, in dispatch order (call
        after the last ``step(fetch="pipeline")`` so no audio is lost)."""
        with span("pool.fetch"):
            out = [self._finish_fetch(*f) for f in self._fetch_q]
        self._fetch_q.clear()
        return out

    # ------------------------------------------------------------- analyze
    def analyze(self, slot: str, n_buckets: int = 128) -> dict | None:
        """Scope, spectrum and levels of a voice's last rendered chunk,
        computed on the device from the retained streams; one copy to the
        host per request."""
        if slot not in self._by_name or self._last_streams is None:
            return None
        sig = self._last_streams[self._by_name[slot]]
        return analyze_signal(slot, sig, self.sample_rate, n_buckets)

    def metrics(self) -> dict:
        """Rolling serving metrics (step p50/p99 latency, aggregate RTF)
        and the counters since the pool was built: ``steps``; ``late``,
        steps that took longer than the audio they render (H x interval /
        sample rate); ``minstd_steps``, fidelity steps with a voice past
        time factor 2 (the MINSTD regime); ``formant_steps``, steps that
        ran the formant chain; ``audio_uploads``, copies of every track
        to the device (one after each batch of track changes); and
        ``table_builds``, constant tables built in the whole process
        (``utils.metrics.table_builds``), not by this pool alone; and, of
        a pool on the card, ``graph_captures``, step keys whose
        CUDA graphs were captured (again after an operand was replaced),
        and ``graph_replays``, steps issued as graph replays (both 0
        elsewhere; ``graph_replays / steps`` is the graphs' hit share)."""
        graphs = self._graphs
        return dict(self.timer.snapshot(), minstd_steps=self.minstd_steps,
                    formant_steps=self.formant_steps, audio_uploads=self.audio_uploads,
                    table_builds=table_builds(),
                    graph_captures=graphs.captures if graphs else 0,
                    graph_replays=graphs.replays if graphs else 0)
