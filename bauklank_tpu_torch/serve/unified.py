"""UnifiedPool: heterogeneous voices — file + live, mixed configs — one mixer.

Port of ``bauklank_tpu/serve/unified.py``.  Block and interval are shapes
of a batched step, so voices are grouped into **config buckets**: every
(mode, block, interval, splitComputation) combination owns one batched
pool (:class:`StreamPool` for file voices, :class:`LivePool` for live
ones).  A ``set blockMs``/``overlap`` on a serving voice moves it to the
matching bucket, resetting its engine state as the reference resets its
engine on ``configure``, while its time map survives the move.

Buckets render at their own hop cadence; the mixer pulls a common
``quantum`` of samples per step, carrying each bucket's remainder in a
FIFO, and sums the bucket masters.  A bucket starts at
``bucket_capacity`` voices and doubles when it is full.

Every bucket's pool runs on ``device``, the card unless the caller passes
another.  A bucket's ``StretchConfig`` rounds its block onto the fast FFT
grid, and a fidelity bucket runs that rounded block, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig, block_interval
from bauklank_tpu_torch.ops.analyze import analyze_signal
from bauklank_tpu_torch.schedule.timemap import TimeMap
from bauklank_tpu_torch.serve.livepool import LivePool
from bauklank_tpu_torch.serve.pool import COUNTERS, StreamPool
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import StepTimer, table_builds

__all__ = ["UnifiedPool"]

# reference UI slider ranges (app/multi/index.html:146-182)
CONFIG_CLAMPS = {"blockMs": (10.0, 500.0), "overlap": (1.0, 8.0)}
CONFIG_KEYS = {"blockMs", "overlap", "splitComputation"}

_MIX_KEYS = {"volume", "volumePercent", "pan"}


@dataclasses.dataclass
class _Voice:
    name: str
    mode: str = "file"          # "file" | "live"
    block_ms: float = 120.0     # preset-default ratio
    overlap: float = 4.0
    split: bool = True
    volume: float = 0.1         # kiosk default
    pan: float = 0.0
    timemap: TimeMap = dataclasses.field(default_factory=TimeMap)
    track: list | None = None   # retained host-side for bucket moves
    bucket_key: tuple | None = None
    inner: str | None = None    # slot name inside the bucket's pool


class _Bucket:
    """One (mode, block, interval, split) config bucket: a batched pool of
    every voice sharing that shape, plus a master-sample FIFO that
    decouples the bucket's hop cadence from the unified quantum."""

    def __init__(self, owner: "UnifiedPool", key: tuple, capacity: int) -> None:
        mode, block, interval, split = key
        self.key = key
        self.mode = mode
        cfg = StretchConfig(channels=owner.channels, block=block, interval=interval,
                            split_computation=split)
        if mode == "file":
            self.pool: StreamPool | LivePool = StreamPool(
                capacity=capacity, sample_rate=owner.sample_rate, channels=owner.channels,
                config=cfg, max_track_sec=owner.max_track_sec, engine=owner.engine,
                device=owner.device)
        else:
            self.pool = LivePool(capacity=capacity, sample_rate=owner.sample_rate,
                                 channels=owner.channels, config=cfg, engine=owner.engine,
                                 device=owner.device)
        self.pool.out_pos = owner.out_pos  # align to the shared output clock
        self.owner = owner
        self.fifo = np.zeros((2, 0), np.float32)
        self.free: list[str] = [
            (s.name if mode == "file" else s)
            for s in (self.pool.slots if mode == "file" else self.pool.names)
        ][::-1]
        self.members: dict[str, str] = {}  # unified voice name -> inner slot
        self._mix_prev: dict[str, tuple[float, float]] = {}  # live ramps
        self._last_out: np.ndarray | None = None

    def acquire(self) -> str:
        if not self.free:
            old = self.pool.capacity
            self.pool.grow(old * 2)
            if self.mode == "file":
                fresh = [s.name for s in self.pool.slots[old:]]
            else:
                fresh = list(self.pool.names[old:])
            self.free.extend(reversed(fresh))
        return self.free.pop()

    def render_chunk(self) -> np.ndarray:
        """One bucket step -> master [2, hop] numpy ([2, 0] while a
        pipelined fetch fills)."""
        if self.mode == "file":
            if self.owner.pipeline_fetch:
                # the master of pipeline_depth steps back; the FIFO takes the
                # chunks in order, so the sample stream is unchanged
                master, _ = self.pool.step(fetch="pipeline")
                return np.zeros((2, 0), np.float32) if master is None else master
            master, _ = self.pool.step(fetch=True)
            return master
        out = self.pool.step()  # [S, C, n]
        n = out.shape[-1]
        master = np.zeros((2, n), np.float32)
        t = np.linspace(0.0, 1.0, n, dtype=np.float32)
        for name, inner in self.members.items():
            v = self.owner.voices[name]
            i = self.pool._by_name[inner]
            mono = out[i].mean(axis=0)
            g0, p0 = self._mix_prev.get(name, (v.volume, v.pan))
            g = g0 + (v.volume - g0) * t   # linear ramps over the chunk
            p = p0 + (v.pan - p0) * t
            master[0] += mono * g * np.minimum(1.0, 1.0 - p)
            master[1] += mono * g * np.minimum(1.0, 1.0 + p)
            self._mix_prev[name] = (v.volume, v.pan)
        self._last_out = out  # retained for analyze
        return master


class UnifiedPool:
    """Voices of any mode and config behind one output clock and one
    master mix.

    The control-plane surface matches StreamPool (``apply_set`` /
    ``metrics`` / ``analyze`` / ``step``); ``apply_set`` also takes the
    config keys ``blockMs``/``overlap``/``splitComputation``, and live
    voices can be fed input."""

    def __init__(
        self,
        sample_rate: float = 44100.0,
        channels: int = 2,
        names: list[str] | None = None,
        engine: str = "fast",
        max_track_sec: float = 30.0,
        quantum: int | None = None,
        bucket_capacity: int = 4,
        pipeline_fetch: bool = False,
        device=DEFAULT_DEVICE,
    ) -> None:
        # pipeline_fetch: overlap each file bucket's master copy to the host
        # with the next steps (pipeline_depth steps of render-ahead a
        # bucket, the same sample stream)
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.channels = channels
        self.engine = engine
        self.max_track_sec = max_track_sec
        self.quantum = quantum or round(sample_rate * 0.03)
        self.bucket_capacity = bucket_capacity
        self.pipeline_fetch = pipeline_fetch
        self.out_pos = 0
        self.buckets: dict[tuple, _Bucket] = {}
        self.voices: dict[str, _Voice] = {}
        for n in names or []:
            self.add_voice(n)
        self.timer = StepTimer(sample_rate)

    # ------------------------------------------------------------ lifecycle
    def _key_for(self, v: _Voice) -> tuple:
        block, interval = block_interval(v.block_ms, v.overlap, self.sample_rate)
        return (v.mode, block, interval, v.split)

    def _place(self, v: _Voice) -> None:
        key = self._key_for(v)
        b = self.buckets.get(key)
        if b is None:
            b = _Bucket(self, key, self.bucket_capacity)
            self.buckets[key] = b
        inner = b.acquire()
        b.members[v.name] = inner
        v.bucket_key, v.inner = key, inner
        pool = b.pool
        i = pool._by_name[inner]
        if v.mode == "file":
            slot = pool.slots[i]
            slot.timemap = v.timemap          # schedule survives reconfigure
            slot.volume = slot._prev_volume = v.volume
            slot.pan = slot._prev_pan = v.pan
            if v.track is not None:
                pool.load_track(inner, v.track)
        else:
            pool.timemaps[i] = v.timemap
            b._mix_prev[v.name] = (v.volume, v.pan)

    def _unplace(self, v: _Voice) -> None:
        if v.bucket_key is None:
            return
        b = self.buckets[v.bucket_key]
        b.pool.clear_voice(v.inner)           # engine reset (reference configure)
        b.free.append(v.inner)
        del b.members[v.name]
        b._mix_prev.pop(v.name, None)
        v.bucket_key = v.inner = None
        if not b.members:
            del self.buckets[b.key]

    def add_voice(self, name: str, mode: str = "file", **cfg) -> None:
        if name in self.voices:
            raise ValueError(f"voice {name!r} exists")
        v = _Voice(name=name, mode=mode, **cfg)
        self.voices[name] = v
        self._place(v)

    def remove_voice(self, name: str) -> None:
        self._unplace(self.voices.pop(name))

    def set_mode(self, name: str, mode: str) -> None:
        """Switch a voice between file playback and live input.  The engine
        resets (bucket move); the time map survives."""
        v = self.voices[name]
        if mode == v.mode:
            return
        self._unplace(v)
        v.mode = mode
        self._place(v)

    # -------------------------------------------------------------- content
    def load_track(self, name: str, channel_arrays) -> int:
        v = self.voices[name]
        v.track = [np.asarray(a, np.float32) for a in channel_arrays]
        if v.mode != "file":
            self.set_mode(name, "file")   # _place loads the retained track
        else:
            self.buckets[v.bucket_key].pool.load_track(v.inner, v.track)
        b = self.buckets[v.bucket_key]
        return b.pool.slots[b.pool._by_name[v.inner]].track_len

    def feed(self, name: str, chunk) -> None:
        v = self.voices[name]
        if v.mode != "live":
            self.set_mode(name, "live")
        self.buckets[v.bucket_key].pool.feed(v.inner, chunk)

    # -------------------------------------------------------------- control
    @property
    def output_time(self) -> float:
        return self.out_pos / self.sample_rate

    def apply_set(self, slot: str, key: str, value, lookahead: float = 0.1) -> bool:
        v = self.voices.get(slot)
        if v is None:
            return False
        if key in CONFIG_KEYS:
            if key == "splitComputation":
                new = bool(value)
                changed = new != v.split
                v.split = new
            else:
                try:
                    value = float(value)
                except (TypeError, ValueError):
                    return False
                if not math.isfinite(value):
                    return False
                lo, hi = CONFIG_CLAMPS[key]
                value = float(np.clip(value, lo, hi))
                field = "block_ms" if key == "blockMs" else "overlap"
                changed = value != getattr(v, field)
                setattr(v, field, value)
            if changed and self._key_for(v) != v.bucket_key:
                self._unplace(v)
                self._place(v)
            return True
        if key in _MIX_KEYS:
            try:
                value = float(value)
            except (TypeError, ValueError):
                return False
            if not math.isfinite(value):
                return False
            if key == "pan":
                v.pan = float(np.clip(value, -1.0, 1.0))
            else:
                v.volume = float(
                    np.clip(value / (100.0 if key == "volumePercent" else 1.0), 0.0, 1.0))
            if v.mode == "file":
                b = self.buckets[v.bucket_key]
                s = b.pool.slots[b.pool._by_name[v.inner]]
                s.volume, s.pan = v.volume, v.pan
            return True
        b = self.buckets[v.bucket_key]
        return b.pool.apply_set(v.inner, key, value, lookahead=lookahead)

    def schedule(self, slot: str, obj: dict, adjust_previous: bool = False):
        return self.voices[slot].timemap.schedule(obj, adjust_previous)

    def start(self, slot: str, when: float | None = None, **kw) -> None:
        self.voices[slot].timemap.start(self.output_time if when is None else when, **kw)

    def stop(self, slot: str, when: float | None = None) -> None:
        self.voices[slot].timemap.stop(self.output_time if when is None else when)

    def input_time(self, slot: str) -> float:
        return self.voices[slot].timemap.input_time_at(self.output_time)

    def is_playing(self, slot: str) -> bool:
        """True when the voice is in active file playback."""
        v = self.voices.get(slot)
        if v is None or v.mode != "file" or v.bucket_key is None:
            return False
        return self.buckets[v.bucket_key].pool.is_playing(v.inner)

    # ----------------------------------------------------------------- step
    def render(self, n: int) -> np.ndarray:
        """Pull n master samples: every bucket steps at its own hop cadence
        until its FIFO covers n; bucket masters sum into [2, n]."""
        self.timer.start()
        master = np.zeros((2, n), np.float32)
        for b in list(self.buckets.values()):
            while b.fifo.shape[1] < n:
                b.fifo = np.concatenate([b.fifo, b.render_chunk()], axis=1)
            master += b.fifo[:, :n]
            b.fifo = b.fifo[:, n:]
        self.out_pos += n
        self.timer.tick(max(1, len(self.voices)) * n, n / self.sample_rate)
        return master

    def step(self, fetch: bool = True):
        """StreamPool-compatible step: one quantum of master mix."""
        return self.render(self.quantum), None

    # ------------------------------------------------------------- monitors
    def analyze(self, slot: str, n_buckets: int = 128) -> dict | None:
        v = self.voices.get(slot)
        if v is None or v.bucket_key is None:
            return None
        b = self.buckets[v.bucket_key]
        if v.mode == "file":
            return b.pool.analyze(v.inner, n_buckets=n_buckets)
        i = b.pool._by_name[v.inner]
        if b._last_out is None or i >= b._last_out.shape[0]:
            return None  # no chunk rendered in this slot yet (a bucket grown since)
        sig = torch.from_numpy(b._last_out[i]).to(self.device)
        return analyze_signal(slot, sig, self.sample_rate, n_buckets)

    def metrics(self) -> dict:
        """The render's step times and late quanta (``steps`` counts
        :meth:`render` calls), the buckets, the buckets' own counters
        summed (``bucket_counters``: ``StreamPool.metrics``'s; a live
        bucket has only ``steps`` and ``late``) and the process-wide
        ``table_builds``."""
        m = self.timer.snapshot()
        m["buckets"] = {
            f"{k[0]}:{k[1]}/{k[2]}": {"voices": len(b.members), "capacity": b.pool.capacity}
            for k, b in self.buckets.items()
        }
        sums = dict.fromkeys(COUNTERS, 0)
        for b in self.buckets.values():
            got = b.pool.metrics()
            for k in COUNTERS:
                sums[k] += got.get(k, 0)
        m["bucket_counters"] = sums
        m["table_builds"] = table_builds()
        return m

    def voice_config(self, slot: str) -> dict:
        """The voice's effective engine configuration."""
        v = self.voices[slot]
        mode, block, interval, split = self._key_for(v)
        return {
            "mode": mode, "blockSamples": block, "intervalSamples": interval,
            "blockMs": v.block_ms, "overlap": v.overlap, "splitComputation": split,
        }
