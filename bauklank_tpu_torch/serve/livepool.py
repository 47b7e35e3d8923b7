"""LivePool: batched live-input processing for many streams.

Port of ``bauklank_tpu/serve/livepool.py``.  N live streams share one
batched device step: each stream owns a host-side input FIFO; every step
consumes exactly ``hops_per_step`` intervals per stream (zero-filled on
underrun, like the reference's silent-input branch) and produces as many
samples of pitch/formant-processed output per stream.  ``engine="fast"``
drives :func:`engine.live.process_live`, ``engine="fidelity"`` the
coupled blob-exact step :func:`engine.fidelity.batched_live_fidelity_chunk`.
It runs on ``device``, the card unless the caller passes another.
"""

from __future__ import annotations

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig, preset_default
from bauklank_tpu_torch.engine.drive import (fidelity_controls, geometry, packed_rows, params_of,
                                              unpack, uses_formants)
from bauklank_tpu_torch.engine.fidelity import SpectralConfig, batched_live_fidelity_chunk
from bauklank_tpu_torch.engine.live import process_live
from bauklank_tpu_torch.schedule.timemap import TimeMap
from bauklank_tpu_torch.serve.pool import _TIMEMAP_KEYS, CONTROL_CLAMPS
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import StepTimer
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = ["LivePool"]


def _live_fidelity_step(scfg: SpectralConfig, states, chunks, packed):
    """The coupled blob-exact step from the packed [S, 7] StretchParams
    fields.  Rate does not apply (the live branch consumes input in
    lockstep with output and never seeks); the other fields map onto the
    blob controls as in file mode (``engine.drive.fidelity_controls``)."""
    _, params, _, _ = unpack(packed, ramps=False)
    return batched_live_fidelity_chunk(scfg, states, chunks, *fidelity_controls(scfg, params))


class LivePool:
    """N live voices, one device step per ``hops_per_step`` intervals; both
    engines run the ``config``'s sizes (``engine.drive.geometry``)."""

    def __init__(
        self,
        capacity: int = 16,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        names: list[str] | None = None,
        hops_per_step: int = 1,
        engine: str = "fast",
        device=DEFAULT_DEVICE,
    ) -> None:
        self.drive = geometry(engine, channels, sample_rate,
                              config or preset_default(channels, sample_rate))
        self.config, self.scfg = self.drive.config, self.drive.scfg
        self.engine = engine
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.names = names or [f"l{i:02d}" for i in range(capacity)]
        self._by_name = {n: i for i, n in enumerate(self.names)}
        self.states = self.drive.live_states(hops_per_step, capacity, self.device)
        self.timemaps = [TimeMap() for _ in range(capacity)]
        c = self.config.channels
        self._in_fifo = [np.zeros((c, 0), np.float32) for _ in range(capacity)]
        self.out_pos = 0
        self.timer = StepTimer(sample_rate)

    # -------------------------------------------------- slot lifecycle
    def clear_voice(self, slot: str) -> None:
        """Reset one live voice (engine state, input FIFO, time map) so the
        batch row can be reused."""
        i = self._by_name[slot]

        def reset(a, fresh):
            a[i] = fresh[0]

        tree_map(reset, self.states, self.drive.live_states(self.hops_per_step, 1, self.device))
        self.timemaps[i] = TimeMap()
        self._in_fifo[i] = np.zeros((self.config.channels, 0), np.float32)

    def grow(self, new_capacity: int) -> None:
        """Extend capacity in place, every existing voice's state kept bit
        for bit (config-bucket growth in the unified pool)."""
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        self.states = tree_map(lambda a, b: torch.cat([a, b]), self.states,
                               self.drive.live_states(self.hops_per_step, pad, self.device))
        taken = set(self._by_name)
        k = self.capacity
        while len(self.names) < new_capacity:
            name = f"l{k:02d}"
            k += 1
            if name not in taken:
                self.names.append(name)
        self._by_name = {n: i for i, n in enumerate(self.names)}
        c = self.config.channels
        self.timemaps.extend(TimeMap() for _ in range(pad))
        self._in_fifo.extend(np.zeros((c, 0), np.float32) for _ in range(pad))
        self.capacity = new_capacity

    def feed(self, slot: str, chunk) -> None:
        """Queue live input samples for one stream ([C, n] or [n])."""
        i = self._by_name[slot]
        x = np.asarray(chunk, np.float32)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.config.channels, x.shape[0]))
        self._in_fifo[i] = np.concatenate([self._in_fifo[i], x], axis=1)

    def schedule(self, slot: str, obj: dict) -> None:
        self.timemaps[self._by_name[slot]].schedule(obj)

    def apply_set(self, slot: str, key: str, value, lookahead: float = 0.1) -> bool:
        """Control routing compatible with StreamPool.apply_set; live voices
        have no rate, volume or pan (input-coupled, raw per-stream output):
        those keys are acknowledged and ignored."""
        if slot not in self._by_name:
            return False
        if key in ("rate", "volume", "volumePercent", "pan"):
            return True
        if key not in _TIMEMAP_KEYS:
            return False
        lo, hi = CONTROL_CLAMPS.get("semitones" if key == "tone" else key, (None, None))
        if lo is not None:
            value = float(np.clip(float(value), lo, hi))
        out_t = self.out_pos / self.sample_rate + self.drive.output_latency / self.sample_rate
        self.timemaps[self._by_name[slot]].schedule({key: value, "output": out_t + lookahead})
        return True

    def metrics(self) -> dict:
        return self.timer.snapshot()

    def step(self) -> np.ndarray:
        """Process hops_per_step intervals for every stream
        -> [S, C, hops_per_step * interval]."""
        drive, c = self.drive, self.config.channels
        self.timer.start()
        n = drive.interval * self.hops_per_step
        chunks = np.zeros((self.capacity, c, n), np.float32)
        for i in range(self.capacity):
            take = min(n, self._in_fifo[i].shape[1])
            chunks[i, :, :take] = self._in_fifo[i][:, :take]  # underrun -> zeros
            self._in_fifo[i] = self._in_fifo[i][:, take:]
        sr = self.sample_rate
        out_t = self.out_pos / sr + drive.output_latency / sr
        packed = packed_rows(self.capacity, 0, ramps=False)
        for row, tm in zip(packed, self.timemaps):
            tm.advance_to(out_t)
            seg = tm.current()
            row[:] = params_of(seg, sr, seg.active, rate=1.0)  # input in lockstep: rate 1
        dev_chunks = torch.from_numpy(chunks).to(self.device)
        dev_packed = torch.from_numpy(packed).to(self.device)
        if self.engine == "fidelity":
            scfg = drive.gated(uses_formants(unpack(packed, ramps=False)[1]))
            self.states, out = _live_fidelity_step(scfg, self.states, dev_chunks, dev_packed)
        else:
            self.states, out = process_live(drive.config, self.states, dev_chunks,
                                            unpack(dev_packed, ramps=False)[1])
        self.out_pos += n
        result = out.cpu().numpy()
        self.timer.tick(self.capacity * n, n / self.sample_rate)
        return result
