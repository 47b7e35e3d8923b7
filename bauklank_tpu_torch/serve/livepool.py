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
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    batched_live_fidelity_chunk,
    init_batched_live_fidelity_state,
)
from bauklank_tpu_torch.engine.live import init_live_state, process_live
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.schedule.timemap import TimeMap
from bauklank_tpu_torch.serve.pool import _TIMEMAP_KEYS, CONTROL_CLAMPS
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import StepTimer
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = ["LivePool"]


def _live_fidelity_step(scfg: SpectralConfig, states, chunks, packed):
    """The coupled blob-exact step from the packed [S, 7] StretchParams
    fields.  Rate does not apply (the live branch consumes input in
    lockstep with output and never seeks); transpose, tonality and the
    formant fields map onto the blob controls as in file mode."""
    params = StretchParams.unpack(packed, 0)
    mult = params.transpose_factor
    limit = params.tonality / torch.sqrt(mult)
    formants = ((params.formant_factor, params.formant_compensation, params.formant_base)
                if scfg.formants else (None, None, None))
    return batched_live_fidelity_chunk(scfg, states, chunks, mult, limit, params.active,
                                       *formants)


class LivePool:
    """N live voices, one device step per ``hops_per_step`` intervals."""

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
        if engine not in ("fast", "fidelity"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.config = config or preset_default(channels, sample_rate)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.names = names or [f"l{i:02d}" for i in range(capacity)]
        self._by_name = {n: i for i, n in enumerate(self.names)}
        if engine == "fidelity":
            self.scfg = SpectralConfig(channels, self.config.block, self.config.interval,
                                       split=self.config.split_computation)
        self.states = self._init_batched(capacity)
        self.timemaps = [TimeMap() for _ in range(capacity)]
        c = self.config.channels
        self._in_fifo = [np.zeros((c, 0), np.float32) for _ in range(capacity)]
        self.out_pos = 0
        self.timer = StepTimer(sample_rate)

    # -------------------------------------------------- slot lifecycle
    def _init_batched(self, n: int):
        """Fresh engine state for ``n`` streams."""
        if self.engine == "fidelity":
            return init_batched_live_fidelity_state(self.scfg, self.hops_per_step, n, self.device)
        return init_live_state(self.config, self.hops_per_step, n, self.device)

    def clear_voice(self, slot: str) -> None:
        """Reset one live voice (engine state, input FIFO, time map) so the
        batch row can be reused."""
        i = self._by_name[slot]

        def reset(a, fresh):
            a[i] = fresh[0]

        tree_map(reset, self.states, self._init_batched(1))
        self.timemaps[i] = TimeMap()
        self._in_fifo[i] = np.zeros((self.config.channels, 0), np.float32)

    def grow(self, new_capacity: int) -> None:
        """Extend capacity in place, every existing voice's state kept bit
        for bit (config-bucket growth in the unified pool)."""
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        self.states = tree_map(lambda a, b: torch.cat([a, b]), self.states,
                               self._init_batched(pad))
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
        out_t = self.out_pos / self.sample_rate + self.config.output_latency / self.sample_rate
        self.timemaps[self._by_name[slot]].schedule({key: value, "output": out_t + lookahead})
        return True

    def metrics(self) -> dict:
        return self.timer.snapshot()

    def step(self) -> np.ndarray:
        """Process hops_per_step intervals for every stream
        -> [S, C, hops_per_step * interval]."""
        cfg = self.config
        self.timer.start()
        n = cfg.interval * self.hops_per_step
        chunks = np.zeros((self.capacity, cfg.channels, n), np.float32)
        for i in range(self.capacity):
            take = min(n, self._in_fifo[i].shape[1])
            chunks[i, :, :take] = self._in_fifo[i][:, :take]  # underrun -> zeros
            self._in_fifo[i] = self._in_fifo[i][:, take:]
        sr = self.sample_rate
        out_t = self.out_pos / sr + cfg.output_latency / sr
        packed = np.zeros((self.capacity, 7), np.float32)
        for i, tm in enumerate(self.timemaps):
            tm.advance_to(out_t)
            seg = tm.current()
            packed[i] = (
                1.0 if seg.active else 0.0,
                1.0,  # live mode consumes input in lockstep
                2.0 ** (seg.semitones / 12.0),
                seg.tonality_hz / sr,
                2.0 ** (seg.formant_semitones / 12.0),
                1.0 if seg.formant_compensation else 0.0,
                seg.formant_base_hz / sr,
            )
        dev_chunks = torch.from_numpy(chunks).to(self.device)
        dev_packed = torch.from_numpy(packed).to(self.device)
        if self.engine == "fidelity":
            # host-side formant gating, as in StreamPool.step: the formant
            # chain runs only in a step where some voice drives it
            scfg = self.scfg
            if np.any(packed[:, 4] != 1.0) or np.any(packed[:, 5] != 0.0):
                scfg = scfg._replace(formants=True)
            self.states, out = _live_fidelity_step(scfg, self.states, dev_chunks, dev_packed)
        else:
            self.states, out = process_live(cfg, self.states, dev_chunks,
                                            StretchParams.unpack(dev_packed, 0))
        self.out_pos += n
        result = out.cpu().numpy()
        self.timer.tick(self.capacity * n, n / self.sample_rate)
        return result
