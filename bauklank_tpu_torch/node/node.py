"""StretchNode: one stretch voice with the reference node's control surface.

Port of ``bauklank_tpu/node/node.py``: ``configure``, ``latency``,
``set_update_interval``, ``start``, ``stop``, ``schedule``,
``add_buffers``, ``drop_buffers``, ``flush`` and the ``input_time`` the
reference pushes as ``['time', t]`` messages.  The node pulls output in
chunks of any size (:meth:`process_output`, file playback) or takes live
input (:meth:`process`); inside it runs one spectral hop per ``interval``
output samples, and an output FIFO decouples the hops from the caller's
chunk sizes.  It runs on ``device``, the card unless the caller passes
another.  Fleets use ``serve.pool.StreamPool``, which batches many voices
into one step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import process_chunk
from bauklank_tpu_torch.engine.drive import (deterministic_regime, fidelity_operands, geometry,
                                              packed_rows, unpack)
from bauklank_tpu_torch.engine.fidelity import SpectralConfig, fidelity_chunk
from bauklank_tpu_torch.engine.live import init_live_state, process_live
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.schedule.timemap import Segment, TimeMap
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["StretchNode"]


def _chunk(config: StretchConfig, state, audio, packed):
    """The fast engine's chunk from ``packed`` [H + 7] float32 (frame ends
    and the seven fields, ``engine.drive.unpack``).  Returns (state, out
    [C, H * interval])."""
    ends, params, _, _ = unpack(packed[None], ramps=False)
    state, out = process_chunk(config, state, audio[None], ends.to(torch.int32), params)
    return state, out[0]


def _fidelity_chunk(scfg: SpectralConfig, state, audio, packed, deterministic: bool):
    """The fidelity step from the same packed layout, its fields mapped
    onto the blob's controls by ``engine.drive.fidelity_operands``."""
    return fidelity_chunk(scfg, state, audio, *fidelity_operands(scfg, packed, ramps=False),
                          deterministic=deterministic)


class StretchNode:
    """One stretch voice.

    File playback: ``add_buffers`` appends channel buffers to a timeline,
    as the reference worklet's buffer list does.  ``engine``: "fast"
    (``engine/core.py``) or "fidelity" (the blob-exact engine, which keeps
    the requested block).  The geometry is ``engine.drive.geometry``'s,
    kept as ``drive``."""

    def __init__(
        self,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        hops_per_dispatch: int = 1,
        engine: str = "fast",
        device=DEFAULT_DEVICE,
    ) -> None:
        # hops_per_dispatch > 1 renders that many intervals ahead, delaying
        # the effect of schedule() changes; 1 keeps control latency at one
        # interval, the reference's per-quantum control sampling
        self.drive = geometry(engine, channels, sample_rate, config)
        self.engine = engine
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.channels = channels
        self.hops_per_dispatch = hops_per_dispatch
        self.timemap = TimeMap()
        self._buffers: list[np.ndarray] = []
        self._audio_dev: torch.Tensor | None = None
        self._state = None
        self._out_pos = 0  # output samples rendered since reset
        self._fifo = np.zeros((channels, 0), np.float32)
        self.input_time = 0.0
        self._update_interval = 0.1
        self._update_cb: Callable[[float], None] | None = None
        self._since_update = 0.0
        self.reset()

    # ------------------------------------------------------------ engine ABI
    def configure(self, **kw) -> None:
        """Accepts the reference config keys: blockMs / intervalMs / overlap
        / splitComputation / preset, and block / interval in samples.
        Reconfiguring resets the engine, like the reference."""
        sr, sizes = self.sample_rate, None
        if kw.get("preset") == "cheaper":   # engine.config.preset_cheaper's 100/40 ms
            sizes = dict(block=round(sr * 0.1), interval=round(sr * 0.04))
        elif kw.get("preset") == "default":
            sizes = {}
        elif "blockMs" in kw or "block" in kw:
            block = int(kw.get("block") or round(kw["blockMs"] / 1000.0 * sr))
            if "interval" in kw:
                interval = int(kw["interval"])
            elif "intervalMs" in kw:
                interval = round(kw["intervalMs"] / 1000.0 * sr)
            elif "overlap" in kw:
                # the reference clamps overlap to [1, 8] before configuring;
                # overlap < 1 would mean interval > block, where the blob's
                # Kaiser bandwidth law has no real beta
                interval = round(block / min(8.0, max(1.0, float(kw["overlap"]))))
            else:
                interval = round(block * 0.25)  # reference default
            if interval > block:
                raise ValueError(
                    f"interval ({interval}) must not exceed block ({block}): gapped analysis "
                    "has no COLA window (the reference UI clamps overlap to [1, 8])")
            sizes = dict(block=block, interval=max(1, interval),
                         split=bool(kw.get("splitComputation", self.config.split_computation)))
        if sizes is not None:
            self.drive = geometry(self.engine, self.channels, sr, **sizes)
        self.reset()

    def reset(self) -> None:
        self._state = self.drive.state(self.device)
        self._out_pos = 0
        self._fifo = np.zeros((self.channels, 0), np.float32)
        self._since_update = 0.0

    @property
    def config(self) -> StretchConfig:
        return self.drive.config

    @property
    def block_samples(self) -> int:
        return self.drive.block

    @property
    def interval_samples(self) -> int:
        return self.drive.interval

    @property
    def input_latency(self) -> int:
        return self.drive.input_latency

    @property
    def output_latency(self) -> int:
        return self.drive.output_latency

    def latency(self) -> float:
        """Total latency in seconds (the reference node's ``latency``)."""
        return (self.input_latency + self.output_latency) / self.sample_rate

    def set_update_interval(self, seconds: float, callback=None) -> None:
        self._update_interval = float(seconds)
        self._update_cb = callback

    # ------------------------------------------------------------- schedule
    def schedule(self, obj: dict, adjust_previous: bool = False) -> Segment:
        return self.timemap.schedule(obj, adjust_previous)

    def start(self, when: float | None = None, offset: float = 0.0, duration=None,
              rate=None, semitones=None) -> None:
        when = self.output_time if when is None else when
        self.timemap.start(when, offset, duration, rate, semitones)

    def stop(self, when: float | None = None) -> None:
        self.timemap.stop(self.output_time if when is None else when)

    @property
    def output_time(self) -> float:
        """Current playhead in seconds, offset by output latency like the
        reference's ``currentTime + outputLatencySeconds``."""
        return self._out_pos / self.sample_rate + self.output_latency / self.sample_rate

    # -------------------------------------------------------------- buffers
    def add_buffers(self, channel_arrays) -> int:
        """Append one multi-channel buffer; returns total samples loaded."""
        arrs = [np.asarray(a, np.float32) for a in channel_arrays]
        n = arrs[0].shape[0]
        self._buffers.append(np.stack([arrs[c % len(arrs)][:n] for c in range(self.channels)]))
        self._audio_dev = None
        return sum(b.shape[1] for b in self._buffers)

    def drop_buffers(self) -> None:
        self._buffers = []
        self._audio_dev = None

    def _device_audio(self) -> torch.Tensor:
        if self._audio_dev is None:
            if self._buffers:
                track = np.concatenate(self._buffers, axis=1)
            else:
                track = np.zeros((self.channels, 1), np.float32)
            self._audio_dev = torch.from_numpy(track).to(self.device)
        return self._audio_dev

    # ------------------------------------------------------------ rendering
    def process_output(self, n_samples: int) -> np.ndarray:
        """File-playback pull: render the next ``n_samples`` of output (the
        reference hot path: advance the time map, derive the input read
        position per hop, seek and process)."""
        while self._fifo.shape[1] < n_samples:
            deficit = n_samples - self._fifo.shape[1]
            hops_needed = -(-deficit // self.interval_samples)
            # large pulls in large chunks; small pulls keep hops_per_dispatch
            # control latency
            hops = self.hops_per_dispatch
            for bucket in (1024, 256, 64, 16):
                if hops_needed >= bucket:
                    hops = bucket
                    break
            # a chunk shares one parameter set: never render across the next
            # schedule boundary (params are sampled per chunk, times per hop)
            hops = min(hops, max(1, self._hops_to_boundary()))
            self._render_hops(hops)
        out, self._fifo = self._fifo[:, :n_samples], self._fifo[:, n_samples:]
        self._out_pos += n_samples
        # the playhead at the pulled position (the reference posts
        # ['time', inputTime] for the quantum it just rendered)
        self.input_time = self.timemap.input_time_at(self.output_time)
        return out

    def _hops_to_boundary(self) -> int:
        """Hops renderable before a segment with different parameters takes
        effect (``engine.drive.Drive.params_equal``)."""
        segs = self.timemap.segments
        next_out = None
        for k in range(1, len(segs)):
            if not self.drive.params_equal(segs[k - 1], segs[k]):
                next_out = segs[k].output
                break
        if next_out is None:
            return 1 << 30
        sr = self.sample_rate
        next_out -= self.output_latency / sr
        rendered = self._out_pos + self._fifo.shape[1]
        # hop h samples its params at (rendered + h*I + B/2)/sr (+latency)
        samples_left = (next_out * sr) - rendered - self.block_samples / 2
        return int(np.floor(samples_left / self.interval_samples))

    def _render_hops(self, n_hops: int) -> None:
        sr = self.sample_rate
        audio = self._device_audio()
        packed = packed_rows(1, n_hops, ramps=False)[0]
        rendered = self._out_pos + self._fifo.shape[1]
        seg = self.drive.fill(packed, self.timemap, rendered, n_hops, sr)
        # the gate from the segment, not from the packed float32 fields
        program = self.drive.gated(seg.formant_semitones != 0.0 or seg.formant_compensation)
        dev_packed = torch.from_numpy(packed).to(self.device)
        if self.engine == "fidelity":
            regime = deterministic_regime(unpack(packed, ramps=False)[1].rate, program.interval)
            self._state, out = _fidelity_chunk(program, self._state, audio, dev_packed, regime)
        else:
            self._state, out = _chunk(program, self._state, audio, dev_packed)
        out = out.cpu().numpy()
        self._fifo = np.concatenate([self._fifo, out], axis=1)
        self._since_update += out.shape[1] / sr
        if self._update_cb and self._since_update >= self._update_interval:
            self._since_update = 0.0
            self._update_cb(self.input_time)

    # ------------------------------------------------------------- live mode
    def process(self, input_chunk) -> np.ndarray:
        """Live-input mode: feed a [C, n] (or [n]) chunk, get n stretched
        output samples (the reference's coupled path).  Output lags by
        about one block; chunks of any size are FIFO-buffered around whole
        hops.  Runs the fast engine's live drive."""
        x = np.asarray(input_chunk, np.float32)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.channels, x.shape[0]))
        n = x.shape[1]
        if not hasattr(self, "_live"):
            self._live = init_live_state(self.config, 1, 1, self.device)
            self._live_in = np.zeros((self.channels, 0), np.float32)
            self._live_out = np.zeros((self.channels, 0), np.float32)
        self._live_in = np.concatenate([self._live_in, x], axis=1)
        interval = self.config.interval
        seg = self.timemap.current()
        one = StretchParams.make(
            active=1.0,
            rate=1.0,
            semitones=seg.semitones,
            tonality_hz=seg.tonality_hz,
            formant_semitones=seg.formant_semitones,
            formant_compensation=1.0 if seg.formant_compensation else 0.0,
            formant_base_hz=seg.formant_base_hz,
            sample_rate=self.sample_rate,
            device=self.device,
        )
        params = StretchParams.stack([one])
        while self._live_in.shape[1] >= interval:
            chunk, self._live_in = self._live_in[:, :interval], self._live_in[:, interval:]
            self._live, out = process_live(self.config, self._live,
                                           torch.from_numpy(chunk)[None].to(self.device), params)
            self._live_out = np.concatenate([self._live_out, out[0].cpu().numpy()], axis=1)
        if self._live_out.shape[1] >= n:
            out, self._live_out = self._live_out[:, :n], self._live_out[:, n:]
        else:  # warm-up: pad with leading zeros
            pad = n - self._live_out.shape[1]
            out = np.concatenate([np.zeros((self.channels, pad), np.float32), self._live_out],
                                 axis=1)
            self._live_out = np.zeros((self.channels, 0), np.float32)
        return out

    def flush(self) -> np.ndarray:
        """Emit the remaining overlap-add tail (the reference ``_flush``)."""
        self._state, tail = self.drive.flush(self._state)
        return tail.cpu().numpy()
