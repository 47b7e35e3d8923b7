"""The engine's drive: what ``serve.pool.StreamPool``,
``serve.livepool.LivePool`` and ``node.StretchNode`` hand either engine,
written once: the geometry (:func:`geometry`), the packed rows of a step
(:meth:`Drive.fill`, :func:`unpack`: a voice's H frame ends, the seven
:class:`StretchParams` fields and, in a pool's row, the gain and pan
ramps; one float32 array a step, copied to the device once), the formant
gate (:meth:`Drive.gated`), the fidelity engine's regime word
(:func:`deterministic_regime`) and controls (:func:`fidelity_operands`),
and each engine's fresh state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bauklank_tpu_torch.engine.batched import formants_off, init_batched_state
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import flush as engine_flush
from bauklank_tpu_torch.engine.core import init_state
from bauklank_tpu_torch.engine.fidelity import (SpectralConfig, init_batched_fidelity_state,
                                                init_batched_live_fidelity_state,
                                                init_fidelity_state)
from bauklank_tpu_torch.engine.live import init_live_state
from bauklank_tpu_torch.engine.params import StretchParams

__all__ = ["Drive", "geometry", "packed_rows", "params_of", "unpack", "uses_formants",
           "deterministic_regime", "fidelity_operands", "fidelity_controls"]

PARAMS = 7  # a row's StretchParams fields, after its H frame ends
RAMPS = 4   # a pool row's gain (start, end) and pan (start, end), after its fields


@dataclasses.dataclass(frozen=True)
class Drive:
    """One engine at one geometry (:func:`geometry`): ``config`` (the fast
    engine's program; its split is the fidelity engine's too), ``scfg``
    (the fidelity engine's program, None for the fast engine), the
    ``block`` and ``interval`` the engine runs, its latencies in samples,
    and ``centre``, where a hop samples the time map after its
    output-counter position (the fidelity worklet at the position, the
    fast engine at the output frame's centre)."""

    config: StretchConfig
    scfg: SpectralConfig | None
    block: int
    interval: int
    input_latency: int
    output_latency: int
    centre: int

    def fill(self, row: np.ndarray, timemap, out_pos: int, hops: int, sample_rate: float,
             loaded: bool = True, ramps: tuple | None = None):
        """Fill a voice's packed ``row``: ``hops`` frame ends (hop k's from
        the ``timemap`` at output sample ``out_pos + k * interval``), the
        seven fields of the segment current at the last hop (active only
        where ``loaded``), then a pool's ``ramps``.  Returns the segment."""
        sr, interval, centre, half = sample_rate, self.interval, self.centre, self.block // 2
        out_lat = self.output_latency
        seg = None
        for k in range(hops):
            out_t = (out_pos + k * interval + centre) / sr + out_lat / sr
            row[k] = float(int(round(timemap.input_time_at(out_t) * sr)) + half)
            seg = timemap.current()
        row[hops: hops + PARAMS] = params_of(seg, sr, seg.active and loaded)
        if ramps is not None:
            row[hops + PARAMS:] = ramps
        return seg

    def params_equal(self, a, b) -> bool:
        """Whether two segments share every field a chunk holds fixed:
        timing rides the frame ends, but the fidelity engine takes rate as
        a spectral control (its time factor), so rate splits its chunks."""
        return (a.active == b.active and a.semitones == b.semitones
                and a.tonality_hz == b.tonality_hz
                and a.formant_semitones == b.formant_semitones
                and a.formant_compensation == b.formant_compensation
                and a.formant_base_hz == b.formant_base_hz
                and (self.scfg is None or a.rate == b.rate))

    def gated(self, formants: bool) -> StretchConfig | SpectralConfig:
        """A step's program: the formant chain only where ``formants``,
        some voice on a formant control (as the reference engine gates)."""
        if self.scfg is not None:
            return self.scfg._replace(formants=True) if formants else self.scfg
        return self.config if formants or not self.config.formants else formants_off(self.config)

    def state(self, device):
        """A node's fresh state: one stream."""
        return (init_state(self.config, device) if self.scfg is None
                else init_fidelity_state(self.scfg, device))

    def states(self, n: int, device):
        """A pool's fresh state: ``n`` streams."""
        return (init_batched_state(self.config, n, device) if self.scfg is None
                else init_batched_fidelity_state(self.scfg, n, device))

    def live_states(self, hops: int, n: int, device):
        """A live pool's fresh state: ``n`` streams, ``hops`` a step."""
        return (init_live_state(self.config, hops, n, device) if self.scfg is None
                else init_batched_live_fidelity_state(self.scfg, hops, n, device))

    def flush(self, state):
        """A node's state with its overlap-add tail emptied, and the tail
        [C, n]: the reference ``_flush``."""
        if self.scfg is None:
            state, tail = engine_flush(self.config, state)
            return state, tail[0]
        spec, tail = state
        return (spec, torch.zeros_like(tail)), tail


def geometry(engine: str, channels: int, sample_rate: float, config: StretchConfig | None = None,
             block: int | None = None, interval: int | None = None, split: bool = True) -> Drive:
    """The drive of ``engine``.  ``block`` and ``interval`` (samples, given
    together, never with ``config``) are a deployment's own: the fidelity
    engine runs them raw, as the blob does (the kiosk's 8820/8820); the
    fast engine's ``StretchConfig`` rounds the block onto the FFT grid.  A
    ``config`` runs as it is (the JAX pool's geometry).  With neither, the
    120/30 ms preset (raw 5292/1323 at 44.1 kHz; ``preset_default``)."""
    if engine not in ("fast", "fidelity"):
        raise ValueError(f"unknown engine {engine!r}")
    if (block is None) != (interval is None):
        raise ValueError(f"block={block} and interval={interval}: give both or neither")
    if config is None:
        block, interval = ((round(sample_rate * 0.12), round(sample_rate * 0.03)) if block is None
                           else (int(block), int(interval)))
        config = StretchConfig(channels=channels, block=block, interval=interval,
                               split_computation=split)
    elif block is not None:
        raise ValueError("give a config or block and interval, not both")
    else:
        block, interval = config.block, config.interval
    if engine == "fast":
        return Drive(config, None, config.block, config.interval, config.input_latency,
                     config.output_latency, config.block // 2)
    split = config.split_computation
    return Drive(config, SpectralConfig(channels, block, interval, split=split), block,
                 interval, block // 2, (block - block // 2) + (interval if split else 0), 0)


def packed_rows(n: int, hops: int, ramps: bool = True) -> np.ndarray:
    """``n`` zeroed rows: ``hops`` frame ends, seven fields, ``ramps``."""
    return np.zeros((n, hops + PARAMS + (RAMPS if ramps else 0)), np.float32)


def params_of(seg, sample_rate: float, active, rate: float | None = None) -> tuple:
    """A segment's seven fields (frequencies in cycles/sample), with
    ``active`` and any ``rate`` given (a live stream's 1.0) for its own."""
    return (1.0 if active else 0.0, seg.rate if rate is None else rate,
            2.0 ** (seg.semitones / 12.0), seg.tonality_hz / sample_rate,
            2.0 ** (seg.formant_semitones / 12.0), 1.0 if seg.formant_compensation else 0.0,
            seg.formant_base_hz / sample_rate)


def unpack(packed, ramps: bool = True):
    """(frame ends, StretchParams, gains, pans) of packed rows, numpy or
    torch: a pool's [S, H + 11], or without ``ramps`` (empty gains and
    pans) a node's [H + 7] or a live pool's [S, 7]."""
    h = packed.shape[-1] - PARAMS - (RAMPS if ramps else 0)
    p = h + PARAMS
    return (packed[..., :h], StretchParams(*[packed[..., h + i] for i in range(PARAMS)]),
            packed[..., p: p + 2], packed[..., p + 2: p + 4])


def uses_formants(params: StretchParams) -> bool:
    """Whether a voice of a step's packed fields is on a formant control."""
    return bool(np.any(params.formant_factor != 1.0) or np.any(params.formant_compensation != 0.0))


def deterministic_regime(rates: np.ndarray, interval: int) -> bool:
    """The fidelity engine's regime word: whether every voice's time
    factor, as :func:`fidelity_operands` computes it on the device, is <= 2
    (above it the MINSTD draws run), by the same float32 operations on the
    host, so that a step need not wait for the device to learn it."""
    tf = np.minimum(np.float32(1.0) / np.maximum(rates, np.float32(1e-6)),
                    np.float32(interval))
    return bool(np.all(tf <= np.float32(2.0)))


def fidelity_operands(scfg: SpectralConfig, packed: torch.Tensor, ramps: bool = True):
    """(frame ends, time factor, *:func:`fidelity_controls`) of rows."""
    ends, params, _, _ = unpack(packed, ramps)
    ends = ends.to(torch.int32)
    # blob seek law: the effective timeFactor saturates at `interval` when
    # the rate advances < 1 input sample per hop
    tf = torch.clamp_max(1.0 / torch.clamp_min(params.rate, 1e-6), float(scfg.interval))
    return (ends, tf, *fidelity_controls(scfg, params))


def fidelity_controls(scfg: SpectralConfig, params: StretchParams):
    """The blob's controls of the fields but rate (a live stream never
    seeks): multiplier, limit, active and the three formant controls (None
    where ``scfg.formants`` is off)."""
    limit = params.tonality / torch.sqrt(params.transpose_factor)
    formants = ((params.formant_factor, params.formant_compensation, params.formant_base)
                if scfg.formants else (None, None, None))
    return (params.transpose_factor, limit, params.active, *formants)
