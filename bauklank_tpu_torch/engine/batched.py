"""Batched multi-stream engine: many independent stretch voices per card.

Port of ``bauklank_tpu/engine/batched.py``.  The port's
:func:`engine.core.process_chunk` is batched over a leading stream axis
already, so this is the thin layer the pool calls: per-stream rate,
pitch, formants and activity are data; the block/interval shape is one
static :class:`StretchConfig` for the whole batch.
"""

from __future__ import annotations

import dataclasses

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import StretchState, fresh_state, process_chunk
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["init_batched_state", "batched_process_chunk", "batched_step_jit", "formants_off"]


def init_batched_state(config: StretchConfig, n_streams: int,
                       device=DEFAULT_DEVICE) -> StretchState:
    """Fresh state of ``n_streams`` streams on ``device``."""
    return fresh_state(config, n_streams, resolve_device(device))


def batched_process_chunk(config: StretchConfig, states: StretchState, audios,
                          frame_ends, params: StretchParams):
    """:func:`process_chunk` over the leading stream axis.

    states [S]; audios [S, C, T]; frame_ends [S, H]; params [S] fields.
    Returns (states, out [S, C, H * interval]).  Callers that know on the
    host that no stream uses formant controls pass ``formants_off(config)``:
    the formant chain is three extra FFT passes and two gathers over every
    hop, and the reference engine likewise runs it only when a formant
    control is set."""
    return process_chunk(config, states, audios, frame_ends, params)


def formants_off(config: StretchConfig) -> StretchConfig:
    """The same engine shape with the formant chain left out (the state is
    the same, so states flow between the two step variants)."""
    return dataclasses.replace(config, formants=False)


def batched_step_jit(config: StretchConfig, states: StretchState, audios, frame_ends,
                     params: StretchParams):
    """The serving step under the JAX package's name: the batched step
    itself.  JAX compiles it and donates the states; PyTorch runs eagerly
    and allocates the new states, so it needs no compile-and-donate
    wrapper.  Do not reuse ``states`` after the call, as JAX's donation
    forbids."""
    return batched_process_chunk(config, states, audios, frame_ends, params)
