"""Live-input processing: coupled input/output streaming (fast engine).

Port of ``bauklank_tpu/engine/live.py``, batched over a leading stream
axis as :func:`engine.core.process_chunk` is.  Each stream keeps an input
ring in its state; a step appends one chunk (``hops * interval`` samples)
to every ring, analyses at ring positions that advance in lockstep with
the output, and runs the fast engine's chunk on the rings.  Pitch and
formant controls apply as in file mode; the time rate is 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import (
    StretchState,
    fresh_state,
    process_chunk,
    stretch_state_from_numpy,
    stretch_state_to_numpy,
)
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["LiveState", "ring_len", "init_live_state", "process_live",
           "live_state_from_numpy", "live_state_to_numpy"]


class LiveState(NamedTuple):
    engine: StretchState
    ring: torch.Tensor  # [S, C, R] most recent input samples (R fixed)


def ring_len(config: StretchConfig, hops_per_chunk: int) -> int:
    return config.block + config.interval + hops_per_chunk * config.interval


def init_live_state(config: StretchConfig, hops_per_chunk: int = 1, n_streams: int = 1,
                    device=DEFAULT_DEVICE) -> LiveState:
    """Fresh live state of ``n_streams`` streams on ``device``."""
    device = resolve_device(device)
    return LiveState(
        engine=fresh_state(config, n_streams, device),
        ring=torch.zeros((n_streams, config.channels, ring_len(config, hops_per_chunk)),
                         dtype=torch.float32, device=device),
    )


def process_live(config: StretchConfig, state: LiveState, chunk: torch.Tensor,
                 params: StretchParams):
    """Consume ``chunk`` [S, C, H * interval] of live input per stream and
    produce as many output samples.  Returns (state, out [S, C, H *
    interval])."""
    s_n, _, n = chunk.shape
    interval = config.interval
    h = n // interval
    if h * interval != n:
        raise ValueError(f"chunk of {n} samples is not a whole number of {interval}-sample hops")
    r = state.ring.shape[-1]
    ring = torch.cat([state.ring[..., n:], chunk.to(torch.float32)], dim=-1)
    # hop i analyses the frame ending (i + 1) intervals past the ring's
    # previous end: input is consumed in lockstep with output (rate 1)
    ends = r - n + (torch.arange(h, dtype=torch.int32, device=ring.device) + 1) * interval
    engine, out = process_chunk(config, state.engine, ring, ends[None].expand(s_n, h), params)
    return LiveState(engine=engine, ring=ring), out


def live_state_from_numpy(tree, device) -> LiveState:
    """The JAX ``LiveState`` with numpy leaves (any leading batch axes) ->
    the port's tensors on ``device``."""
    engine, ring = tree
    return LiveState(engine=stretch_state_from_numpy(engine, device),
                     ring=torch.from_numpy(np.array(ring, dtype=np.float32)).to(device))


def live_state_to_numpy(state: LiveState) -> LiveState:
    """Inverse of :func:`live_state_from_numpy`."""
    return LiveState(engine=stretch_state_to_numpy(state.engine),
                     ring=state.ring.detach().cpu().numpy())
