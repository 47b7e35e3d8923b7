"""Offline stretch driver: whole-track rendering in hop chunks.

Port of ``bauklank_tpu/engine/offline.py``.  The output timeline is cut
into fixed-size hop chunks; each chunk's input frame positions are
computed on the host and :func:`engine.core.process_chunk` runs the
chunk, carrying the engine state to the next.  The chunk loop is a plain
Python loop (the JAX form's ``lax.scan`` over chunks exists to make one
dispatch of the whole track).
"""

from __future__ import annotations

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import init_state, process_chunk
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["stretch_offline", "frame_ends_for", "CHUNK_HOPS"]

CHUNK_HOPS = 64  # hops per chunk at least: balances FFT batch size vs memory


def frame_ends_for(config: StretchConfig, out_start: int, n_hops: int, rate,
                   in_start: float = 0.0) -> np.ndarray:
    """Input analysis-frame ends for hops covering output samples
    ``[out_start, out_start + n_hops * interval)`` at a fixed rate: hop
    ``h``'s output frame centre is ``out_start + h*I + B/2``, its input
    centre ``in_start + centre * rate``, its frame end the centre + B/2.
    At rate 1 and in_start 0 this is ``h*I + B`` (sample-exact identity)."""
    b, i = config.block, config.interval
    h = np.arange(n_hops, dtype=np.float64)
    centers = (np.asarray(in_start, np.float64)
               + (out_start + h * i + b / 2.0) * np.asarray(rate, np.float64))
    return np.round(centers).astype(np.int64) + b // 2


def stretch_offline(audio, rate: float, config: StretchConfig,
                    params: StretchParams | None = None, n_out: int | None = None,
                    chunk_hops: int = CHUNK_HOPS, device=DEFAULT_DEVICE) -> np.ndarray:
    """Render a whole track at a fixed stretch rate (and the params' pitch
    and formant controls) on ``device``.

    audio [C, T] float32; rate = input samples per output sample (0.5 =
    twice as long).  ``params`` holds one stream's controls (scalars, as
    :meth:`StretchParams.make` gives them).  Returns [C, n_out] float32."""
    dev = resolve_device(device)
    audio = torch.as_tensor(np.asarray(audio, np.float32)).to(dev)
    if audio.dim() != 2 or audio.shape[0] != config.channels:
        raise ValueError(f"audio must be [{config.channels}, T], got {tuple(audio.shape)}")
    t_in = audio.shape[1]
    if n_out is None:
        n_out = int(round(t_in / max(rate, 1e-9)))
    if params is None:
        params = StretchParams.make(rate=rate, device=dev)
    params = StretchParams(*[torch.as_tensor(f, dtype=torch.float32).reshape(1).to(dev)
                             for f in params])

    i = config.interval
    total_hops = -(-n_out // i)
    # bigger hop chunks use the card better; bounded so frames fit in memory
    chunk_hops = max(chunk_hops, min(512, total_hops))
    state = init_state(config, dev)
    outs = []
    for ci in range(-(-total_hops // chunk_hops)):
        ends = frame_ends_for(config, ci * chunk_hops * i, chunk_hops, rate)
        state, out = process_chunk(config, state, audio[None],
                                   torch.from_numpy(ends.astype(np.int32))[None].to(dev), params)
        outs.append(out[0])
    return torch.cat(outs, dim=-1)[:, :n_out].cpu().numpy()
