"""Frame gather and overlap-add — the time<->frame boundary ops.

Port of ``bauklank_tpu/ops/framing.py`` (``gather_frames``,
``overlap_add``), with the same zero-padding and masking law, so both
functions are bit-identical to the JAX ones.
"""

from __future__ import annotations

import torch

__all__ = ["gather_frames", "overlap_add"]


def gather_frames(signal: torch.Tensor, starts: torch.Tensor, block: int) -> torch.Tensor:
    """signal [C, T], starts [H] -> zero-padded frames [C, H, block].

    Frames overlapping [0, T) read real zeros outside it; frames fully
    outside are masked to zero (the JAX form's clamped dynamic_slice)."""
    c, t = signal.shape
    padded = torch.nn.functional.pad(signal, (block, block))
    st = starts.to(torch.int64)
    first = (st + block).clamp(0, t + block)                    # [H]
    idx = first[:, None] + torch.arange(block, device=signal.device)
    frames = padded[:, idx]                                     # [C, H, block]
    valid = (st > -block) & (st < t)
    return frames * valid[None, :, None]


def overlap_add(frames: torch.Tensor, interval: int, out_len: int) -> torch.Tensor:
    """Overlap-add frames [..., H, B] placed at ``h * interval`` ->
    [..., out_len], summed as diagonals of interval-sized chunks in the
    JAX form's order (chunk k of every frame added in turn)."""
    h, b = frames.shape[-2:]
    k = -(-b // interval)
    pad = k * interval - b
    if pad:
        frames = torch.nn.functional.pad(frames, (0, pad))
    parts = frames.reshape(frames.shape[:-1] + (k, interval))   # [..., H, K, I]
    lead = frames.shape[:-2]
    out = torch.zeros(lead + ((h + k) * interval,), dtype=frames.dtype,
                      device=frames.device)
    for kk in range(k):
        seg = parts[..., kk, :].reshape(lead + (h * interval,))
        out[..., kk * interval: (kk + h) * interval] += seg
    if out.shape[-1] < out_len:
        out = torch.nn.functional.pad(out, (0, out_len - out.shape[-1]))
    return out[..., :out_len]
