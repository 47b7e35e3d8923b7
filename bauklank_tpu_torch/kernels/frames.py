"""Kernel 1: windowed analysis-frame fetch (``csrc/frames.cu``).

Replaces ``bauklank_tpu/ops/pallas/frames.py:gather_frames_windowed``.
audio [S, C, T] f32, starts [S, F] int32, window [block] f32 ->
[S, F, C, block] f32, zeros where ``start + i`` falls outside [0, T).
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["frames_windowed", "frames_windowed_ref"]


def frames_windowed_ref(audio: torch.Tensor, starts: torch.Tensor,
                        window: torch.Tensor) -> torch.Tensor:
    """Plain version: one gather and one multiply."""
    s_n, c_n, t_n = audio.shape
    f_n = starts.shape[1]
    block = window.shape[0]
    idx = starts.to(torch.int64)[:, :, None] + torch.arange(block, device=audio.device)
    ok = (idx >= 0) & (idx < t_n)                               # [S, F, block]
    g = torch.gather(
        audio[:, None].expand(s_n, f_n, c_n, t_n), 3,
        idx.clamp(0, t_n - 1)[:, :, None, :].expand(s_n, f_n, c_n, block),
    )
    return torch.where(ok[:, :, None, :], g * window, torch.zeros((), device=audio.device))


def frames_windowed(audio: torch.Tensor, starts: torch.Tensor,
                    window: torch.Tensor) -> torch.Tensor:
    name = "frames_windowed"
    require(audio.dim() == 3 and starts.dim() == 2 and window.dim() == 1, name,
            "expects audio [S, C, T], starts [S, F], window [block]")
    require(audio.dtype == torch.float32 and window.dtype == torch.float32, name,
            "audio and window must be float32")
    require(starts.dtype == torch.int32, name, "starts must be int32")
    require(starts.shape[0] == audio.shape[0], name, "starts and audio disagree on S")
    if not on_cuda(name, audio, starts, window):
        return frames_windowed_ref(audio, starts, window)
    require(audio.is_contiguous() and starts.is_contiguous() and window.is_contiguous(),
            name, "operands must be contiguous")
    s_n, c_n, t_n = audio.shape
    f_n, block = starts.shape[1], window.shape[0]
    out = torch.empty((s_n, f_n, c_n, block), dtype=torch.float32, device=audio.device)
    err = library().bk_frames_windowed(
        audio.data_ptr(), starts.data_ptr(), window.data_ptr(), out.data_ptr(),
        s_n, c_n, t_n, f_n, block, stream_of(audio))
    check(err, name)
    LAUNCHES[name] += 1
    return out
