"""Kernel 5: banded linear interpolation (``csrc/interp.cu``).

Replaces ``bauklank_tpu/ops/pallas/interp.py:banded_interp``, the fast
engine's pitch-map gather.  x [S, P, bins] f32, pos [S, bins_out] f32
(monotone per stream) -> [S, P, bins_out] f32, with the TPU kernel's
windowed function: each 128-wide output tile reads a window of
``min(window + 128, bins)`` input bands starting at a 128-aligned
``start``, and a tap outside that window or outside [0, bins) reads 0.
``bins_out`` must be a multiple of 128.
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["TILE", "banded_interp", "banded_interp_ref"]

TILE = 128


def banded_interp_ref(x: torch.Tensor, pos: torch.Tensor, window: int = 768) -> torch.Tensor:
    """Plain version: the kernel's arithmetic on whole tensors."""
    s_n, p_n, bins = x.shape
    bins_out = pos.shape[1]
    win = min(window + TILE, bins)
    first = torch.floor(pos[:, ::TILE]).to(torch.int64) - 1          # [S, tiles]
    start = (first.clamp(0, max(bins - win, 0)) // TILE) * TILE
    start = start.repeat_interleave(TILE, dim=1)                       # [S, bins_out]
    rel = pos - start.to(torch.float32)
    f0 = torch.floor(rel)
    i0 = f0.to(torch.int64)
    w = rel - f0
    g0 = start + i0

    def tap(i, g):
        ok = (i >= 0) & (i < win) & (g >= 0) & (g < bins)               # [S, bins_out]
        idx = g.clamp(0, bins - 1)[:, None, :].expand(s_n, p_n, bins_out)
        return ok, torch.where(ok[:, None, :], torch.gather(x, 2, idx), 0.0)

    ok0, x0 = tap(i0, g0)
    ok1, x1 = tap(i0 + 1, g0 + 1)
    a = torch.where(ok0, 1.0 - w, 0.0)
    b = torch.where(ok1, w, 0.0)
    return x0 * a[:, None, :] + x1 * b[:, None, :]


def banded_interp(x: torch.Tensor, pos: torch.Tensor, window: int = 768) -> torch.Tensor:
    name = "banded_interp"
    require(x.dim() == 3 and pos.dim() == 2, name,
            "expects x [S, P, bins] and pos [S, bins_out]")
    require(x.dtype == torch.float32 and pos.dtype == torch.float32, name,
            "x and pos must be float32")
    require(x.shape[0] == pos.shape[0], name, "x and pos disagree on S")
    require(pos.shape[1] % TILE == 0, name,
            f"bins_out {pos.shape[1]} must be a multiple of {TILE}")
    require(window >= 1, name, f"window {window} must be positive")
    if not on_cuda(name, x, pos):
        return banded_interp_ref(x, pos, window)
    require(x.is_contiguous() and pos.is_contiguous(), name, "operands must be contiguous")
    s_n, p_n, bins = x.shape
    bins_out = pos.shape[1]
    out = torch.empty((s_n, p_n, bins_out), dtype=torch.float32, device=x.device)
    err = library().bk_banded_interp(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(), s_n, p_n, bins, bins_out,
        min(window + TILE, bins), stream_of(x))
    check(err, name)
    LAUNCHES[name] += 1
    return out
