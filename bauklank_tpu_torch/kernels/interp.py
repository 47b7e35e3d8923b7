"""Kernel 5: banded linear interpolation (``csrc/interp.cu``).

Replaces ``bauklank_tpu/ops/pallas/interp.py:banded_interp``, the fast
engine's pitch-map gather.  x [S, P, bins] f32, pos [S, bins_out] f32
(monotone per stream) -> [S, P, bins_out] f32, with the TPU kernel's
windowed function: each 128-wide output tile reads a window of
``min(window + 128, bins)`` input bands starting at a 128-aligned
``start``, and a tap outside that window or outside [0, bins) reads 0.
``bins_out`` must be a multiple of 128.

Two entry points over one device function, both counted as
``banded_interp``: :func:`banded_interp` takes planar real rows,
:func:`banded_interp_complex` interleaved complex ones (x
``torch.view_as_real`` of complex64 spectra, [S, P, bins, 2] ->
[S, P, bins_out, 2]), component by component the same arithmetic, so a
complex gather needs no planar copy before it and none after.
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["TILE", "banded_interp", "banded_interp_ref", "banded_interp_complex"]

TILE = 128


def _taps(pos: torch.Tensor, bins: int, window: int):
    """The two taps of every output band: (band index clamped into
    [0, bins), ok, weight), each [S, bins_out]."""
    win = min(window + TILE, bins)
    first = torch.floor(pos[:, ::TILE]).to(torch.int64) - 1          # [S, tiles]
    start = (first.clamp(0, max(bins - win, 0)) // TILE) * TILE
    start = start.repeat_interleave(TILE, dim=1)                       # [S, bins_out]
    rel = pos - start.to(torch.float32)
    f0 = torch.floor(rel)
    i0 = f0.to(torch.int64)
    w = rel - f0
    g0 = start + i0

    def tap(i, g, weight):
        ok = (i >= 0) & (i < win) & (g >= 0) & (g < bins)
        return g.clamp(0, bins - 1), ok, torch.where(ok, weight, 0.0)

    return tap(i0, g0, 1.0 - w), tap(i0 + 1, g0 + 1, w)


def banded_interp_ref(x: torch.Tensor, pos: torch.Tensor, window: int = 768) -> torch.Tensor:
    """Plain version of both entry points: the kernel's arithmetic on whole
    tensors, along axis 2 of planar x [S, P, bins] or, component by
    component, of interleaved x [S, P, bins, 2]."""
    trail = (1,) * (x.dim() - 3)
    wide = lambda t: t.reshape(t.shape[0], 1, t.shape[1], *trail)    # over P and the trail
    shape = x.shape[:2] + (pos.shape[1],) + x.shape[3:]
    total = None
    for idx, ok, weight in _taps(pos, x.shape[2], window):
        v = torch.where(wide(ok), torch.gather(x, 2, wide(idx).expand(shape)), 0.0)
        total = v * wide(weight) if total is None else total + v * wide(weight)
    return total


def _launch(entry: str, x: torch.Tensor, pos: torch.Tensor, window: int,
            out: torch.Tensor) -> torch.Tensor:
    s_n, p_n, bins = x.shape[:3]
    err = getattr(library(), entry)(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(), s_n, p_n, bins, pos.shape[1],
        min(window + TILE, bins), stream_of(x))
    check(err, "banded_interp")
    LAUNCHES["banded_interp"] += 1
    return out


def _check(name: str, x: torch.Tensor, pos: torch.Tensor, window: int) -> None:
    require(x.dtype == torch.float32 and pos.dtype == torch.float32, name,
            "x and pos must be float32")
    require(x.shape[0] == pos.shape[0], name, "x and pos disagree on S")
    require(x.shape[2] >= 1, name, "x has no bands")
    require(pos.shape[1] % TILE == 0, name,
            f"bins_out {pos.shape[1]} must be a multiple of {TILE}")
    require(window >= 1, name, f"window {window} must be positive")


def banded_interp(x: torch.Tensor, pos: torch.Tensor, window: int = 768) -> torch.Tensor:
    name = "banded_interp"
    require(x.dim() == 3 and pos.dim() == 2, name,
            "expects x [S, P, bins] and pos [S, bins_out]")
    _check(name, x, pos, window)
    if not on_cuda(name, x, pos):
        return banded_interp_ref(x, pos, window)
    require(x.is_contiguous() and pos.is_contiguous(), name, "operands must be contiguous")
    out = torch.empty(x.shape[:2] + (pos.shape[1],), dtype=torch.float32, device=x.device)
    return _launch("bk_banded_interp", x, pos, window, out)


def banded_interp_complex(x: torch.Tensor, pos: torch.Tensor, window: int = 768) -> torch.Tensor:
    """x [S, P, bins, 2] f32 (re, im interleaved), pos [S, bins_out] ->
    [S, P, bins_out, 2]: :func:`banded_interp` of both components, equal to
    it bit for bit on the planar copy of the same rows."""
    name = "banded_interp_complex"
    require(x.dim() == 4 and x.shape[3] == 2 and pos.dim() == 2, name,
            "expects x [S, P, bins, 2] and pos [S, bins_out]")
    _check(name, x, pos, window)
    if not on_cuda(name, x, pos):
        return banded_interp_ref(x, pos, window)
    require(x.is_contiguous() and pos.is_contiguous(), name, "operands must be contiguous")
    # a tap moves as one float2
    require(x.data_ptr() % 8 == 0, name, "x must be 8-byte aligned")
    out = torch.empty(x.shape[:2] + (pos.shape[1], 2), dtype=torch.float32, device=x.device)
    return _launch("bk_banded_interp_c", x, pos, window, out)
