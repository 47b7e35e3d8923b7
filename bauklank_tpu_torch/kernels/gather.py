"""Kernels 3 and 6: the fractional row gather (``csrc/frac_gather.cu``).

planes [N, B, P] f32, pos [N, K] f32 -> [N, K, P] f32: linear
interpolation of each row at ``pos`` with zeros outside [0, B), the
semantics and rounding of ``engine.spectral._get_fractional``.  Two
entry points over one device function:

- :func:`frac_gather` replaces
  ``bauklank_tpu/ops/pallas/wintaps.py:window_taps_fused`` plus its
  caller's weighted combine, and the one-hot block gathers of the MINSTD
  regime; the fidelity step calls it.
- :func:`pallas_gather` replaces
  ``bauklank_tpu/ops/pallas/selection.py:pallas_gather``, the TPU's
  drop-in for the block gather.  No step calls it, there as here.  The
  TPU kernel's shape limits (``pallas_supported``) and its ``k_tile`` do
  not exist on the card: every shape is served.

Each has its own C entry point and its own launch count;
:func:`frac_gather_ref` is the plain version of both.  The device function
knows P at compile time for P in {1, 2, 3, 4, 6} (one or two channels) and
moves rows as 8- or 16-byte vectors; any other P takes its scalar
kernel.  N * K * P may exceed 2^31 elements (64-bit offsets).
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["frac_gather", "frac_gather_ref", "pallas_gather"]


def frac_gather_ref(planes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain version: ``_get_fractional`` on tensors."""
    n_n, b_n, p_n = planes.shape
    k_n = pos.shape[1]
    f0 = torch.floor(pos)
    i0 = f0.to(torch.int64)
    frac = pos - f0

    def at(i):
        ok = ((i >= 0) & (i < b_n)).to(planes.dtype)
        idx = i.clamp(0, b_n - 1)[:, :, None].expand(n_n, k_n, p_n)
        return torch.gather(planes, 1, idx) * ok[..., None]

    return at(i0) * (1.0 - frac)[..., None] + at(i0 + 1) * frac[..., None]


def _gather(name: str, planes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    require(planes.dim() == 3 and pos.dim() == 2, name,
            "expects planes [N, B, P] and pos [N, K]")
    require(planes.dtype == torch.float32 and pos.dtype == torch.float32, name,
            "planes and pos must be float32")
    require(planes.shape[0] == pos.shape[0], name, "planes and pos disagree on N")
    if not on_cuda(name, planes, pos):
        return frac_gather_ref(planes, pos)
    require(planes.is_contiguous() and pos.is_contiguous(), name,
            "operands must be contiguous")
    # rows of planes, positions and outputs move as float4 or float2
    require(planes.data_ptr() % 16 == 0 and pos.data_ptr() % 16 == 0, name,
            "operands must be 16-byte aligned")
    n_n, b_n, p_n = planes.shape
    require(b_n >= 1, name, "planes have no bands")
    k_n = pos.shape[1]
    out = torch.empty((n_n, k_n, p_n), dtype=torch.float32, device=planes.device)
    err = getattr(library(), f"bk_{name}")(
        planes.data_ptr(), pos.data_ptr(), out.data_ptr(), n_n, b_n, p_n, k_n,
        stream_of(planes))
    check(err, name)
    LAUNCHES[name] += 1
    return out


def frac_gather(planes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return _gather("frac_gather", planes, pos)


def pallas_gather(arrs: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return _gather("pallas_gather", arrs, pos)
