"""Kernel 8: the smoothing pass of the fidelity step's stage 2
(``csrc/smooth.cu``).

Replaces no TPU kernel: the JAX package runs the smoother's affine scans
as ``lax.associative_scan``.  e [N, B] f32 -> [N, B]: two chained
bidirectional one-pole smoothers (:func:`smooth_bidirectional`), the
first from a zero carry, the second from the first one's last value, with
one coefficient for every row or one a row.
"""

from __future__ import annotations

import numpy as np
import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library
from bauklank_tpu_torch.ops.scan import associative_scan

__all__ = ["smooth_pair", "smooth_pair_ref", "smooth_bidirectional", "smem_bytes", "SMEM_LIMIT"]

# the dynamic shared memory a block may take on the H100 (227 KB), less
# room for the kernel's static arrays
SMEM_LIMIT = 232448 - 1024


def smem_bytes(b_n: int) -> int:
    """Shared memory of the card kernel's block for rows of ``b_n`` bands:
    the row, its scanned ``a`` and every tree level of ``b``."""
    floats, n = 2 * b_n, b_n
    while n >= 1:
        floats, n = floats + n, n >> 1
    return 4 * floats


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of y_k = a_k y_{k-1} + b_k along the last axis, in
    JAX's ``lax.associative_scan`` order (the same combine tree, so the
    same roundings) with compose((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)."""
    def compose(x, y):
        (a1, b1), (a2, b2) = x, y
        return [a1 * a2, a2 * b1 + b2]

    return tuple(associative_scan(compose, [a, b], dim=-1))


def smooth_bidirectional(e: torch.Tensor, coef, carry: torch.Tensor):
    """The blob's two-pass one-pole smoother (backward then forward) with
    the carry threaded between passes: y_b = y_prev + coef (e_b - y_prev)
    as two affine scans.  e [..., B] -> (smoothed [..., B], carry [...]).
    ``coef``: a Python float, whose ``1 - coef`` is taken in float64 and
    then rounded, or a tensor over the leading axes (one coefficient per
    row), whose ``1 - coef`` is taken in float32; both as in JAX."""
    if isinstance(coef, (float, int)):
        a = torch.full_like(e, float(np.float32(1.0 - coef)))
        cf = torch.full_like(e, float(np.float32(coef)))
    else:
        cf = coef.to(e.dtype)[..., None].expand(e.shape)
        a = 1.0 - cf

    def affine(vals, c0):
        aa, bb = _affine_scan(a, cf * vals)
        return aa * c0[..., None] + bb

    bwd = affine(e.flip(-1), carry).flip(-1)
    fwd = affine(bwd, bwd[..., 0])
    return fwd, fwd[..., -1]


def smooth_pair_ref(e: torch.Tensor, coef) -> torch.Tensor:
    """Plain version: the two chained smoothers as the JAX package runs
    them."""
    sm, carry = smooth_bidirectional(e, coef, torch.zeros_like(e[:, 0]))
    return smooth_bidirectional(sm, coef, carry)[0]


def smooth_pair(e: torch.Tensor, coef) -> torch.Tensor:
    """``coef``: a Python float for every row, or a float tensor [N]."""
    name = "smooth_pair"
    require(e.dim() == 2, name, "expects e [N, B]")
    require(e.dtype == torch.float32, name, "e must be float32")
    scalar = isinstance(coef, (float, int))
    if not scalar:
        require(isinstance(coef, torch.Tensor) and coef.shape == e.shape[:1]
                and coef.is_floating_point(), name, "coef must be a float or a float tensor [N]")
    if not on_cuda(name, e, *([] if scalar else [coef])):
        return smooth_pair_ref(e, coef)
    require(e.is_contiguous(), name, "e must be contiguous")
    n_n, b_n = e.shape
    require(smem_bytes(b_n) <= SMEM_LIMIT, name,
            f"{b_n} bands need {smem_bytes(b_n)} bytes of shared memory, more than a block "
            f"takes ({SMEM_LIMIT})")
    out = torch.empty_like(e)
    # (a rows, cf rows, a, cf): the rows' pointers, or one pair for all
    if scalar:
        coefs = (None, None, float(np.float32(1.0 - coef)), float(np.float32(coef)))
    else:
        cf = coef.to(torch.float32).contiguous()
        a = 1.0 - cf
        coefs = (a.data_ptr(), cf.data_ptr(), 0.0, 0.0)
    err = library().bk_smooth_pair(e.data_ptr(), *coefs, out.data_ptr(), n_n, b_n,
                                   stream_of(e))
    check(err, name)
    LAUNCHES[name] += 1
    return out
