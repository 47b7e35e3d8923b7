"""Kernel 2: sequential compensated cumulative sum (``csrc/compsum.cu``).

Replaces ``bauklank_tpu/ops/pallas/compsum.py:comp_cumsum_seq``.
x [K, B, N] f32 -> (hi, lo) [K, B, N] f32: the double-float32 prefix sum
along B, as a left-to-right TwoSum fold.
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["comp_cumsum", "comp_cumsum_ref"]


def comp_cumsum_ref(x: torch.Tensor):
    """Plain version: a Python loop over B of vectorized TwoSum ops."""
    hi = torch.empty_like(x)
    lo = torch.empty_like(x)
    ah = torch.zeros_like(x[:, 0])
    al = torch.zeros_like(x[:, 0])
    for b in range(x.shape[1]):
        xv = x[:, b]
        s1 = ah + xv
        v = s1 - ah
        e = (ah - (s1 - v)) + (xv - v)
        lo_b = al + e
        s = s1 + lo_b
        nl = lo_b - (s - s1)
        hi[:, b] = s
        lo[:, b] = nl
        ah, al = s, nl
    return hi, lo


def comp_cumsum(x: torch.Tensor):
    name = "comp_cumsum"
    require(x.dim() == 3, name, "expects x [K, B, N]")
    require(x.dtype == torch.float32, name, "x must be float32")
    if not on_cuda(name, x):
        return comp_cumsum_ref(x)
    require(x.is_contiguous(), name, "x must be contiguous")
    k_n, b_n, n_n = x.shape
    hi = torch.empty_like(x)
    lo = torch.empty_like(x)
    err = library().bk_comp_cumsum(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), k_n, b_n, n_n, stream_of(x))
    check(err, name)
    LAUNCHES[name] += 1
    return hi, lo
