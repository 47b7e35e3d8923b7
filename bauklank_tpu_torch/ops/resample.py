"""Fractional-rate resampling (batched cubic Lagrange interpolation).

Port of ``bauklank_tpu/ops/resample.py``: the same 4-tap Lagrange read at
positions ``start + j * ratio``, as PyTorch ops on the signal's device
(``torch.gather`` in place of ``take_along_axis``), with zeros outside
``[0, T)``.  The I/O layer uses it to bring a track to the pool's sample
rate (:func:`bauklank_tpu_torch.utils.audio.load_audio`).  It is plain
tensor code in both packages; no kernel of either stands behind it.
"""

from __future__ import annotations

import torch

__all__ = ["resample"]


def resample(signal: torch.Tensor, ratio, out_len: int, start=0.0) -> torch.Tensor:
    """Read ``signal`` at positions ``start + j * ratio`` with cubic Lagrange.

    signal: [..., T];  ratio: scalar or [..., 1] input-samples per
    output-sample;  start: scalar or [...];  returns [..., out_len] on
    ``signal``'s device, in its dtype.
    """
    dev = signal.device
    t = signal.shape[-1]
    j = torch.arange(out_len, dtype=torch.float32, device=dev)
    ratio = torch.as_tensor(ratio, dtype=torch.float32, device=dev)
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    pos = (start[..., None] if ratio.dim() else start) + j * ratio
    i1 = torch.floor(pos)
    f = pos - i1
    i1 = i1.to(torch.int64)

    # 4-tap Lagrange weights around i1 (taps at i1-1, i1, i1+1, i1+2).
    w_m1 = -f * (f - 1.0) * (f - 2.0) / 6.0
    w_0 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0
    w_p1 = -(f + 1.0) * f * (f - 2.0) / 2.0
    w_p2 = (f + 1.0) * f * (f - 1.0) / 6.0

    batch = torch.broadcast_shapes(signal.shape[:-1], pos.shape[:-1])
    sig = signal.expand(*batch, t)

    def tap(offset: int) -> torch.Tensor:
        idx = i1 + offset
        valid = (idx >= 0) & (idx < t)
        v = torch.gather(sig, -1, idx.clamp(0, t - 1).expand(*batch, out_len))
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))

    out = w_m1 * tap(-1) + w_0 * tap(0) + w_p1 * tap(1) + w_p2 * tap(2)
    return out.to(signal.dtype)
