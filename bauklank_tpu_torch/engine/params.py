"""Dynamic per-stream stretch parameters (a NamedTuple of tensors).

The runtime controls the reference sets every render quantum from the
current time-map segment.  Every field is a float32 tensor with a leading
stream axis; the pool packs them into its per-step ``[S, H + 11]`` array
and :meth:`StretchParams.unpack` reads them back out.  Frequencies are
normalized to cycles/sample (Hz / sample_rate).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["StretchParams"]


class StretchParams(NamedTuple):
    active: torch.Tensor            # 0/1 — inactive streams emit silence
    rate: torch.Tensor              # input samples consumed per output sample
    transpose_factor: torch.Tensor  # frequency multiplier (2^(semitones/12))
    tonality: torch.Tensor          # tonality limit, cycles/sample; <=0 -> off
    formant_factor: torch.Tensor    # formant envelope ratio
    formant_compensation: torch.Tensor  # 0/1
    formant_base: torch.Tensor      # envelope scale, cycles/sample; 0 -> detect

    @classmethod
    def unpack(cls, packed: torch.Tensor, hops: int) -> "StretchParams":
        """Fields ``[H:H+7]`` of the pool's packed ``[S, H + 11]`` array."""
        return cls(*[packed[:, hops + i] for i in range(7)])
