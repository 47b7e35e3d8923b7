"""Dynamic per-stream stretch parameters (a NamedTuple of tensors).

The runtime controls the reference sets every render quantum from the
current time-map segment.  Every field is a float32 tensor: a scalar for
one stream from :meth:`StretchParams.make`, a leading stream axis after
:meth:`StretchParams.stack` or ``engine.drive.unpack`` (the pool's
per-step ``[S, H + 11]`` array).  Frequencies are normalized to
cycles/sample (Hz / sample_rate).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["StretchParams", "semitones_to_factor"]


def semitones_to_factor(semitones, device=DEFAULT_DEVICE) -> torch.Tensor:
    """2^(semitones / 12) as float32 on ``device``."""
    st = torch.as_tensor(semitones, dtype=torch.float32, device=resolve_device(device))
    return torch.pow(2.0, st / 12.0)


class StretchParams(NamedTuple):
    active: torch.Tensor            # 0/1 — inactive streams emit silence
    rate: torch.Tensor              # input samples consumed per output sample
    transpose_factor: torch.Tensor  # frequency multiplier (2^(semitones/12))
    tonality: torch.Tensor          # tonality limit, cycles/sample; <=0 -> off
    formant_factor: torch.Tensor    # formant envelope ratio
    formant_compensation: torch.Tensor  # 0/1
    formant_base: torch.Tensor      # envelope scale, cycles/sample; 0 -> detect

    @classmethod
    def make(
        cls,
        *,
        active=1.0,
        rate=1.0,
        semitones=0.0,
        transpose_factor=None,
        tonality_hz=8000.0,
        formant_semitones=0.0,
        formant_factor=None,
        formant_compensation=0.0,
        formant_base_hz=0.0,
        sample_rate=44100.0,
        device=DEFAULT_DEVICE,
    ) -> "StretchParams":
        """Params of one stream from reference-style controls (Hz,
        semitones), as float32 scalars on ``device``.  Defaults mirror the
        reference worklet's initial time-map segment: rate 1, semitones 0,
        tonalityHz 8000, formants off, base 0 = detect."""
        dev = resolve_device(device)
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        tf = (f32(transpose_factor) if transpose_factor is not None
              else semitones_to_factor(semitones, dev))
        ff = (f32(formant_factor) if formant_factor is not None
              else semitones_to_factor(formant_semitones, dev))
        return cls(
            active=f32(active),
            rate=f32(rate),
            transpose_factor=tf,
            tonality=f32(np.asarray(tonality_hz) / sample_rate),
            formant_factor=ff,
            formant_compensation=f32(formant_compensation),
            formant_base=f32(np.asarray(formant_base_hz) / sample_rate),
        )

    @classmethod
    def stack(cls, params_list) -> "StretchParams":
        """Stack single-stream params into batched [streams] fields."""
        return cls(*[torch.stack([getattr(p, f) for p in params_list]) for f in cls._fields])
