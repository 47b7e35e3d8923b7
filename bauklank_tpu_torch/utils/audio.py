"""Track loading/saving for the data path.

Port of ``bauklank_tpu/utils/audio.py``.  WAV goes through the native
runtime codec (:mod:`bauklank_tpu_torch.runtime`), mp3 through the
from-spec decoder (:mod:`bauklank_tpu_torch.runtime.mp3`), anything else
through ffmpeg when it is on PATH, with clear errors otherwise.  Reading
and writing files is host work; the one step that runs on a device is the
resample to a requested sample rate (:mod:`bauklank_tpu_torch.ops.resample`),
on ``device``: the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from bauklank_tpu_torch.runtime import wav_read, wav_write
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["load_audio", "save_audio", "ffmpeg_available"]


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str | pathlib.Path, sample_rate: int | None = None,
               device=DEFAULT_DEVICE) -> tuple[np.ndarray, int]:
    """Load an audio file -> (planes [channels, frames] float32, sr).

    WAV is decoded natively; other containers require ffmpeg.  When
    ``sample_rate`` is given and differs, the track is resampled (cubic
    Lagrange) on ``device``; a file read without a resample touches no
    device.
    """
    path = pathlib.Path(path)
    if path.suffix.lower() == ".wav":
        planes, sr = wav_read(path)
    elif path.suffix.lower() == ".mp3":
        from bauklank_tpu_torch.runtime.mp3 import decode_mp3

        planes, sr = decode_mp3(path.read_bytes())
    else:
        if not ffmpeg_available():
            raise OSError(
                f"cannot decode {path.suffix}: ffmpeg not available; provide WAV"
            )
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-i", str(path), tmp.name],
                check=True,
            )
            planes, sr = wav_read(tmp.name)
    if sample_rate is not None and sr != sample_rate:
        from bauklank_tpu_torch.ops.resample import resample

        ratio = sr / sample_rate
        out_len = int(planes.shape[1] / ratio)
        x = torch.from_numpy(np.ascontiguousarray(planes, np.float32)).to(resolve_device(device))
        planes = resample(x, ratio, out_len).cpu().numpy()
        sr = sample_rate
    return planes, sr


def save_audio(path: str | pathlib.Path, planes: np.ndarray, sample_rate: int,
               as_float: bool = False) -> None:
    wav_write(path, planes, sample_rate, as_float=as_float)
