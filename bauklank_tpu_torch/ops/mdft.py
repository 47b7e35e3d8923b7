"""Modified real DFT: bands centered at (k + 1/2) bins.

Port of ``bauklank_tpu/ops/mdft.py`` (``mdft``/``imdft``) on ``torch.fft``.

Forward:  X[k] = sum_n x[n] * exp(-2i*pi*(k+1/2)*n/N),  k in [0, N/2)
Inverse:  x[n] = (2/N) * Re( sum_k X[k] * exp(+2i*pi*(k+1/2)*n/N) )

Decimation in time over even/odd samples packs the real input into ONE
complex FFT of size N/2: with E[m] = x[2m], O[m] = x[2m+1] and the
half-bin transform T[f][k] = sum_m f[m] e^{-2i pi (k+1/2) m / M} (M = N/2),
X[k] = T[E][k] + w_k T[O][k] with w_k = e^{-2i pi (k+1/2) / N}.  The
inverse runs the algebra backwards.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

__all__ = ["mdft", "imdft", "cmul", "unit_phase"]


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return lib


def unit_phase(phase: np.ndarray, device) -> torch.Tensor:
    """e^{i*phase} as complex64 for a float32 phase table.  The parts are
    the C library's float32 ``cosf``/``sinf`` of each phase, evaluated on
    the host: the same values on every device, and the same values the
    JAX package's CPU backend computes.  It copies the table to
    ``device``; callers build their tables once per size and device."""
    lib = _libm()
    p = np.ascontiguousarray(phase, np.float32).tolist()
    c = np.array([lib.cosf(v) for v in p], np.float32)
    s = np.array([lib.sinf(v) for v in p], np.float32)
    return torch.complex(torch.from_numpy(c), torch.from_numpy(s)).to(device)


@functools.lru_cache(maxsize=32)
def _twiddles(n: int, device: torch.device):
    """(pre, w, 0.5 / w, post) of an N-point transform on ``device``,
    built once on the host: pre = e^{-i pi m/M}, w = e^{-2i pi (k+1/2)/N},
    post = e^{+i pi m/M}."""
    m = n // 2
    w = unit_phase(-2.0 * np.pi * (np.arange(m) + 0.5) / n, "cpu")
    tables = (unit_phase(-np.pi * np.arange(m) / m, "cpu"), w, 0.5 / w,
              unit_phase(np.pi * np.arange(m) / m, "cpu"))
    return tuple(t.to(device) for t in tables)


def _fft(z: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Complex FFT over the last axis: cuFFT (``torch.fft``) on the GPU.
    On the CPU, pocketfft through ``scipy.fft`` — the FFT the JAX package's
    CPU backend runs (PyTorch's CPU FFT is MKL's, which rounds otherwise).
    The two libraries round differently; ``chip_smoke.py`` holds each
    stage of the GPU step against the CPU's, on the same inputs."""
    if z.device.type != "cpu":
        return torch.fft.ifft(z, dim=-1) if inverse else torch.fft.fft(z, dim=-1)
    import scipy.fft

    f = scipy.fft.ifft if inverse else scipy.fft.fft
    return torch.from_numpy(np.ascontiguousarray(f(z.resolve_conj().numpy(), axis=-1)))


def cmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Complex product.  On the CPU it rounds as XLA's CPU backend does,
    re = fma(a, c, -(b d)) and im = fma(b, c, a d) with the fused
    multiply-add evaluated in float64, so that on the CPU, where the tests
    hold the port against the JAX package, the analyses agree bit for bit.
    On the GPU it is the plain float32 product: the float64 form there
    cost about 4 ms of device time a step of the preset pool on an H100,
    and the GPU's analyses differ from the CPU's by cuFFT's rounding all
    the same."""
    if x.device.type != "cpu":
        return x * y
    a, b = x.real.double(), x.imag.double()
    c, d = y.real.double(), y.imag.double()
    bd = (b * d).float().double()
    ad = (a * d).float().double()
    return torch.complex((a * c - bd).float(), (b * c + ad).float())


def mdft(x: torch.Tensor) -> torch.Tensor:
    """Forward modified real DFT over the last axis: real [..., N] ->
    complex64 [..., N/2]."""
    x = x.to(torch.float32)
    pre, w, _, _ = _twiddles(x.shape[-1], x.device)
    z = torch.complex(x[..., 0::2], x[..., 1::2])
    tz = _fft(cmul(z, pre))
    tz_rev = torch.conj(tz.flip(-1))
    te = 0.5 * (tz + tz_rev)
    to = -0.5j * (tz - tz_rev)
    return te + cmul(w, to)


def imdft(spec: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse modified real DFT over the last axis: complex [..., N/2] ->
    real float32 [..., N]."""
    m = spec.shape[-1]
    if block != 2 * m:
        raise ValueError(f"imdft: block {block} != 2 * bands {m}")
    x_rev = torch.conj(spec.flip(-1))
    te = 0.5 * (spec + x_rev)
    _, _, half_inv_w, post = _twiddles(block, spec.device)
    to = cmul(spec - x_rev, half_inv_w)
    z = cmul(_fft(te + 1j * to, inverse=True), post)
    return torch.stack([z.real, z.imag], dim=-1).reshape(spec.shape[:-1] + (block,))
