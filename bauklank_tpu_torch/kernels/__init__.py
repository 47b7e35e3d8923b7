"""Hand-written Hopper kernels of both engines, with their wrappers.

Each kernel module holds the wrapper (``frames_windowed``,
``smooth_pair``, ``comp_cumsum``, ``frac_gather`` or, on the fused route,
``chainfetch``, and ``band_chain`` for the fidelity step;
``frames_windowed`` and ``banded_interp`` for the fast one;
``pallas_gather``, which no step calls) and its plain PyTorch version
(``*_ref``, same signature).  ``smooth_pair`` (kernel 8, the smoother
pair of stage 2 and of a formant voice's envelope) replaces no TPU
kernel: JAX runs it as ``lax.associative_scan``.  A wrapper checks its operands,
sends a CPU tensor to the plain version, and launches the CUDA kernel on
a CUDA tensor, raising on any launch error; it never falls back.
:data:`LAUNCHES` counts the kernel launches that the host issues, one per
launch and nowhere else, so a run can show that its main path went
through the kernels.  A launch issued into a CUDA graph being captured
counts once; the graph's replays run it again and count nothing
(``serve/graphs.py``): ``torch.profiler`` sees those.
"""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "reset_launches", "on_cuda", "stream_of", "require"]

LAUNCHES = {"frames_windowed": 0, "comp_cumsum": 0, "frac_gather": 0, "band_chain": 0,
            "banded_interp": 0, "pallas_gather": 0, "chainfetch": 0, "smooth_pair": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors}
    devs = {t.device for t in tensors}
    require(len(devs) == 1, name, f"operands on several devices {sorted(map(str, devs))}")
    kind = kinds.pop()
    require(kind in ("cpu", "cuda"), name, f"unsupported device {kind!r}")
    return kind == "cuda"


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
