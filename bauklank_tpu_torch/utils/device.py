"""The device an entry point runs on.

Every entry point of the port (``StreamPool``, ``render_fidelity``,
``stretch_offline``, ``init_state``, ``init_batched_state``) runs on
``"cuda"`` unless the caller passes another device; without a visible
CUDA device it raises rather than carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when none is
    visible (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default), but no CUDA device is "
            "visible; pass device='cpu' to run on the CPU")
    return dev
