"""High-level voice API (the reference StretchNode equivalent)."""

from bauklank_tpu_torch.node.node import StretchNode

__all__ = ["StretchNode"]
