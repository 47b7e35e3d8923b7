"""Control plane: WebSocket server, stream pools, slot allocation, serial
bridge, the control wire protocol.  The front page exports what
``bauklank_tpu.serve`` exports."""

from bauklank_tpu_torch.serve.pool import StreamPool, VoiceSlot
from bauklank_tpu_torch.serve.livepool import LivePool
from bauklank_tpu_torch.serve.slots import SlotAllocator
from bauklank_tpu_torch.serve.unified import UnifiedPool

__all__ = [
    "StreamPool",
    "LivePool",
    "UnifiedPool",
    "VoiceSlot",
    "SlotAllocator",
    # imported lazily to avoid pulling websockets unless used:
    # serve.server.ControlServer, serve.client.ControlClient
]
