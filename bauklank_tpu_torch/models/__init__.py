"""Named voice configurations and installation topology."""

from bauklank_tpu_torch.models.voices import (
    VoicePreset,
    KIOSK_ENGINE_A,
    KIOSK_ENGINE_B,
    DEV_SINGLE,
    PRESETS,
)
from bauklank_tpu_torch.models.topology import TimePitchTopology, DEFAULT_TOPOLOGY

__all__ = [
    "VoicePreset",
    "KIOSK_ENGINE_A",
    "KIOSK_ENGINE_B",
    "DEV_SINGLE",
    "PRESETS",
    "TimePitchTopology",
    "DEFAULT_TOPOLOGY",
]
