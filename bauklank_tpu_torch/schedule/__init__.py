"""Host-side scheduling: the per-voice time map."""

from bauklank_tpu_torch.schedule.timemap import Segment, TimeMap

__all__ = ["Segment", "TimeMap"]
