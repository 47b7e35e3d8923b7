"""The two stretch engines.  Fast (hop-parallel): ``core`` holds the
chunk, ``batched`` the pool's layer over it, ``offline`` the whole-track
driver.  Blob-exact (fidelity): ``spectral`` holds the per-hop
algorithm, ``fidelity`` the batched serving step around it.  The front
page exports what ``bauklank_tpu.engine`` exports."""

from bauklank_tpu_torch.engine.config import StretchConfig, preset_default, preset_cheaper
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.engine.core import init_state, process_chunk, StretchState
from bauklank_tpu_torch.engine.offline import stretch_offline
from bauklank_tpu_torch.engine.fidelity import render_fidelity, SpectralConfig

__all__ = [
    "StretchConfig",
    "SpectralConfig",
    "StretchParams",
    "StretchState",
    "init_state",
    "process_chunk",
    "stretch_offline",
    "render_fidelity",
    "preset_default",
    "preset_cheaper",
]
