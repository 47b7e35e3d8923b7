"""bauklank_tpu_torch — the PyTorch + CUDA port of ``bauklank_tpu``.

The package mirrors ``bauklank_tpu``'s layout (``engine/``, ``ops/``,
``serve/``, ``schedule/``, ``utils/``) so each ported module sits at the
same path as its JAX counterpart, which stays in the repository as the
reference it is tested against.  Plain tensor code is PyTorch; the five
kernels of the two engines are CUDA C++ for Hopper (``csrc/*.cu``), built
at first use and bound with ``ctypes`` (``kernels/``).  A CPU tensor
takes each kernel's plain PyTorch version.  Entry points run on the card
unless the caller passes ``device="cpu"``.

Ported so far: the fast engine (:func:`engine.core.process_chunk`,
:func:`engine.batched.batched_process_chunk`,
:func:`engine.offline.stretch_offline`), the fidelity serving step
(:func:`engine.fidelity.batched_fidelity_chunk`), and the pool around
both (:class:`serve.pool.StreamPool`, ``engine="fast"`` by default).
"""

from bauklank_tpu_torch.engine.config import StretchConfig, preset_cheaper, preset_default
from bauklank_tpu_torch.utils.version import __version__

__all__ = ["StretchConfig", "preset_default", "preset_cheaper", "__version__"]
