"""bauklank_tpu_torch — the PyTorch + CUDA port of ``bauklank_tpu``.

The package mirrors ``bauklank_tpu``'s layout (``engine/``, ``ops/``,
``serve/``, ``node/``, ``schedule/``, ``models/``, ``runtime/``,
``utils/``) so each ported module
sits at the same path as its JAX counterpart, which stays in the
repository as the reference it is tested against.  Plain tensor code is
PyTorch; the eight kernels (one for each ``pl.pallas_call`` of the JAX
package, and the fidelity step's smoother pair, where JAX runs
``lax.associative_scan``) are CUDA C++ for Hopper (``csrc/*.cu``), built at first use and
bound with ``ctypes`` (``kernels/``).  A CPU tensor takes each kernel's
plain PyTorch version.  Entry points run on the card unless the caller
passes ``device="cpu"``.  As in the JAX package, the pools and the node
are imported from their subpackages.

Ported so far: both engines — the fast one
(:func:`engine.core.process_chunk`, :func:`engine.batched.batched_process_chunk`,
:func:`engine.offline.stretch_offline`, the live drive
:func:`engine.live.process_live`) and the blob-exact one
(:func:`engine.fidelity.batched_fidelity_chunk` with formants, the coupled
:func:`engine.fidelity.batched_live_fidelity_chunk`, the one-stream
:func:`engine.fidelity.fidelity_chunk`); the pools
(:class:`serve.pool.StreamPool` with ``grow``, the pipelined fetch and
``analyze``, :class:`serve.livepool.LivePool`,
:class:`serve.unified.UnifiedPool`); the node
(:class:`node.StretchNode`); checkpoints in the JAX package's format
(:mod:`utils.checkpoint`); the monitoring ops (:mod:`ops.analyze`); the
server front door (:mod:`serve.server` with :mod:`serve.slots`,
:mod:`serve.serial`, :mod:`serve.statuspage` and :mod:`serve.client`);
the command line (:mod:`cli`, ``python -m bauklank_tpu_torch``, whose
``--device`` stands where the JAX CLI reads ``JAX_PLATFORMS``); the voice
presets and topology (:mod:`models`); the host runtime (:mod:`runtime`:
the C++ WAV codec built with ``g++``, the ring buffer, the mp3 decoder)
and the audio I/O over it (:mod:`utils.audio`, resampling through
:mod:`ops.resample`); the parallel paths (:mod:`parallel`: stream data
parallelism and the hop-sharded offline render on ``torch.distributed``,
one rank per card); and the per-hop forms the JAX suite pins the serving
step against (:func:`engine.spectral.spectral_hop`,
:func:`engine.spectral.spectral_hop_batched`,
:func:`engine.fidelity.batched_fidelity_chunk_scan`, the one-stream
``engine.fidelity._render_jit``).  Left out on purpose: the fused MDFT
A/B (a TPU matrix-unit form, off by default in JAX) and the TPU forms of
the fractional gather (``ops/blockgather.py``, ``ops/windowgather.py``),
for which ``ops.gather`` stands.
"""

from bauklank_tpu_torch.engine.config import StretchConfig, preset_cheaper, preset_default
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.utils.version import __version__

__all__ = [
    "StretchConfig",
    "StretchParams",
    "preset_default",
    "preset_cheaper",
    "__version__",
]
