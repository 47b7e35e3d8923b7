"""The fidelity step's fractional gathers.

``frac_gather(planes [N, B, P], pos [N, K]) -> [N, K, P]`` has the
semantics of ``engine.spectral._get_fractional``: linear interpolation at
``pos`` with zeros outside [0, B), every product and the sum rounded on
their own.  The JAX package's TPU gather forms (``ops/blockgather.py``,
``ops/windowgather.py``, the wintaps, selection and chainfetch kernels)
exist to put a gather on the TPU's matrix unit; on a GPU a gather is a
direct indexed load.  ``frac_gather`` (kernel 3) serves every regime,
``pallas_gather`` (kernel 6) is the same function under the TPU drop-in's
name, and ``chainfetch`` (kernel 7) is the deterministic regime's six
families in one launch (``kernels/gather.py``, ``kernels/chainfetch.py``).
"""

from bauklank_tpu_torch.kernels.chainfetch import chainfetch
from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref, pallas_gather

__all__ = ["frac_gather", "frac_gather_ref", "pallas_gather", "chainfetch"]
