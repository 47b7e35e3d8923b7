"""The fidelity step's one fractional gather.

``frac_gather(planes [N, B, P], pos [N, K]) -> [N, K, P]`` has the
semantics of ``engine.spectral._get_fractional``: linear interpolation at
``pos`` with zeros outside [0, B), every product and the sum rounded on
their own.  It replaces the JAX package's family of TPU gather forms
(``ops/blockgather.py``, ``ops/windowgather.py``, the wintaps and
chainfetch kernels), which exist to put a gather on the TPU's matrix
unit; on a GPU a gather is a direct indexed load (kernel 3,
``kernels/gather.py``).
"""

from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref

__all__ = ["frac_gather", "frac_gather_ref"]
