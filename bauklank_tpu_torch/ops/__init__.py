"""Tensor ops of the fidelity step: MDFT, framing, fractional gather."""
