"""The blob-exact (fidelity) engine: ``spectral`` holds the per-hop
algorithm, ``fidelity`` the batched serving step around it."""
