"""The two stretch engines.  Fast (hop-parallel): ``core`` holds the
chunk, ``batched`` the pool's layer over it, ``offline`` the whole-track
driver.  Blob-exact (fidelity): ``spectral`` holds the per-hop
algorithm, ``fidelity`` the batched serving step around it."""
