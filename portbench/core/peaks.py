"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
the full 700 W; the card's power limit is printed beside every run)."""

HBM_BYTES_PER_S = 3.35e12      # device memory
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
BOOST_HZ = 1.98e9              # the published boost clock
DEP_CYCLES = 4                 # latency of a dependent float32 add or multiply
