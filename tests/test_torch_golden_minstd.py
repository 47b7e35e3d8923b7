"""PyTorch port against the blob: ``r025_st0`` (time factor 4, the MINSTD
vertical steps, seed carried across chunks); see test_torch_golden.py."""

from test_torch_golden import golden_snr


def test_golden_minstd_carried():
    snr = golden_snr("r025_st0")
    assert snr > 40.0, f"r025_st0: {snr:.1f} dB"
