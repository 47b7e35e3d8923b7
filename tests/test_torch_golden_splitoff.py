"""PyTorch port against the blob: ``r10_stp12_splitoff`` (the
splitComputation=false frame law, pitch up); see test_torch_golden.py."""

from test_torch_golden import golden_snr


def test_golden_split_off():
    snr = golden_snr("r10_stp12_splitoff")
    assert snr > 40.0, f"r10_stp12_splitoff: {snr:.1f} dB"
