"""PyTorch port against the blob: ``r10_fp7`` (a +7 st formant shift on
auto f0, compared over the first second, where the f0 index has not yet
flipped a harmonic fold); see test_torch_golden.py."""

from test_torch_golden import golden_snr


def test_golden_formant_shift():
    snr = golden_snr("r10_fp7")
    assert snr > 40.0, f"r10_fp7: {snr:.1f} dB"
