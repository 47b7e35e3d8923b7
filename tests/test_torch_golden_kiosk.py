"""PyTorch port against the blob: ``kiosk_r0001_st0`` (the kiosk's
200/200 ms geometry, overlap 1 so ``long_step`` 1, rate 0.001 so the time
factor saturates at the interval); see test_torch_golden.py."""

from test_torch_golden import golden_snr


def test_golden_kiosk_overlap1():
    snr = golden_snr("kiosk_r0001_st0")
    assert snr > 40.0, f"kiosk_r0001_st0: {snr:.1f} dB"
