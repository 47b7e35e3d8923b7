"""PyTorch port, the host runtime and the audio I/O: ``runtime/`` (WAV
codec, interleave, ring buffer, mp3 decoder), ``ops/resample.py``,
``utils/audio.py`` and ``models/``, against the JAX package's.

The runtime, the decoder and the models are host code copied from the JAX
package: their results must be equal, byte for byte.  The resampler is
tensor code: XLA's CPU backend may fuse its multiply-adds (the position
``start + j * ratio`` and the weighted taps), which the port rounds one by
one, so it is held to a float32 tolerance: 1e-5 absolute on a signal of
unit scale (a few ulps of the sum of four taps).  With the JAX and
PyTorch builds these tests were written against, the two agree bit for
bit.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tests.util import dominant_freq, tone

import bauklank_tpu.models as jmodels
import bauklank_tpu.runtime as jruntime
from bauklank_tpu.ops.resample import resample as j_resample
from bauklank_tpu.runtime.mp3 import decode_mp3 as j_decode_mp3
from bauklank_tpu.utils.audio import load_audio as j_load_audio
import bauklank_tpu_torch.models as models
import bauklank_tpu_torch.runtime as runtime
from bauklank_tpu_torch.ops.resample import resample
from bauklank_tpu_torch.runtime import build
from bauklank_tpu_torch.runtime.mp3 import decode_mp3
from bauklank_tpu_torch.utils.audio import load_audio, save_audio

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
RESAMPLE_ATOL = 1e-5


def test_native_library_builds_into_the_package():
    assert runtime.native_available(), "g++ is present; the native runtime must build"
    path = build.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "bauklank_tpu_torch"


@pytest.mark.parametrize("as_float", [False, True])
def test_wav_files_equal_the_jax_writers(tmp_path, as_float):
    rng = np.random.default_rng(0)
    planes = np.clip(rng.standard_normal((2, 5000)) * 0.4, -1.2, 1.2).astype(np.float32)
    runtime.wav_write(tmp_path / "t.wav", planes, 44100, as_float=as_float)
    jruntime.wav_write(tmp_path / "j.wav", planes, 44100, as_float=as_float)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back, sr = runtime.wav_read(tmp_path / "j.wav")
    jback, jsr = jruntime.wav_read(tmp_path / "t.wav")
    assert sr == jsr == 44100
    np.testing.assert_array_equal(back, jback)
    if as_float:
        np.testing.assert_array_equal(back, planes)


def test_interleave_and_ring_buffer_equal_jax():
    planes = np.random.default_rng(3).standard_normal((2, 777)).astype(np.float32)
    inter = runtime.interleave(planes)
    np.testing.assert_array_equal(inter, jruntime.interleave(planes))
    np.testing.assert_array_equal(runtime.deinterleave(inter, 2),
                                  jruntime.deinterleave(inter, 2))

    def drive(mod):
        r = mod.RingBuffer(1024)
        out = [r.push(np.arange(100, dtype=np.float32)), len(r), r.pop(40), len(r),
               r.pop(100), r.push(np.ones(2000, np.float32)), len(r), r.pop(8)]
        return [np.asarray(o).tolist() for o in out]

    assert drive(runtime) == drive(jruntime)


def test_mp3_decode_equals_the_jax_decoder():
    mp3b = (FIXTURES / "tone_jstereo.mp3").read_bytes()
    pcm, sr = decode_mp3(mp3b, check_bits=True)
    jpcm, jsr = j_decode_mp3(mp3b, check_bits=True)
    assert sr == jsr and pcm.dtype == jpcm.dtype
    np.testing.assert_array_equal(pcm, jpcm)
    # and so within the JAX decoder's bound against the committed oracle
    from tests.test_mp3 import _aligned_snr

    with np.load(FIXTURES / "tone_jstereo_oracle.npz") as z:
        oracle = z["pcm_int16"].astype(np.float32) / 32768.0
        assert sr == int(z["sample_rate"])
    assert _aligned_snr(oracle, pcm) >= 60.0


@pytest.mark.parametrize("data", [b"", b"\x00" * 4096, bytes(range(256)) * 8])
def test_mp3_garbage_raises_as_in_jax(data):
    with pytest.raises(ValueError) as want:
        j_decode_mp3(data)
    with pytest.raises(ValueError) as got:
        decode_mp3(data)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ratio,start,out_len", [
    (0.5, 0.0, 700),          # upsample 2x
    (1.37, 0.0, 500),         # non-integer downsample
    (0.7301, 12.625, 600),    # non-integer, with a start offset
    (2.0, -3.5, 400),         # reads before 0 and past T: zeros there
])
def test_resample_matches_jax(ratio, start, out_len):
    import jax.numpy as jnp

    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 800)).astype(np.float32)
    want = np.asarray(j_resample(jnp.asarray(x), jnp.float32(ratio), out_len, start))
    got = resample(torch.from_numpy(x), ratio, out_len, start).numpy()
    assert got.shape == want.shape == (2, 3, out_len) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)


def test_resample_per_row_ratio_and_start_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (4, 600)).astype(np.float32)
    ratio = np.array([[0.5], [0.93], [1.5], [1.01]], np.float32)
    start = np.array([0.0, 3.25, -2.0, 100.5], np.float32)
    want = np.asarray(j_resample(jnp.asarray(x), jnp.asarray(ratio), 300, jnp.asarray(start)))
    got = resample(torch.from_numpy(x), torch.from_numpy(ratio), 300,
                   torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)


def test_load_audio_resamples_as_jax_does(tmp_path):
    sr_in = 22050
    x = tone(1000.0, 2 * sr_in, sr_in)
    save_audio(tmp_path / "r.wav", np.stack([x, -x]), sr_in)
    planes, sr = load_audio(tmp_path / "r.wav", sample_rate=44100, device="cpu")
    jplanes, jsr = j_load_audio(tmp_path / "r.wav", sample_rate=44100)
    assert sr == jsr == 44100 and planes.shape == jplanes.shape
    assert abs(planes.shape[1] - 2 * 44100) <= 4
    np.testing.assert_allclose(planes, jplanes, rtol=0, atol=RESAMPLE_ATOL)
    assert abs(dominant_freq(planes[0, 1000:9192], 44100.0) - 1000.0) < 5.0
    # no resample: the file as it is, on no device
    same, sr = load_audio(tmp_path / "r.wav")
    assert sr == sr_in and same.shape == (2, 2 * sr_in)


def test_load_audio_resample_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_audio(tmp_path / "r.wav", tone(1000.0, 2000, 22050)[None], 22050)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_audio(tmp_path / "r.wav", sample_rate=44100)


def test_voice_presets_equal_jax():
    assert list(models.__all__) == list(jmodels.__all__)
    assert sorted(models.PRESETS) == sorted(jmodels.PRESETS)
    for name, preset in models.PRESETS.items():
        jpreset = jmodels.PRESETS[name]
        assert dataclasses.asdict(preset) == dataclasses.asdict(jpreset)
        assert preset.schedule_obj(output=1.5) == jpreset.schedule_obj(output=1.5)
        for sr in (44100.0, 48000.0):
            assert (dataclasses.asdict(preset.config(2, sr))
                    == dataclasses.asdict(jpreset.config(2, sr)))
    assert models.KIOSK_ENGINE_A.config(2, 44100.0).block == 9216


def test_topology_and_validation_equal_jax():
    mapping = {"c1": {"A": "e1", "B": "e2"}, "c2": {"A": "e3"}}
    t, jt = models.TimePitchTopology(mapping), jmodels.TimePitchTopology(mapping)
    assert list(t.items()) == list(jt.items())
    assert t.encoder_for("c1", "B") == jt.encoder_for("c1", "B") == "e2"
    assert t.channel_encoder_ids("c2") == jt.channel_encoder_ids("c2")
    assert t.c_header() == jt.c_header()
    assert models.DEFAULT_TOPOLOGY.c_header() == jmodels.DEFAULT_TOPOLOGY.c_header()
    for bad in ({"c1": {"X": "e1"}}, {"c1": {"A": "dup"}, "c2": {"A": "dup"}}, {"c1": {}}):
        with pytest.raises(ValueError) as want:
            jmodels.TimePitchTopology(bad)
        with pytest.raises(ValueError) as got:
            models.TimePitchTopology(bad)
        assert str(got.value) == str(want.value)
