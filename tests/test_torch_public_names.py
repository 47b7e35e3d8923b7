"""PyTorch port, the small public names the JAX package has beside its
engines: ``engine.batched.batched_step_jit``, ``ops.framing.ola_chunks``,
``ops.mdft.num_bands`` / ``band_freqs`` and ``serve.pool.RAMP_SEC``, each
against its JAX counterpart."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
import torch

from bauklank_tpu.engine import batched as jbatched
from bauklank_tpu.engine import StretchConfig as JConfig
from bauklank_tpu.engine import StretchParams as JParams
from bauklank_tpu.ops import framing as jframing
from bauklank_tpu.ops import mdft as jmdft
from bauklank_tpu.serve import pool as jpool
from bauklank_tpu_torch.engine import StretchConfig, StretchParams
from bauklank_tpu_torch.engine import batched
from bauklank_tpu_torch.engine.offline import frame_ends_for
from bauklank_tpu_torch.ops import framing, mdft
from bauklank_tpu_torch.serve import pool

torch.set_num_threads(1)
SR = 44100.0


def test_batched_step_jit_is_the_batched_step():
    """Against JAX's compiled, state-donating step: the bar of
    tests/test_parallel.py (atol 2e-4); against the port's own batched
    step: bit for bit."""
    cfg = StretchConfig(channels=2, block=512, interval=128, formants=True)
    rng = np.random.default_rng(2)
    audios = (rng.standard_normal((3, 2, 6000)) * 0.2).astype(np.float32)
    rates = (0.5, 1.0, 1.7)
    params = StretchParams.stack([StretchParams.make(rate=r, semitones=s, sample_rate=SR,
                                                     device="cpu")
                                  for r, s in zip(rates, (-7.0, 0.0, 5.0))])
    ends = np.stack([frame_ends_for(cfg, 0, 8, r) for r in rates]).astype(np.int32)
    st_t, out_t = batched.batched_step_jit(cfg, batched.init_batched_state(cfg, 3, "cpu"),
                                           torch.from_numpy(audios), torch.from_numpy(ends),
                                           params)
    _, ref = batched.batched_process_chunk(cfg, batched.init_batched_state(cfg, 3, "cpu"),
                                           torch.from_numpy(audios), torch.from_numpy(ends),
                                           params)
    np.testing.assert_array_equal(out_t.numpy(), ref.numpy())
    cfg_j = JConfig(channels=2, block=512, interval=128, formants=True)
    _, out_j = jbatched.batched_step_jit(
        cfg_j, jbatched.init_batched_state(cfg_j, 3), jnp.asarray(audios), jnp.asarray(ends),
        JParams(*[jnp.asarray(f.numpy()) for f in params]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-4)


def test_ola_chunks_bit_equal():
    frames = np.random.default_rng(3).standard_normal((2, 3, 500)).astype(np.float32)
    for interval in (128, 100, 500):
        want = np.asarray(jframing.ola_chunks(jnp.asarray(frames), interval))
        got = framing.ola_chunks(torch.from_numpy(frames), interval).numpy()
        assert got.shape == want.shape == (2, 3, -(-500 // interval), interval)
        np.testing.assert_array_equal(got, want)


def test_num_bands_and_band_freqs_equal():
    for block in (512, 5292, 5376):
        assert mdft.num_bands(block) == jmdft.num_bands(block) == block // 2
        got, want = mdft.band_freqs(block), jmdft.band_freqs(block)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_ramp_sec_equal():
    assert pool.RAMP_SEC == jpool.RAMP_SEC == 0.03
