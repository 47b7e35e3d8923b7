"""PyTorch port, parallel/seqpar: one offline render's hops spread over the
``seq`` axis of a 2 x 2 mesh of spawned gloo ranks on the CPU (the cases
of tests/test_seqpar.py).  Each stream is held > 45 dB after the first
block against the port's one-device ``stretch_offline`` and against the
JAX package's ``stretch_offline_sharded`` on a 2 x 2 mesh of its virtual
devices (JAX's bar; the prefix composes in another order than one scan).

The ranks are spawned once and joined under a deadline
(``test_torch_parallel.spawn_ranks``); their top level imports numpy,
torch and the port only.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bauklank_tpu_torch.engine import StretchConfig, StretchParams, stretch_offline
from test_torch_parallel import spawn_ranks

torch.set_num_threads(1)
SR = 44100.0
N_STREAM, N_SEQ = 2, 2


def _tone(freq, n):
    return np.sin(2 * np.pi * freq * np.arange(n) / SR).astype(np.float32)


def _case(name):
    """(config, audio [S, C, T], rates, semitones, n_out) of the two cases."""
    if name == "formants":
        cfg = StretchConfig(channels=2, block=512, interval=128, formants=True)
        rng = np.random.default_rng(0)
        audio = (rng.standard_normal((4, 2, 40000)) * 0.2).astype(np.float32)
        audio += _tone(440.0, 40000) * 0.2
        return cfg, audio, np.asarray([0.5, 1.0, 1.3, 2.0]), [0.0, 5.0, -7.0, 12.0], 16 * 1024
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False,
                        transient_reset_db=6.0)
    rng = np.random.default_rng(1)
    audio = np.zeros((2, 1, 30000), np.float32)      # bursty, so the resets fire
    audio[:, 0] += (rng.standard_normal(30000) * 0.05).astype(np.float32)
    for k in range(6):
        p = 2000 + 4500 * k
        audio[:, 0, p:p + 800] += _tone(300.0 + 100 * k, 800) * 0.8
    return cfg, audio, np.asarray([0.6, 1.4]), [4.0, -6.0], 8 * 1024


def _params(rates, semis):
    return StretchParams.stack([StretchParams.make(rate=r, semitones=m, sample_rate=SR,
                                                   device="cpu") for r, m in zip(rates, semis)])


def _rank_render(rank: int, out_dir: str) -> None:
    from torch.distributed.tensor import Shard

    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

    mesh = stream_seq_mesh(N_STREAM, N_SEQ, device_type="cpu")
    assert tuple(mesh.get_coordinate()) == (rank // N_SEQ, rank % N_SEQ)
    saved = {}
    for name in ("formants", "resets"):
        cfg, audio, rates, semis, n_out = _case(name)
        out = stretch_offline_sharded(audio, rates, cfg, _params(rates, semis), n_out, mesh)
        assert out.placements == (Shard(0), Shard(2))
        saved[name] = out.to_local().numpy()
        saved[name + "_full"] = out.full_tensor().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("seqpar")
    spawn_ranks(_rank_render, N_STREAM * N_SEQ, str(out_dir))
    files = [np.load(out_dir / f"rank{r}.npz") for r in range(N_STREAM * N_SEQ)]
    out = {}
    for name in ("formants", "resets"):
        rows = [np.concatenate([files[si * N_SEQ + q][name] for q in range(N_SEQ)], axis=-1)
                for si in range(N_STREAM)]
        out[name] = np.concatenate(rows)
        for f in files:                       # every rank's full_tensor() is the whole
            np.testing.assert_array_equal(f[name + "_full"], out[name])
    return out


def _snr(ref, got):
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-30)))


@pytest.mark.parametrize("name", ["formants", "resets"])
def test_hop_sharded_matches_one_device(rendered, name):
    cfg, audio, rates, semis, n_out = _case(name)
    got = rendered[name]
    assert got.shape == (audio.shape[0], cfg.channels, n_out)   # 64 hops, a multiple of 2
    params = _params(rates, semis)
    for i in range(audio.shape[0]):
        want = stretch_offline(audio[i], float(rates[i]), cfg,
                               params=StretchParams(*[f[i] for f in params]), n_out=n_out,
                               device="cpu")
        s_db = _snr(want[:, cfg.block:], got[i][:, cfg.block:])
        assert s_db > 45.0, (i, s_db)


@pytest.mark.parametrize("name", ["formants", "resets"])
def test_hop_sharded_matches_jax(rendered, name):
    import jax.numpy as jnp

    from bauklank_tpu.engine import StretchConfig as JConfig
    from bauklank_tpu.engine import StretchParams as JParams
    from bauklank_tpu.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

    cfg, audio, rates, semis, n_out = _case(name)
    cfg_j = JConfig(channels=cfg.channels, block=cfg.block, interval=cfg.interval,
                    formants=cfg.formants, transient_reset_db=cfg.transient_reset_db)
    params_j = JParams(*[jnp.asarray(f.numpy()) for f in _params(rates, semis)])
    want = np.asarray(stretch_offline_sharded(audio, rates, cfg_j, params_j, n_out,
                                              stream_seq_mesh(N_STREAM, N_SEQ)))
    got = rendered[name][..., :n_out]
    for i in range(audio.shape[0]):
        s_db = _snr(want[i][:, cfg.block:], got[i][:, cfg.block:])
        assert s_db >= 45.0, (i, s_db)


def test_halo_needs_a_block_of_hops_a_rank(tmp_path):
    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = stream_seq_mesh(1, 1, device_type="cpu")
        with pytest.raises(ValueError, match="4 ranks"):
            stream_seq_mesh(2, 2, device_type="cpu")
        cfg, audio, rates, semis, _ = _case("resets")
        with pytest.raises(ValueError, match="halo"):
            stretch_offline_sharded(audio, rates, cfg, _params(rates, semis), 3 * 128, mesh)
        out = stretch_offline_sharded(audio, rates, cfg, _params(rates, semis), 4 * 128, mesh)
        assert out.shape == (2, 1, 4 * 128)
    finally:
        dist.destroy_process_group()
