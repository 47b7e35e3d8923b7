"""The per-hop form and the stream-sharded fidelity step on the card.
Marked ``cuda``: each test skips unless a CUDA device and ``nvcc`` are
present.  The proof at the main path's shapes is ``chip_smoke.py``
phase 10."""

from __future__ import annotations

import datetime

import numpy as np
import pytest

import torch
import torch.distributed as dist

from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.engine import fidelity as fid
from bauklank_tpu_torch.engine import spectral
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda
SR = 44100.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _inputs(dev, s_n=8, h=4, block=1024, interval=256):
    cfg = fid.SpectralConfig(2, block, interval)
    rng = np.random.default_rng(3)
    t = np.arange(20000) / SR
    audios = (np.stack([np.stack([0.3 * np.sin(2 * np.pi * (220 + 7 * k + 3 * c) * t)
                                  for c in range(2)]) for k in range(s_n)])
              + 0.02 * rng.standard_normal((s_n, 2, t.size))).astype(np.float32)
    rates = np.linspace(0.25, 2.0, s_n)
    ends = np.stack([fid.hop_frame_ends(cfg, h, r, SR) for r in rates]).astype(np.int32)
    mult = np.exp2(np.linspace(-12, 12, s_n) / 12).astype(np.float32)
    ctl = [(1.0 / rates).astype(np.float32), mult,
           ((8000 / SR) / np.sqrt(mult)).astype(np.float32), np.ones(s_n, np.float32)]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return cfg, to(audios), to(ends), [to(c) for c in ctl]


def test_spectral_hop_batched_kernel_bit_equal_to_the_plain_chain(dev):
    cfg, audios, ends, ctl = _inputs(dev)
    cur, prev = fid._analyse_cur_prev(cfg, audios, ends)
    state = tree_map(lambda x: x[None].repeat((audios.shape[0],) + (1,) * x.dim()),
                     spectral.init_spectral_state(cfg, dev))
    for i in range(ends.shape[1]):
        before = kernels.LAUNCHES["band_chain"]
        st_k, out_k = spectral.spectral_hop_batched(cfg, state, cur[i], prev[i], *ctl[:3],
                                                    use_kernel=True)
        st_p, out_p = spectral.spectral_hop_batched(cfg, state, cur[i], prev[i], *ctl[:3],
                                                    use_kernel=False)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["band_chain"] == before + 1
        assert torch.equal(out_k, out_p)
        for a, b in zip(st_k, st_p):
            assert torch.equal(a, b)
        state = st_k
    assert int(state.rng[0]) != 1 and bool((state.rng[1:] == 1).all())   # tf > 2: stream 0


def test_spectral_hop_launches_the_kernel_bit_equal_to_the_plain_chain(dev):
    """The one-stream hop (S = 1: the band chain's operands one float
    wide) launches kernel 4 on the card and gives the plain chain's bits."""
    cfg, audios, ends, ctl = _inputs(dev)
    cur, prev = fid._analyse_cur_prev(cfg, audios, ends)
    state = spectral.init_spectral_state(cfg, dev)
    for i in range(ends.shape[1]):
        before = kernels.LAUNCHES["band_chain"]
        st_k, out_k = spectral.spectral_hop(cfg, state, cur[i, 0], prev[i, 0],
                                            *(c[0] for c in ctl[:3]))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["band_chain"] == before + 1
        st_p, out_p = spectral.spectral_hop_batched(
            cfg, tree_map(lambda x: x[None], state), cur[i, :1], prev[i, :1],
            *(c[:1] for c in ctl[:3]), use_kernel=False)
        assert torch.equal(out_k, out_p[0])
        for a, b in zip(st_k, st_p):
            assert torch.equal(a, b[0])
        state = st_k


def test_sharded_fidelity_step_bit_equal_at_world_size_one(dev, tmp_path):
    from bauklank_tpu_torch.parallel import shard_streams, stream_mesh
    from bauklank_tpu_torch.parallel.mesh import sharded_fidelity_step

    cfg, audios, ends, ctl = _inputs(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = stream_mesh()
        step = sharded_fidelity_step(cfg, mesh)
        sh = shard_streams(mesh, (fid.init_batched_fidelity_state(cfg, 8, dev), audios, ends,
                                  *ctl))
        st_sh, out_sh = step(*sh)
        st, out = fid.batched_fidelity_chunk(cfg, fid.init_batched_fidelity_state(cfg, 8, dev),
                                             audios, ends, *ctl)
        assert torch.equal(out_sh.to_local(), out)
        for a, b in zip([*st_sh[0], st_sh[1]], [*st[0], st[1]]):
            assert torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()
