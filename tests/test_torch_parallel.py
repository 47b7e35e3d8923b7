"""PyTorch port, parallel/mesh: stream data parallelism over a process
group.  One spawn of four gloo ranks on the CPU steps the three sharded
steps; each rank writes its shards, and the tests here hold the whole
against the port's unsharded step (bit for bit) and against the JAX
package's sharded step on its own 8-device mesh (the bars of
tests/test_parallel.py and tests/test_torch_fidelity.py).

The ranks are spawned (``torch.multiprocessing.start_processes``, start
method ``spawn``), meet at a ``file://`` store under the test's
temporary directory with a 60 s timeout, and are joined under a 120 s
deadline, after which they are terminated and the fixture fails: a hung
group cannot hold the suite.  A spawned rank imports this module, so its
top level imports numpy, torch and the port only; the JAX package is
imported inside the tests, which run in the parent.
"""

from __future__ import annotations

import datetime
import importlib
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bauklank_tpu_torch.engine import StretchConfig, StretchParams
from bauklank_tpu_torch.engine.batched import batched_process_chunk, init_batched_state
from bauklank_tpu_torch.engine.fidelity import (
    SpectralConfig,
    batched_fidelity_chunk,
    batched_live_fidelity_chunk,
    hop_frame_ends,
    init_batched_fidelity_state,
    init_batched_live_fidelity_state,
)
from bauklank_tpu_torch.engine.offline import frame_ends_for

torch.set_num_threads(1)
SR = 44100.0
WORLD = 4
DEADLINE_SEC = 120.0
S_N = 16


# ------------------------------------------------------------ the ranks
def _rank_entry(rank: int, module: str, fn: str, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        getattr(importlib.import_module(module), fn)(rank, out_dir)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, out_dir, deadline: float = DEADLINE_SEC) -> None:
    """Run ``fn(rank, out_dir)`` on ``world`` spawned gloo ranks; fail if a
    rank raises or if they have not all finished within ``deadline``
    seconds (the stragglers are terminated)."""
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(fn.__module__, fn.__name__, world, os.path.join(out_dir, "store"),
                           str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise AssertionError(f"{world} ranks did not finish within {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)


def _fast_inputs():
    cfg = StretchConfig(channels=2, block=512, interval=128, formants=True)
    rng = np.random.default_rng(0)
    audios = (rng.standard_normal((S_N, 2, 12000)) * 0.2).astype(np.float32)
    rates = np.linspace(0.5, 2.0, S_N)
    params = StretchParams.stack([
        StretchParams.make(rate=r, semitones=s, sample_rate=SR, device="cpu")
        for r, s in zip(rates, np.linspace(-12, 12, S_N))])
    ends = np.stack([frame_ends_for(cfg, 0, 16, r) for r in rates]).astype(np.int32)
    return cfg, audios, (ends, ends + 16 * cfg.interval), params


def _fidelity_inputs():
    cfg = SpectralConfig(2, 512, 128, formants=True)
    rng = np.random.default_rng(5)
    t = np.arange(9000) / SR
    audios = (np.stack([np.stack([0.3 * np.sin(2 * np.pi * (220 + 5 * k + 3 * c) * t)
                                  for c in range(2)]) for k in range(S_N)])
              + 0.02 * rng.standard_normal((S_N, 2, 9000))).astype(np.float32)
    rates = np.linspace(0.25, 2.0, S_N)          # the first rank's shard draws MINSTD steps
    ends = np.stack([hop_frame_ends(cfg, 3, r, SR, input_offset=600.0 / SR)
                     for r in rates]).astype(np.int32)
    mult = np.exp2(np.linspace(-12, 12, S_N) / 12.0).astype(np.float32)
    ctl = ((1.0 / rates).astype(np.float32), mult,
           ((8000.0 / SR) / np.sqrt(mult)).astype(np.float32), np.ones(S_N, np.float32),
           np.exp2(np.linspace(-5, 5, S_N) / 12.0).astype(np.float32),
           (np.arange(S_N) % 2).astype(np.float32), np.zeros(S_N, np.float32))
    return cfg, audios, (ends, ends + 3 * cfg.interval), ctl


def _live_inputs():
    cfg, hops = SpectralConfig(2, 512, 128), 2
    n = hops * cfg.interval
    t = np.arange(2 * n) / SR
    chunks = [np.stack([np.stack([0.3 * np.sin(2 * np.pi * (220 + 5 * k + 3 * c)
                                               * t[j * n:(j + 1) * n]) for c in range(2)])
                        for k in range(S_N)]).astype(np.float32) for j in range(2)]
    mult = np.exp2(np.linspace(-12, 12, S_N) / 12.0).astype(np.float32)
    ctl = (mult, ((8000.0 / SR) / np.sqrt(mult)).astype(np.float32), np.ones(S_N, np.float32))
    return cfg, hops, chunks, ctl


def _flat(tree):
    for x in tree:
        if isinstance(x, tuple):
            yield from _flat(x)
        else:
            yield x


def _rank_steps(rank: int, out_dir: str) -> None:
    """Each sharded step twice, from a fresh state, on four stream ranks."""
    from torch.distributed.tensor import DTensor, Shard

    from bauklank_tpu_torch.parallel import shard_streams, sharded_step, stream_mesh
    from bauklank_tpu_torch.parallel.mesh import (
        sharded_fidelity_step, sharded_live_fidelity_step)

    mesh = stream_mesh(device_type="cpu")
    saved = {}

    def keep(tag, new_states, out):
        assert isinstance(out, DTensor) and out.placements == (Shard(0),)
        assert out.shape[0] == S_N and out.to_local().shape[0] == S_N // WORLD
        saved[f"{tag}_out"] = out.to_local().numpy()
        for i, leaf in enumerate(_flat(new_states)):
            saved[f"{tag}_state{i}"] = leaf.to_local().numpy()

    cfg, audios, ends, params = _fast_inputs()
    step = sharded_step(cfg, mesh)
    states, aud, e0, prm = shard_streams(mesh, (init_batched_state(cfg, S_N, "cpu"), audios,
                                                ends[0], params))
    states, out = step(states, aud, e0, prm)
    keep("fast1", states, out)
    states, out = step(states, aud, shard_streams(mesh, ends[1]), prm)
    keep("fast2", states, out)

    cfg, audios, ends, ctl = _fidelity_inputs()
    step = sharded_fidelity_step(cfg, mesh, formants=True)
    sh = shard_streams(mesh, (init_batched_fidelity_state(cfg, S_N, "cpu"), audios, ends[0])
                       + ctl)
    states, out = step(*sh)
    keep("fid1", states, out)
    states, out = step(states, sh[1], shard_streams(mesh, ends[1]), *sh[3:])
    keep("fid2", states, out)

    cfg, hops, chunks, ctl = _live_inputs()
    step = sharded_live_fidelity_step(cfg, hops, mesh)
    sh = shard_streams(mesh, (init_batched_live_fidelity_state(cfg, hops, S_N, "cpu"),
                              chunks[0]) + ctl)
    states, out = step(*sh)
    keep("live1", states, out)
    states, out = step(states, shard_streams(mesh, chunks[1]), *sh[2:])
    keep("live2", states, out)

    # six streams do not divide over four ranks
    try:
        shard_streams(mesh, np.zeros((6, 2), np.float32))
        saved["refused_ragged"] = np.asarray(False)
    except ValueError:
        saved["refused_ragged"] = np.asarray(True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("stream_dp")
    spawn_ranks(_rank_steps, WORLD, str(out_dir))
    files = [np.load(out_dir / f"rank{r}.npz") for r in range(WORLD)]
    whole = {k: np.concatenate([f[k] for f in files]) for k in files[0].files
             if k != "refused_ragged"}
    whole["refused_ragged"] = [bool(f["refused_ragged"]) for f in files]
    return whole


def _snr(ref, got):
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-30)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------- fast engine's step
def test_sharded_step_bit_equal_to_unsharded(shards):
    cfg, audios, ends, params = _fast_inputs()
    states = init_batched_state(cfg, S_N, "cpu")
    for k, e in enumerate(ends, start=1):
        states, out = batched_process_chunk(cfg, states, _t(audios), _t(e), params)
        np.testing.assert_array_equal(shards[f"fast{k}_out"], out.numpy())
        for i, leaf in enumerate(states):
            np.testing.assert_array_equal(shards[f"fast{k}_state{i}"], leaf.numpy())


def test_sharded_step_matches_jax(shards):
    import jax.numpy as jnp

    from bauklank_tpu.engine import StretchParams as JParams
    from bauklank_tpu.engine.batched import init_batched_state as j_init
    from bauklank_tpu.parallel import shard_streams, sharded_step, stream_mesh

    cfg, audios, ends, params = _fast_inputs()
    cfg_j = _jax_stretch_config(cfg)
    mesh = stream_mesh(8)
    jparams = JParams(*[jnp.asarray(f.numpy()) for f in params])
    step = sharded_step(cfg_j, mesh)
    states, aud, e0, prm = shard_streams(mesh, (j_init(cfg_j, S_N),
                                                jnp.asarray(audios), jnp.asarray(ends[0]),
                                                jparams))
    states, out1 = step(states, aud, e0, prm)
    _, out2 = step(states, aud, shard_streams(mesh, jnp.asarray(ends[1])), prm)
    assert len(out1.sharding.device_set) == 8
    np.testing.assert_allclose(shards["fast1_out"], np.asarray(out1), atol=2e-4)
    np.testing.assert_allclose(shards["fast2_out"], np.asarray(out2), atol=2e-4)


def _jax_stretch_config(cfg):
    from bauklank_tpu.engine import StretchConfig as JConfig

    return JConfig(channels=cfg.channels, block=cfg.block, interval=cfg.interval,
                   formants=cfg.formants)


# ------------------------------------------------------ fidelity steps
def test_sharded_fidelity_step_bit_equal_to_unsharded(shards):
    cfg, audios, ends, ctl = _fidelity_inputs()
    states = init_batched_fidelity_state(cfg, S_N, "cpu")
    for k, e in enumerate(ends, start=1):
        states, out = batched_fidelity_chunk(cfg, states, _t(audios), _t(e), *map(_t, ctl))
        np.testing.assert_array_equal(shards[f"fid{k}_out"], out.numpy())
        for i, leaf in enumerate(_flat(states)):
            np.testing.assert_array_equal(shards[f"fid{k}_state{i}"], leaf.numpy())
    # the first rank's shard drew MINSTD steps, the others did not
    assert (shards["fid2_state2"][:3] != 1).all() and (shards["fid2_state2"][4:] == 1).all()


def test_sharded_fidelity_step_matches_jax(shards):
    import jax.numpy as jnp

    from bauklank_tpu.engine import fidelity as jfid
    from bauklank_tpu.parallel import shard_streams, stream_mesh
    from bauklank_tpu.parallel.mesh import sharded_fidelity_step

    cfg, audios, ends, ctl = _fidelity_inputs()
    cfg_j = jfid.SpectralConfig(cfg.channels, cfg.block, cfg.interval, formants=True)
    mesh = stream_mesh(8)
    step = sharded_fidelity_step(cfg_j, mesh, formants=True)
    sh = shard_streams(mesh, (jfid.init_batched_fidelity_state(cfg_j, S_N), jnp.asarray(audios),
                              jnp.asarray(ends[0])) + tuple(map(jnp.asarray, ctl)))
    states, out1 = step(*sh)
    states, out2 = step(states, sh[1], shard_streams(mesh, jnp.asarray(ends[1])), *sh[3:])
    want = np.concatenate([np.asarray(out1), np.asarray(out2)], -1)
    got = np.concatenate([shards["fid1_out"], shards["fid2_out"]], -1)
    for i in range(S_N):
        assert _snr(want[i], got[i]) >= 60.0, (i, _snr(want[i], got[i]))
    np.testing.assert_array_equal(shards["fid2_state2"],
                                  np.asarray(states[0].rng).astype(np.int64))


def test_sharded_live_fidelity_step_bit_equal_to_unsharded(shards):
    cfg, hops, chunks, ctl = _live_inputs()
    states = init_batched_live_fidelity_state(cfg, hops, S_N, "cpu")
    for k, c in enumerate(chunks, start=1):
        states, out = batched_live_fidelity_chunk(cfg, states, _t(c), *map(_t, ctl))
        np.testing.assert_array_equal(shards[f"live{k}_out"], out.numpy())
        for i, leaf in enumerate(_flat(states)):
            np.testing.assert_array_equal(shards[f"live{k}_state{i}"], leaf.numpy())


def test_sharded_live_fidelity_step_matches_jax(shards):
    import jax.numpy as jnp

    from bauklank_tpu.engine import fidelity as jfid
    from bauklank_tpu.parallel import shard_streams, stream_mesh
    from bauklank_tpu.parallel.mesh import sharded_live_fidelity_step

    cfg, hops, chunks, ctl = _live_inputs()
    cfg_j = jfid.SpectralConfig(cfg.channels, cfg.block, cfg.interval)
    mesh = stream_mesh(8)
    step = sharded_live_fidelity_step(cfg_j, hops, mesh)
    sh = shard_streams(mesh, (jfid.init_batched_live_fidelity_state(cfg_j, hops, S_N),
                              jnp.asarray(chunks[0])) + tuple(map(jnp.asarray, ctl)))
    states, out1 = step(*sh)
    states, out2 = step(states, shard_streams(mesh, jnp.asarray(chunks[1])), *sh[2:])
    want = np.concatenate([np.asarray(out1), np.asarray(out2)], -1)
    got = np.concatenate([shards["live1_out"], shards["live2_out"]], -1)
    for i in range(S_N):
        assert _snr(want[i], got[i]) >= 60.0, (i, _snr(want[i], got[i]))
    np.testing.assert_array_equal(shards["live2_state2"],
                                  np.asarray(states[0].rng).astype(np.int64))


# ------------------------------------------------------------ refusals
def test_ragged_stream_count_refused(shards):
    assert shards["refused_ragged"] == [True] * WORLD


def test_stream_mesh_needs_a_process_group():
    from bauklank_tpu_torch.parallel import stream_mesh
    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh

    assert not dist.is_initialized()
    for make in (lambda: stream_mesh(device_type="cpu"), lambda: stream_seq_mesh(1, 1, "cpu")):
        with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
            make()


def test_steps_refuse_what_is_not_stream_sharded(tmp_path):
    from bauklank_tpu_torch.parallel import shard_streams, sharded_step, stream_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = stream_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="spans the process group"):
            stream_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="leading stream axis"):
            shard_streams(mesh, np.float32(1.0))
        cfg, audios, ends, params = _fast_inputs()
        sh = shard_streams(mesh, (init_batched_state(cfg, S_N, "cpu"), audios, ends[0], params))
        with pytest.raises(TypeError, match="DTensors"):
            sharded_step(cfg, mesh)(sh[0], _t(audios), sh[2], sh[3])
    finally:
        dist.destroy_process_group()
