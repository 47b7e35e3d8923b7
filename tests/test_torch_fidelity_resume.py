"""PyTorch port, the slice against JAX (continued from test_torch_fidelity.py,
whose helpers and bounds it shares): the overlap-1 geometry (``long_step``
1, the kiosk's), and both packages resumed from one JAX state taken in the
middle of a stream.  Bound: per-stream SNR >= 60 dB, state as there.  And
the port's live state (spectral state with formant trackers, tail, input
ring) through the numpy converters in the middle of a stream: the
continued render equals the uninterrupted one exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu_torch.engine import fidelity as tfid
from test_torch_fidelity import CHUNKS, H, RATES, SR, _check, _controls, _run, _snr, _t


def test_slice_matches_jax_long_step_1():
    cfg_j, audios, ends, ctl = _controls(1024, True)
    state_j = jfid.init_batched_fidelity_state(cfg_j, len(RATES))
    state0 = jax.tree.map(np.asarray, state_j)
    state_t = tfid.fidelity_state_from_numpy(state0, "cpu")
    out = _run(cfg_j, state_j, state_t, audios, ends, ctl, CHUNKS)
    _check(*out, state0)


def test_slice_from_jax_mid_stream_state():
    """Both packages resume from one JAX state taken in the middle of a
    stream (after two chunks, with MINSTD advanced on the tf > 2 stream)."""
    interval = 256
    cfg_j, audios, ends, ctl = _controls(interval, True)
    ctl = ctl[:3] + (np.ones(3, np.float32),)     # every stream active
    state_j = jfid.init_batched_fidelity_state(cfg_j, len(RATES))
    for c in range(2):
        e = ends[:, c * H:(c + 1) * H]
        state_j, _ = jfid.batched_fidelity_chunk(
            cfg_j, state_j, jnp.asarray(audios), jnp.asarray(e), *map(jnp.asarray, ctl))
    mid = jax.tree.map(np.asarray, state_j)
    assert mid[0].rng[2] != 1                     # the MINSTD stream advanced
    state_t = tfid.fidelity_state_from_numpy(mid, "cpu")
    back = tfid.fidelity_state_to_numpy(state_t)
    for g, w in zip([*back[0], back[1]], [*mid[0], mid[1]]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    state_j2, state_t2, emit_j, emit_t = _run(
        cfg_j, state_j, state_t, audios, ends[:, 2 * H:], ctl, 1)
    for i in range(3):
        assert _snr(emit_j[i], emit_t[i]) >= 60.0, (i, _snr(emit_j[i], emit_t[i]))
    np.testing.assert_array_equal(
        tfid.fidelity_state_to_numpy(state_t2)[0].rng, np.asarray(state_j2[0].rng))


def test_live_state_round_trips_through_numpy_mid_stream():
    """Four live chunks with formant voices, uninterrupted, against the
    same four with the three-part state taken to numpy (the JAX layout:
    uint32 MINSTD state) and back after the second: emitted audio and
    final state equal bit for bit, and the numpy tree is one the JAX
    package's live chunk accepts."""
    cfg = tfid.SpectralConfig(2, 1024, 256, formants=True)
    x = _controls(256, True)[1]                                   # [3, 2, T]
    n = H * cfg.interval
    mult = np.exp2(np.asarray([-12.0, 0.0, 7.0]) / 12).astype(np.float32)
    ctl = tuple(map(_t, (
        mult, ((8000 / SR) / np.sqrt(mult)).astype(np.float32), np.ones(3, np.float32),
        np.exp2(np.asarray([4.0, -3.0, 0.0]) / 12).astype(np.float32),   # formant_factor
        np.asarray([1.0, 0.0, 0.0], np.float32), np.zeros(3, np.float32))))

    def run(state, chunks):
        out = []
        for c in chunks:
            state, emit = tfid.batched_live_fidelity_chunk(
                cfg, state, _t(x[:, :, c * n:(c + 1) * n]), *ctl)
            out.append(emit)
        return state, torch.cat(out, dim=-1)

    fresh = tfid.init_batched_live_fidelity_state(cfg, H, 3, "cpu")
    whole_state, whole = run(fresh, range(4))
    mid, first = run(fresh, range(2))
    tree = tfid.fidelity_state_to_numpy(mid)
    assert len(tree) == 3 and tree[0].rng.dtype == np.uint32
    assert tree[0].f_value_ema[0] != 0 and tree[2].any()         # trackers and ring in use
    resumed_state, second = run(tfid.fidelity_state_from_numpy(tree, "cpu"), range(2, 4))
    assert torch.equal(torch.cat([first, second], dim=-1), whole)
    for a, b in zip([*resumed_state[0], *resumed_state[1:]], [*whole_state[0], *whole_state[1:]]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the JAX live chunk takes the converted tree as its state
    cfg_j = jfid.SpectralConfig(2, 1024, 256, formants=True)
    spec_j = type(jfid.init_batched_live_fidelity_state(cfg_j, H, 3)[0])(*map(jnp.asarray, tree[0]))
    _, emit_j = jfid.batched_live_fidelity_chunk(
        cfg_j, (spec_j, jnp.asarray(tree[1]), jnp.asarray(tree[2])),
        jnp.asarray(x[:, :, 2 * n:3 * n]), *(jnp.asarray(c.numpy()) for c in ctl))
    for i in range(3):
        assert _snr(np.asarray(emit_j)[i], second[i, :, :n].numpy()) >= 60.0
