"""PyTorch port, the coupled (live-input) drive:
``batched_live_fidelity_chunk`` against the JAX package's, input pushed
chunk by chunk with carried state (spectral state, overlap-add tail and
input ring).

Three streams at {-12, 0, +7} st, the third inactive; 3 chunks of H = 4
hops of tonal material, split on and split off (coupled, only the
placement half of the split-off law applies).  Bound, as in
test_torch_fidelity.py: per-stream SNR >= 60 dB on the emitted audio (the
JAX package's fused arithmetic differs from the port's by ulps that the
renderer amplifies), the carried state within a relative 1e-3; the input
ring is a copy of the input and bit-equal.  Where the JAX package lets a
chunk that does not fit the ring read zeros, the port raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu_torch.engine import fidelity as tfid
from test_torch_fidelity import ACTIVE, CHUNKS, H, SEMITONES, SR, _snr, _t, material


def _live_controls(split):
    cfg_j = jspec.SpectralConfig(2, 1024, 256, split=split)
    cfg_t = tfid.SpectralConfig(2, 1024, 256, split=split)
    x = material.case_input(1.0, 2, seconds=1.0)
    audios = np.stack([np.roll(x, 977 * i, axis=-1) for i in range(3)])
    mult = np.exp2(np.asarray(SEMITONES) / 12).astype(np.float32)
    limit = ((8000 / SR) / np.sqrt(mult)).astype(np.float32)
    return cfg_j, cfg_t, audios, (mult, limit, np.asarray(ACTIVE, np.float32))


@pytest.mark.parametrize("split", [True, False], ids=["split_on", "split_off"])
def test_live_chunks_match_jax(split):
    cfg_j, cfg_t, audios, ctl = _live_controls(split)
    state_j = jfid.init_batched_live_fidelity_state(cfg_j, H, 3)
    state0 = jax.tree.map(np.asarray, state_j)
    state_t = tfid.fidelity_state_from_numpy(state0, "cpu")
    assert len(state_t) == 3
    assert state_t[2].shape == (3, 2, tfid.live_fidelity_ring_len(cfg_t, H))
    assert tfid.live_fidelity_ring_len(cfg_t, H) == jfid.live_fidelity_ring_len(cfg_j, H)
    n = H * cfg_t.interval
    out_j, out_t = [], []
    for c in range(CHUNKS):
        chunk = audios[:, :, c * n:(c + 1) * n]
        state_j, ej = jfid.batched_live_fidelity_chunk(
            cfg_j, state_j, jnp.asarray(chunk), *map(jnp.asarray, ctl))
        state_t, et = tfid.batched_live_fidelity_chunk(cfg_t, state_t, _t(chunk), *map(_t, ctl))
        out_j.append(np.asarray(ej))
        out_t.append(et.numpy())
    emit_j, emit_t = np.concatenate(out_j, -1), np.concatenate(out_t, -1)
    assert emit_t.shape == emit_j.shape == (3, 2, CHUNKS * n)
    for i, a in enumerate(ACTIVE):
        if a:
            assert _snr(emit_j[i], emit_t[i]) >= 60.0, (i, _snr(emit_j[i], emit_t[i]))
        else:
            assert not emit_t[i].any() and not emit_j[i].any()
    got = tfid.fidelity_state_to_numpy(state_t)
    want = jax.tree.map(np.asarray, state_j)
    np.testing.assert_array_equal(got[2], want[2])             # the ring: the last input
    np.testing.assert_array_equal(got[2][..., -n:], audios[:, :, (CHUNKS - 1) * n:CHUNKS * n])
    np.testing.assert_array_equal(got[0].rng, want[0].rng)
    for g, w in zip([*got[0], got[1]], [*want[0], want[1]]):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = np.abs(g.astype(np.complex128) - w).max()
        assert err <= 1e-3 * max(np.abs(w).max(), 1e-30), err
    # the inactive stream's spectral state and tail are frozen bit for bit
    for g, w0 in zip([*got[0], got[1]], [*state0[0], state0[1]]):
        np.testing.assert_array_equal(g[2], w0[2])


def test_live_chunk_is_the_file_step_on_the_ring():
    """A live chunk equals ``batched_fidelity_chunk`` on the rolled ring
    with the constant ends, time factor 1 and ``coupled=True``: the same
    tensors, bit for bit (the second chunk, whose windows are all signal);
    and with split off the coupled prev analysis keeps its full window,
    where the file drive zeroes its first interval."""
    _, cfg, audios, ctl = _live_controls(False)
    n = H * cfg.interval
    ctl_t = tuple(map(_t, ctl[:2])) + (torch.ones(3),)
    state = tfid.init_batched_live_fidelity_state(cfg, H, 3, "cpu")
    state, _ = tfid.batched_live_fidelity_chunk(cfg, state, _t(audios[:, :, :n]), *ctl_t)
    (spec, tail, ring), emit = tfid.batched_live_fidelity_chunk(
        cfg, state, _t(audios[:, :, n:2 * n]), *ctl_t)
    el = ring.shape[-1]
    assert torch.equal(ring[..., :el - n], state[2][..., n:])
    ends = (el - (H - torch.arange(H)) * cfg.interval)[None].expand(3, H)
    (spec_f, tail_f), emit_f = tfid.batched_fidelity_chunk(
        cfg, state[:2], ring, ends, torch.ones(3), *ctl_t, coupled=True)
    assert torch.equal(emit, emit_f) and torch.equal(tail, tail_f)
    assert torch.equal(spec.prev_output, spec_f.prev_output)
    _, emit_seek = tfid.batched_fidelity_chunk(cfg, state[:2], ring, ends, torch.ones(3), *ctl_t)
    assert not torch.equal(emit_seek, emit)
    cur, prev = tfid._analyse_cur_prev(cfg, ring, ends, full_prev=True)
    cur_z, prev_z = tfid._analyse_cur_prev(cfg, ring, ends)
    assert torch.equal(cur, cur_z) and not torch.equal(prev, prev_z)


def test_live_chunk_refuses_hops_that_do_not_fit_the_ring():
    _, cfg, audios, ctl = _live_controls(True)
    state = tfid.init_batched_live_fidelity_state(cfg, H, 3, "cpu")
    too_long = _t(audios[:, :, : (H + 1) * cfg.interval])
    with pytest.raises(ValueError, match="needs a ring"):
        tfid.batched_live_fidelity_chunk(cfg, state, too_long, *map(_t, ctl))
    with pytest.raises(ValueError, match="whole number"):
        tfid.batched_live_fidelity_chunk(cfg, state, too_long[:, :, :300], *map(_t, ctl))
    # fewer hops than the ring was built for are served
    _, emit = tfid.batched_live_fidelity_chunk(
        cfg, state, _t(audios[:, :, : 2 * cfg.interval]), *map(_t, ctl))
    assert emit.shape == (3, 2, 2 * cfg.interval)
