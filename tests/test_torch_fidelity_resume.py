"""PyTorch port, the slice against JAX (continued from test_torch_fidelity.py,
whose helpers and bounds it shares): the overlap-1 geometry (``long_step``
1, the kiosk's), and both packages resumed from one JAX state taken in the
middle of a stream.  Bound: per-stream SNR >= 60 dB, state as there."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu_torch.engine import fidelity as tfid
from test_torch_fidelity import CHUNKS, H, RATES, _check, _controls, _run, _snr


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
