"""PyTorch port, the slice with formant voices: ``batched_fidelity_chunk``
against the JAX package's with the formant controls given, state carried
over 3 chunks of H = 4 hops (helpers and the bound of
test_torch_fidelity.py: per-stream SNR >= 60 dB on the emitted audio,
because the JAX package's fused arithmetic differs from the port's by ulps
that the renderer amplifies; the carried state, the formant trackers
included, within its relative 1e-3).

Three streams at rates {0.5, 1.3, 0.25} and {-12, 0, +7} st: formant
compensation under the pitch shift, a formant shift at no pitch shift
(both on auto f0), and a compensated formant shift on an explicit base on
the inactive stream, whose trackers must stay frozen.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu_torch.engine import fidelity as tfid
from test_torch_fidelity import CHUNKS, H, RATES, SR, _check, _controls, _snr, _t

FORMANTS = (
    np.exp2(np.asarray([0.0, 7.0, -5.0]) / 12).astype(np.float32),   # formant_factor
    np.asarray([1.0, 0.0, 1.0], np.float32),                        # formant_compensation
    np.asarray([0.0, 0.0, 200.0 / SR], np.float32),                 # formant_base
)


def _run_formants(cfg_j, state_j, state_t, audios, ends, ctl, formants):
    cfg_t = tfid.SpectralConfig(cfg_j.channels, cfg_j.block, cfg_j.interval,
                                formants=cfg_j.formants, split=cfg_j.split)
    out_j, out_t = [], []
    for c in range(CHUNKS):
        e = ends[:, c * H:(c + 1) * H]
        state_j, ej = jfid.batched_fidelity_chunk(
            cfg_j, state_j, jnp.asarray(audios), jnp.asarray(e), *map(jnp.asarray, ctl),
            *map(jnp.asarray, formants))
        state_t, et = tfid.batched_fidelity_chunk(
            cfg_t, state_t, _t(audios), _t(e), *map(_t, ctl), *map(_t, formants))
        out_j.append(np.asarray(ej))
        out_t.append(et.numpy())
    return state_j, state_t, np.concatenate(out_j, -1), np.concatenate(out_t, -1)


def test_slice_with_formant_voices_matches_jax():
    cfg_j, audios, ends, ctl = _controls(256, True)
    cfg_j = cfg_j._replace(formants=True)
    state_j = jfid.init_batched_fidelity_state(cfg_j, len(RATES))
    state_j = (state_j[0]._replace(f_value_ema=jnp.asarray([0.0, 0.5, 2.0], jnp.float32),
                                   f_weighted_ema=jnp.asarray([0.0, 20.0, 70.0], jnp.float32)),
               state_j[1])
    state0 = jax.tree.map(np.asarray, state_j)
    state_t = tfid.fidelity_state_from_numpy(state0, "cpu")
    out = _run_formants(cfg_j, state_j, state_t, audios, ends, ctl, FORMANTS)
    _check(*out, state0)
    got = tfid.fidelity_state_to_numpy(out[1])[0]
    # auto-f0 voices moved their trackers; the inactive one kept them
    assert (got.f_value_ema[:2] != state0[0].f_value_ema[:2]).all()
    assert got.f_value_ema[2] == 2.0 and got.f_weighted_ema[2] == 70.0


def test_formant_controls_change_the_audio_and_neutral_ones_do_not():
    """With ``cfg.formants`` on, neutral controls (factor 1, no
    compensation) give exactly the formants-off audio and state (the
    blob's gate); a formant shift changes the audio."""
    cfg_j, audios, ends, ctl = _controls(256, True)
    off = tfid.SpectralConfig(2, cfg_j.block, cfg_j.interval)
    on = off._replace(formants=True)
    args = (_t(audios), _t(ends[:, :H]), *map(_t, ctl[:3]), torch.ones(3))
    state = lambda cfg: tfid.init_batched_fidelity_state(cfg, 3, "cpu")
    (spec0, tail0), emit0 = tfid.batched_fidelity_chunk(off, state(off), *args)
    neutral = (torch.ones(3), torch.zeros(3), torch.zeros(3))
    (spec1, tail1), emit1 = tfid.batched_fidelity_chunk(on, state(on), *args, *neutral)
    assert torch.equal(emit1, emit0) and torch.equal(tail1, tail0)
    for a, b in zip(spec1, spec0):
        assert torch.equal(a, b)
    _, emit2 = tfid.batched_fidelity_chunk(on, state(on), *args, *map(_t, FORMANTS))
    assert _snr(emit0.numpy(), emit2.numpy()) < 30.0
    # formant controls without cfg.formants are ignored, as in JAX
    _, emit3 = tfid.batched_fidelity_chunk(off, state(off), *args, *map(_t, FORMANTS))
    assert torch.equal(emit3, emit0)
