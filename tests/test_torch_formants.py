"""PyTorch port, engine/spectral: the fidelity engine's formant chain
(the blob's step 5) against the JAX package on the CPU, JAX calls eager.

Bounds and why:
- ``_formant_peak``: peak value and folded index bit-equal.  The JAX form
  is a sequential scan over the bands, the port's three first-maximum
  picks over the masked row; comparisons and integer folds only.  Inputs:
  random envelopes, the tonal material, and planted ties and plateaus
  (equal peaks, a peak equal to the seed band, flat runs, a row with no
  candidate).
- The smoother with one coefficient per row: bit-equal (the same
  recursion as the scalar form).
- ``_formant_ema`` and ``_formant_gain_from_width``: relative 1e-6 of the
  peak (eager JAX runs the same float32 operations; the bound leaves room
  for a fused multiply-add inside a JAX primitive).
- ``chain_inputs_hops`` with formants: ``mc``, the MINSTD state bit-equal,
  the EMAs within 1e-6, every operand within the 2e-6 of
  test_torch_chain_inputs.py.
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
from bauklank_tpu_torch.engine import spectral as tspec
from test_torch_spectral import SR, _rel, _t, _tonal_analyses, jax_seq_compsum  # noqa: F401

torch.set_num_threads(1)


def _peak_rows():
    rng = np.random.default_rng(4)
    cur, _ = _tonal_analyses(512, 128, 3, 4)
    b_n = cur.shape[-1]
    rows = [np.abs(rng.standard_normal(b_n)) * 10.0 ** rng.uniform(-6, 6) for _ in range(24)]
    rows += list((np.abs(cur) ** 2).sum(2).reshape(-1, cur.shape[-1]))
    base = np.abs(rng.standard_normal(b_n)) * 0.1

    def planted(**at):
        r = base.copy()
        for b, v in at.items():
            r[int(b[1:])] = v
        return r

    rows += [
        planted(b40=5.0, b90=5.0, b200=5.0),            # three equal peaks
        planted(b40=5.0, b90=5.0, b200=5.0, b230=5.0),  # a fourth equal one stays out
        planted(b0=5.0, b60=5.0, b61=1.0),              # a peak equal to the seed band
        planted(b0=9.0, b60=5.0),                       # the seed above every peak
        planted(b30=4.0, b31=4.0, b32=4.0, b120=4.0),   # a plateau: its last band counts
        planted(b50=3.0, b100=7.0, b150=7.0, b151=2.0),  # the maximum tied, second first
        planted(b64=8.0, b128=7.9, b192=0.2),           # harmonic folds: 128 % 64
        planted(b10=8.0, b100=7.0, b190=6.0),
        np.linspace(1.0, 0.0, b_n),                     # monotone: no candidate
        np.zeros(b_n),
        np.ones(b_n),
    ]
    return np.stack([np.asarray(r, np.float32)[:b_n] for r in rows])


def test_formant_peak_bit_equal():
    rows = _peak_rows()
    want_v, want_i = jax.vmap(jspec._formant_peak)(jnp.asarray(rows))
    got_v, got_i = tspec._formant_peak(_t(rows))
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert len(set(np.asarray(want_i).tolist())) > 8      # the folds and picks vary


def test_smoother_with_a_coefficient_per_row_bit_equal():
    rng = np.random.default_rng(1)
    e = np.abs(rng.standard_normal((5, 3, 257))).astype(np.float32)
    coef = rng.uniform(0.01, 0.9, (5, 3)).astype(np.float32)
    carry = rng.uniform(0, 2, (5, 3)).astype(np.float32)
    js, jc = jspec._smooth_bidirectional(jnp.asarray(e), jnp.asarray(coef), jnp.asarray(carry))
    ts, tc = tspec._smooth_bidirectional(_t(e), _t(coef), _t(carry))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_formant_ema_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    pv = np.abs(rng.standard_normal(n) * 100).astype(np.float32)
    i5 = rng.integers(0, 3000, n).astype(np.int32)
    v0 = np.abs(rng.standard_normal(n) * 50).astype(np.float32)
    w0 = np.abs(rng.standard_normal(n) * 5e4).astype(np.float32)
    v0[:4], w0[:4] = 0.0, 0.0                       # a fresh tracker
    upd = rng.integers(0, 2, n).astype(bool)
    want = jspec._formant_ema(*map(jnp.asarray, (pv, i5, v0, w0, upd)))
    got = tspec._formant_ema(*map(_t, (pv, i5, v0, w0, upd)))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-6
    # frozen where not updated, bit for bit
    np.testing.assert_array_equal(got[1].numpy()[~upd], v0[~upd])
    np.testing.assert_array_equal(got[2].numpy()[~upd], w0[~upd])


def _formant_controls():
    """Four streams: shift up, compensation under a pitch shift, both with
    an explicit base, and a neutral voice."""
    st = np.asarray([0.0, 12.0, -7.0, 5.0], np.float32)
    mult = np.exp2(st / 12).astype(np.float32)
    limit = ((8000 / SR) / np.sqrt(mult)).astype(np.float32)
    ff = np.exp2(np.asarray([7.0, 0.0, -5.0, 0.0]) / 12).astype(np.float32)
    fc = np.asarray([0.0, 1.0, 1.0, 0.0], np.float32)
    fb = np.asarray([0.0, 0.0, 200.0 / SR, 0.0], np.float32)
    return mult, limit, ff, fc, fb


def test_formant_gain_from_width_matches_jax():
    block, interval, h, s_n = 512, 128, 4, 4
    cfg_j = jspec.SpectralConfig(2, block, interval, formants=True)
    cfg_t = tspec.SpectralConfig(2, block, interval, formants=True)
    cur, _ = _tonal_analyses(block, interval, s_n, h)
    env_e = (np.abs(cur) ** 2).sum(2).astype(np.float32)            # [H, S, B]
    mult, limit, ff, fc, _ = _formant_controls()
    width = np.random.default_rng(3).uniform(1.0, 40.0, (h, s_n)).astype(np.float32)
    active = (ff != 1.0) | ((fc != 0.0) & (mult != 1.0))
    want = jax.vmap(
        lambda ee, wd, a, m, l, f, c: jspec._formant_gain_from_width(cfg_j, ee, wd, a, m, l, f, c),
        in_axes=(1, 1, 0, 0, 0, 0, 0), out_axes=1,
    )(*map(jnp.asarray, (env_e, width, active, mult, limit, ff, fc)))
    got = tspec._formant_gain_from_width(
        cfg_t, *map(_t, (env_e, width, active, mult, limit, ff, fc)))
    assert got.shape == env_e.shape
    assert _rel(got, want) < 1e-6
    assert np.asarray(want).max() > 1.5                   # the gain does something
    assert (got[:, 3] == 1.0).all()                       # the neutral voice: exactly 1


@pytest.mark.parametrize("rates", [(0.5, 1.3, 2.0, 1.0), (0.25, 1.0, 0.02, 1.0)],
                         ids=["tf<=2", "tf>2"])
def test_chain_inputs_hops_with_formants(rates, jax_seq_compsum):
    block, interval, h, s_n = 512, 128, 4, 4
    cfg_j = jspec.SpectralConfig(2, block, interval, formants=True)
    cfg_t = tspec.SpectralConfig(2, block, interval, formants=True)
    cur, prev = _tonal_analyses(block, interval, s_n, h)
    tf = np.asarray([min(1 / r, interval) for r in rates], np.float32)
    mult, limit, ff, fc, fb = _formant_controls()
    rng = np.random.default_rng(3)
    st_j = jfid.init_batched_fidelity_state(cfg_j, s_n)
    st_j = (st_j[0]._replace(
        rng=jnp.asarray([1, 987654321, 2147483000, 7], jnp.uint32),
        prev_pred_energy=jnp.asarray(rng.uniform(0, 50, (s_n, 2, cfg_j.bands)), jnp.float32),
        f_value_ema=jnp.asarray([0.0, 3.5, 1.0, 2.0], jnp.float32),
        f_weighted_ema=jnp.asarray([0.0, 90.0, 30.0, 44.0], jnp.float32)),
        st_j[1])
    st_t = tfid.fidelity_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    np.testing.assert_array_equal(st_t[0].f_weighted_ema.numpy(), [0.0, 90.0, 30.0, 44.0])
    ctl = (tf, mult, limit, ff, fc, fb)
    xs_j, (rj, fvj, fwj) = jspec.chain_inputs_hops(
        cfg_j, st_j[0], jnp.asarray(cur), jnp.asarray(prev), *map(jnp.asarray, ctl))
    xs_t, (rt, fvt, fwt) = tspec.chain_inputs_hops(
        cfg_t, st_t[0], _t(cur), _t(prev), *map(_t, ctl))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    assert _rel(fvt, fvj) < 1e-6 and _rel(fwt, fwj) < 1e-6
    # the trackers advance only for an active voice on auto f0: streams 0 and 1
    assert (fvt.numpy()[:2] != [0.0, 3.5]).all()
    np.testing.assert_array_equal(fvt.numpy()[2:], [1.0, 2.0])
    np.testing.assert_array_equal(fwt.numpy()[2:], [30.0, 44.0])
    assert set(xs_t) == set(xs_j)
    np.testing.assert_array_equal(xs_t["mc"].numpy(), np.asarray(xs_j["mc"]))
    for k in xs_j:
        assert _rel(xs_t[k], xs_j[k]) < 2e-6, k
    # the formants change the energies, and only those
    plain_t, _ = tspec.chain_inputs_hops(cfg_t, st_t[0], _t(cur), _t(prev), *map(_t, ctl[:3]))
    assert _rel(xs_t["pred_energy"][:, :3], plain_t["pred_energy"][:, :3]) > 1e-2
    assert torch.equal(xs_t["pred_energy"][:, 3], plain_t["pred_energy"][:, 3])
    assert torch.equal(xs_t["pred_input"], plain_t["pred_input"])
