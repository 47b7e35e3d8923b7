"""PyTorch port, engine/spectral: the peaks map and the hop-local stage
(``chain_inputs_hops``) against the JAX package on the CPU (see
test_torch_spectral.py, which this file shares its helpers with; it is a
file of its own to keep each file's run short).

Bounds and why:
- The peaks map is bit-equal against JAX running the TPU product path's
  sequential compensated cumsum; against JAX's CPU default (an associative
  tree, which rounds the prefix sums otherwise) it is held to a small
  absolute bound in bins.
- The hop-local stage, in the tf <= 2 and the MINSTD (tf > 2) regimes:
  ``mc`` and the MINSTD state bit-equal; every other operand within a
  relative 2e-6 of its peak, because XLA rounds its complex products with
  an FMA (a few ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu_torch.engine import fidelity as tfid
from bauklank_tpu_torch.engine import spectral as tspec
from test_torch_spectral import SR, _rel, _t, _tonal_analyses, jax_seq_compsum  # noqa: F401


# -------------------------------------------------------------- peaks map
def _peaks_inputs():
    cur, _ = _tonal_analyses(1024, 256, 4, 4)
    e = (np.abs(cur) ** 2).sum(2).reshape(-1, cur.shape[-1]).astype(np.float32)
    coef = 1.0 / (0.5 * (1024 / 256) + 1.0)
    sm, carry = jspec._smooth_bidirectional(jnp.asarray(e), coef, jnp.zeros(e.shape[0]))
    sm, _ = jspec._smooth_bidirectional(sm, coef, carry)
    mult = np.exp2(np.array([0.0, -12.0, 7.0, 12.0] * 4) / 12).astype(np.float32)
    limit = ((8000 / SR) / np.sqrt(mult)).astype(np.float32)
    return e, np.asarray(sm), mult, limit


def _peaks_both(e, sm, mult, limit):
    b_n = e.shape[1]
    ji, jg = jspec._find_peaks_map_batched(
        jnp.asarray(e), jnp.asarray(sm), jnp.asarray(mult), jnp.asarray(limit),
        b_n, 2 * b_n, jspec._peaks_block_t(b_n))
    ti, tg = tspec._find_peaks_map_batched(_t(e), _t(sm), _t(mult), _t(limit), b_n, 2 * b_n)
    return (np.asarray(ji), np.asarray(jg)), (ti.numpy(), tg.numpy())


def test_peaks_map_bit_equal_vs_sequential_compsum(jax_seq_compsum):
    (ji, jg), (ti, tg) = _peaks_both(*_peaks_inputs())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tg, jg)


def test_peaks_map_vs_jax_cpu_tree():
    (ji, jg), (ti, tg) = _peaks_both(*_peaks_inputs())
    # the tree and the fold round the run sums differently: centers move by
    # ulps of the prefix sums, i.e. a small fraction of a bin
    assert np.abs(ti - ji).max() < 2e-3
    assert np.abs(tg - jg).max() < 1e-2
    assert np.mean(ti == ji) > 0.9


# ----------------------------------------------------- hop-local stage
@pytest.mark.parametrize("rates", [(0.5, 1.3, 2.0), (0.25, 0.02, 1.0)],
                         ids=["tf<=2", "tf>2"])
def test_chain_inputs_hops(rates, jax_seq_compsum):
    block, interval, h = 1024, 256, 4
    cfg_j = jspec.SpectralConfig(2, block, interval)
    cfg_t = tspec.SpectralConfig(2, block, interval)
    s_n = len(rates)
    cur, prev = _tonal_analyses(block, interval, s_n, h)
    tf = np.asarray([min(1 / r, interval) for r in rates], np.float32)
    mult = np.exp2(np.array([-12.0, 0.0, 7.0]) / 12).astype(np.float32)
    limit = ((8000 / SR) / np.sqrt(mult)).astype(np.float32)
    rng = np.random.default_rng(3)
    st_j = jfid.init_batched_fidelity_state(cfg_j, s_n)
    st_j = (st_j[0]._replace(
        rng=jnp.asarray([1, 987654321, 2147483000], jnp.uint32),
        prev_pred_energy=jnp.asarray(rng.uniform(0, 50, (s_n, 2, cfg_j.bands)), jnp.float32)),
        st_j[1])
    st_t = tfid.fidelity_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    xs_j, (rj, _, _) = jspec.chain_inputs_hops(
        cfg_j, st_j[0], jnp.asarray(cur), jnp.asarray(prev),
        jnp.asarray(tf), jnp.asarray(mult), jnp.asarray(limit))
    xs_t, (rt, _, _) = tspec.chain_inputs_hops(
        cfg_t, st_t[0], _t(cur), _t(prev), _t(tf), _t(mult), _t(limit))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    assert set(xs_t) == set(xs_j)
    np.testing.assert_array_equal(xs_t["mc"].numpy(), np.asarray(xs_j["mc"]))
    for k in xs_j:
        # XLA rounds its complex products with an FMA; a few ulp of the peak
        assert _rel(xs_t[k], xs_j[k]) < 2e-6, k
