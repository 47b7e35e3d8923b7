"""PyTorch port, kernels 6 and 7 (``pallas_gather``, ``chainfetch``) and
the fused route of the hop-local stage, on the CPU.

- ``chainfetch`` (CPU tensors: its plain version) against the JAX
  ``chainfetch`` Pallas kernel in interpret mode, and ``pallas_gather``
  against the JAX ``pallas_gather``, at the shapes and adversarial inputs
  of tests/test_chainfetch.py: bit-equal (the kernels copy float32 rows and
  round each product and the sum once).  At a band grid the TPU kernel
  cannot host, against the two plain gathers it replaces: bit-equal.
- ``_hop_inputs_hoisted`` with ``BAUKLANK_CHAINFETCH`` on against off,
  torch against torch: every operand bit-equal in the deterministic
  regime; with one stream at time factor > 2 the fused fetch is not taken.
- The pool's host-side word on the regime agrees with the device's time
  factors at the float32 edge of rate 0.5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bauklank_tpu.ops.pallas.chainfetch import chainfetch as jax_chainfetch
from bauklank_tpu.ops.pallas.chainfetch import chainfetch_t1
from bauklank_tpu.ops.pallas.selection import pallas_gather as jax_pallas_gather
from bauklank_tpu_torch.engine import spectral as tspec
from bauklank_tpu_torch.kernels.chainfetch import chainfetch, chainfetch_ref
from bauklank_tpu_torch.kernels.gather import frac_gather_ref, pallas_gather
from bauklank_tpu_torch.serve import pool as tpool
from test_torch_spectral import _t, _tonal_analyses

torch.set_num_threads(1)


def _adversarial_positions(rng, n, k, b):
    """Positions of every edge class: negative, >= B, integral, block
    boundaries, non-monotone (tests/test_chainfetch.py)."""
    base = rng.uniform(-3.0, b + 3.0, (n, k - 10)).astype(np.float32)
    edges = np.tile(np.asarray([-1.0, -0.25, 0.0, 0.5, 127.75, 128.0, b - 1.0, b - 0.5,
                                float(b), b + 2.0], np.float32), (n, 1))
    return np.concatenate([base, edges], axis=1)


@pytest.mark.parametrize("n,b,p,k", [(5, 3072, 4, 1280), (3, 256, 2, 700), (4, 2688, 6, 512)])
def test_pallas_gather_bit_equal_vs_jax_kernel(n, b, p, k):
    rng = np.random.default_rng(11)
    arrs = (rng.standard_normal((n, b, p)) * 10.0 ** rng.uniform(-12, 12, (n, b, p))
            ).astype(np.float32)
    pos = _adversarial_positions(rng, n, k, b)
    want = np.asarray(jax_pallas_gather(jnp.asarray(arrs), jnp.asarray(pos)))
    got = pallas_gather(_t(arrs), _t(pos)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pallas_gather_serves_shapes_the_tpu_kernel_refuses():
    """B = 250 splits into no whole blocks and K = 7 tiles no lane: the
    port's entry point takes them (its plain version here)."""
    rng = np.random.default_rng(5)
    arrs = rng.standard_normal((2, 250, 3)).astype(np.float32)
    pos = rng.uniform(-2, 252, (2, 7)).astype(np.float32)
    got = pallas_gather(_t(arrs), _t(pos))
    assert torch.equal(got, frac_gather_ref(_t(arrs), _t(pos)))


def _fetch_inputs(b, long_step, n=6, c=2, seed=23):
    """tests/test_chainfetch.py's operands: a non-monotone map in [0, B)
    with exact-edge rows, steps 0.5 to 2.0."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((n, b, 2 * c)).astype(np.float32)
    prev = rng.standard_normal((n, b, 2 * c)).astype(np.float32)
    energy = np.abs(rng.standard_normal((n, b, c))).astype(np.float32)
    ib = rng.uniform(0, b - 1e-3, (n, b)).astype(np.float32)
    ib[:, :4] = [0.0, b - 1.0, b - 0.51, 1.0]
    step = np.asarray([0.5, 0.8, 1.0, 1.3, 1.7, 2.0], np.float32)[:n]
    cc = step[:, None]
    us = np.concatenate([ib[:, 1:], np.zeros((n, 1), np.float32)], 1) - cc
    ul = (np.concatenate([ib[:, long_step:], np.zeros((n, long_step), np.float32)], 1)
          - cc * np.float32(long_step))
    return spec, prev, energy, ib, us.astype(np.float32), ul.astype(np.float32), step


@pytest.mark.parametrize("b,long_step", [(3072, 5), (256, 4), (2688, 4)])
def test_chainfetch_bit_equal_vs_jax_kernel(b, long_step):
    ops = _fetch_inputs(b, long_step)
    five_j, comb_j = jax_chainfetch(*map(jnp.asarray, ops), long_step=long_step,
                                    t1=chainfetch_t1(b, long_step))
    five, comb = chainfetch(*map(_t, ops), long_step)
    assert five.shape == (6, 5 * b, 4) and comb.shape == (6, b, 6)
    np.testing.assert_array_equal(five.numpy(), np.asarray(five_j))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(comb_j))


@pytest.mark.parametrize("b,long_step,c", [(250, 5, 2), (96, 4, 1), (130, 1, 3)])
def test_chainfetch_equals_the_two_gathers_at_any_grid(b, long_step, c):
    """Band grids the TPU kernel refuses (``chainfetch_t1`` is None), one
    and three channels, long_step 1: the fused fetch is the two plain
    gathers on the concatenated positions and planes."""
    assert chainfetch_t1(b, long_step) is None or c != 2
    spec, prev, energy, ib, us, ul, step = map(_t, _fetch_inputs(b, long_step, c=c, seed=b))
    cc = step[:, None]
    pos5 = torch.cat([ib, ib - cc, ib - cc * long_step, us, ul], dim=1)
    five, comb = chainfetch(spec, prev, energy, ib, us, ul, step, long_step)
    assert torch.equal(five, frac_gather_ref(spec, pos5))
    assert torch.equal(comb, frac_gather_ref(torch.cat([prev, energy], dim=2), ib))
    ref = chainfetch_ref(spec, prev, energy, ib, us, ul, step, long_step)
    assert torch.equal(five, ref[0]) and torch.equal(comb, ref[1])


# --------------------------------------------- the route in the hop-local stage
def _hoisted(monkeypatch, switch, rates, semitones, deterministic=None):
    block, interval, h = 512, 128, 4
    cfg = tspec.SpectralConfig(2, block, interval)
    s_n = len(rates)
    cur, prev = _tonal_analyses(block, interval, s_n, h)
    tf = _t(np.asarray([min(1 / r, interval) for r in rates], np.float32))
    mult = np.exp2(np.asarray(semitones) / 12).astype(np.float32)
    limit = ((8000 / 44100.0) / np.sqrt(mult)).astype(np.float32)
    seeds = _t(np.full((h, s_n), 12345, np.int64))
    calls = []
    fetch = tspec.chainfetch
    with monkeypatch.context() as m:
        m.setattr(tspec, "chainfetch", lambda *a: (calls.append(a), fetch(*a))[1])
        m.setenv("BAUKLANK_CHAINFETCH", switch)
        xs = tspec._hop_inputs_hoisted(cfg, _t(cur), _t(prev), seeds, tf, _t(mult), _t(limit),
                                       deterministic=deterministic)
    return xs, calls


@pytest.mark.parametrize("semitones", [(0.0, 0.0, 0.0), (-12.0, 5.0, 12.0)],
                         ids=["neutral_map", "active_map"])
@pytest.mark.parametrize("deterministic", [None, True], ids=["regime_read", "regime_given"])
def test_fused_route_equals_the_two_gathers(monkeypatch, semitones, deterministic):
    rates = (0.5, 1.3, 2.0)
    off, none = _hoisted(monkeypatch, "0", rates, semitones, deterministic)
    on, calls = _hoisted(monkeypatch, "1", rates, semitones, deterministic)
    assert not none and len(calls) == 1
    # the kernel's step is the scalar clamp(tf, 0.5, 2) of each row's stream
    np.testing.assert_array_equal(calls[0][6].numpy(), np.tile([2.0, 1 / np.float32(1.3), 0.5], 4)
                                  .astype(np.float32))
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    if deterministic:
        # the caller's word only spares the wait and the unused MINSTD draws
        read, _ = _hoisted(monkeypatch, "0", rates, semitones, None)
        for k in off:
            assert torch.equal(read[k], off[k]), k


def test_fused_route_not_taken_outside_the_deterministic_regime(monkeypatch):
    rates = (0.5, 0.25, 2.0)                    # one stream at time factor 4
    off, _ = _hoisted(monkeypatch, "off", rates, (0.0, 7.0, -7.0))
    on, calls = _hoisted(monkeypatch, "1", rates, (0.0, 7.0, -7.0))
    assert not calls
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_down_positions_are_the_kernels_step_bit_for_bit():
    """In the deterministic regime ``input_bin - d_down`` and ``input_bin -
    d_down * L`` of the unfused route are ``input_bin - c`` and ``input_bin
    - L c`` with ``c = clamp(tf, 0.5, 2)``, the differences the kernel
    forms from ``step``: equal bits, at awkward float32 rates."""
    rng = np.random.default_rng(9)
    tf = _t(np.asarray([2.0, 1 / np.float32(0.7), 0.3, 1.9999999, 0.5000001], np.float32))
    b_n, long_step = 257, 5
    seq = torch.ones((1, 5, 2 * b_n - 2), dtype=torch.int64)
    d_down, d_up = tspec._minstd_steps(seq, tf[None])
    c = torch.clamp(tf, 0.5, 2.0)[None, :, None]
    assert torch.equal(d_down, c.expand_as(d_down)) and torch.equal(d_up, c.expand_as(d_up))
    ib = _t(rng.uniform(0, b_n, (1, 5, b_n)).astype(np.float32))
    assert torch.equal(ib - d_down, ib - c)
    assert torch.equal(ib - d_down * long_step, ib - float(long_step) * c)


def test_pool_knows_its_regime_on_the_host():
    """``_deterministic`` repeats the device's float32 time-factor law on
    the host: equal to ``all(tf <= 2)`` of the tensors the step computes,
    at the float32 neighbours of rate 0.5."""
    half = np.float32(0.5)
    for rates in ([0.5, 1.0, 2.0], [np.nextafter(half, np.float32(0)), 1.0],
                  [np.nextafter(half, np.float32(1)), 0.75], [1e-5, 1.0], [0.0, 1.0]):
        r = np.asarray(rates, np.float32)
        tf = torch.clamp_max(1.0 / torch.clamp_min(_t(r), 1e-6), 1323.0)
        assert tpool._deterministic(r, 1323) == bool((tf <= 2.0).all()), rates
    assert tpool._deterministic(np.asarray([0.5, 2.0], np.float32), 1323)
    assert not tpool._deterministic(np.asarray([0.4999, 2.0], np.float32), 1323)
