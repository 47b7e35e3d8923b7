"""PyTorch port, the per-hop forms: ``_hop_local_inputs``,
``spectral_hop``, ``_band_chain_scan``, ``spectral_hop_batched``,
``batched_fidelity_chunk_scan``, ``_render_jit`` and ``render_fidelity``'s
``state``, against the port's serving forms and the JAX package (JAX on
the CPU, eager; its compensated sum as the sequential fold the port runs).

Bounds and why:
- ``_hop_local_inputs`` against ``_hop_inputs_hoisted``: maxdiff == 0 on
  every operand, the micro-check the JAX suite pins between its own pair
  (tests/test_spectral.py).
- ``_band_chain_scan`` against ``band_chain_packed`` on the CPU, whose
  wrapper takes the plain version there: bit-equal (both run kernel 4's
  plain version on the same packed operands).
- ``spectral_hop`` against JAX's: relative 1e-5 on the output, the bar the
  port's band chain is held to against JAX's scan (its complex ``abs``
  rounds otherwise), the MINSTD state equal.
- The scan form against the serving form, chunk by chunk from the same
  state: JAX's own bars (tests/test_spectral.py: emit atol 2e-4, rng
  equal, state leaves rtol = atol = 2e-4).
- ``_render_jit`` against JAX's: per-channel SNR >= 60 dB, the slice bar
  of test_torch_fidelity.py (the renderer amplifies ulps over the hops;
  a formant voice on auto f0 is a discrete switch, so formants are held
  hop by hop, in ``spectral_hop``, and against the port's serving route).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu_torch.engine import fidelity as tfid
from bauklank_tpu_torch.engine import spectral as tspec
from bauklank_tpu_torch.utils.tree import tree_map
from test_torch_spectral import (  # noqa: F401
    SR, _random_chain, _rel, _t, _tonal_analyses, jax_seq_compsum)

torch.set_num_threads(1)


def _snr(ref, got):
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-30)))


# ------------------------------------------------------- hop-local inputs
@pytest.mark.parametrize("formants", [False, True])
@pytest.mark.parametrize("regime", ["det", "mixed"])
def test_hop_local_inputs_bit_equal_to_hoisted(formants, regime):
    cfg = tspec.SpectralConfig(2, 512, 128, formants=formants)
    h, s_n, c_n, b_n = 4, 3, cfg.channels, cfg.bands
    rng = np.random.default_rng(5)

    def cplx(*shape):
        env = 0.02 + np.exp(-((np.arange(b_n) - b_n / 4.0) ** 2) / (2 * (b_n / 16.0) ** 2))
        z = (rng.standard_normal(shape + (b_n,)) + 1j * rng.standard_normal(shape + (b_n,))) * env
        return _t(z.astype(np.complex64))

    cur, prev = cplx(h, s_n, c_n), cplx(h, s_n, c_n)
    seeds = _t(rng.integers(1, 2 ** 31 - 1, (h, s_n)).astype(np.int64))
    tf = _t(np.asarray([0.8, 2.0, 1000.0 if regime == "mixed" else 1.0], np.float32))
    mult = _t(np.asarray([1.0, 1.3, 0.7], np.float32))      # the first: map gated off
    limit = _t(np.asarray([0.18, 0.12, 0.2], np.float32))
    fgain = (_t(np.exp(rng.standard_normal((h, s_n, b_n)) * 0.1).astype(np.float32))
             if formants else None)
    hoisted = tspec._hop_inputs_hoisted(cfg, cur, prev, seeds, tf, mult, limit, fgain,
                                        deterministic=regime == "det")
    for i in range(h):
        local = tspec._hop_local_inputs(cfg, cur[i], prev[i], seeds[i], tf, mult, limit,
                                        None if fgain is None else fgain[i])
        assert set(local) == set(hoisted) - {"den"}
        for k, v in local.items():
            np.testing.assert_array_equal(
                v.resolve_conj().numpy(), hoisted[k][i].resolve_conj().numpy(),
                err_msg=f"operand {k} of hop {i} diverged (must be maxdiff == 0)")


# ------------------------------------------------------------ band chain
@pytest.mark.parametrize("block,interval,c_n", [(512, 128, 2), (1024, 1024, 2), (512, 128, 1)],
                         ids=["long_step_4", "long_step_1", "one_channel"])
def test_band_chain_scan_bit_equal_to_the_plain_chain(block, interval, c_n):
    cfg = tspec.SpectralConfig(c_n, block, interval)
    chain = _random_chain(np.random.default_rng(block + interval + c_n), 3, c_n, cfg.bands)
    chain = tuple(_t(c.astype(np.int64) if c.dtype == np.int32 else c) for c in chain)
    got = tspec._band_chain_scan(cfg, chain)
    want = tspec.band_chain_packed(cfg, chain)        # the CPU wrapper: the plain version
    assert got.shape == want.shape == (3, c_n, cfg.bands)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert np.isfinite(got.numpy()).all()


# ----------------------------------------------------------- spectral_hop
def _random_state(cfg_j, rng, seed):
    b_n = cfg_j.bands
    po = (rng.standard_normal((2, b_n)) + 1j * rng.standard_normal((2, b_n))) * 0.3
    return jspec.SpectralState(
        prev_output=np.asarray(po, np.complex64),
        prev_pred_energy=rng.uniform(0, 2, (2, b_n)).astype(np.float32),
        rng=np.uint32(seed),
        f_value_ema=np.float32(3.5),
        f_weighted_ema=np.float32(90.0))


@pytest.mark.parametrize("rate,formants", [(0.8, False), (0.25, False), (1.3, True)],
                         ids=["tf<=2", "tf>2", "formants"])
def test_spectral_hop_matches_jax(rate, formants, jax_seq_compsum):
    block, interval = 512, 128
    cfg_j = jspec.SpectralConfig(2, block, interval, formants=formants)
    cfg_t = tspec.SpectralConfig(2, block, interval, formants=formants)
    cur, prev = _tonal_analyses(block, interval, 1, 2)
    rng = np.random.default_rng(7)
    st_np = _random_state(cfg_j, rng, 987654321)
    mult = np.float32(np.exp2(4.0 / 12))
    ctl = (np.float32(1 / rate), mult, np.float32((8000 / SR) / np.sqrt(mult)))
    fmt = (np.float32(np.exp2(-5.0 / 12)), np.float32(1.0), np.float32(0.0)) if formants else ()
    st_j, out_j = jspec.spectral_hop(
        cfg_j, jax.tree.map(jnp.asarray, st_np), jnp.asarray(cur[1, 0]), jnp.asarray(prev[1, 0]),
        *map(jnp.asarray, ctl + fmt))
    st_t0 = tfid.fidelity_state_from_numpy((st_np,), "cpu")[0]
    st_t, out_t = tspec.spectral_hop(cfg_t, st_t0, _t(cur[1, 0]), _t(prev[1, 0]), *ctl, *fmt)
    assert out_t.shape == (2, cfg_t.bands) and out_t.dtype == torch.complex64
    assert _rel(out_t, out_j) < 1e-5
    assert torch.equal(st_t.prev_output, out_t)
    assert int(st_t.rng) == int(st_j.rng)
    assert (int(st_t.rng) != 987654321) == (rate < 0.5)       # MINSTD drew only at tf > 2
    assert _rel(st_t.prev_pred_energy, st_j.prev_pred_energy) < 2e-6
    for g, w in ((st_t.f_value_ema, st_j.f_value_ema), (st_t.f_weighted_ema, st_j.f_weighted_ema)):
        assert _rel(g, w) < 1e-6
    assert (float(st_t.f_value_ema) != 3.5) == formants        # the tracker stepped


def test_spectral_hop_batched_takes_the_plain_chain_on_the_cpu():
    cfg = tspec.SpectralConfig(2, 512, 128)
    cur, prev = _tonal_analyses(512, 128, 3, 1)
    state = tree_map(lambda x: x[None].repeat((3,) + (1,) * x.dim()),
                     tspec.init_spectral_state(cfg, "cpu"))
    ctl = (_t(np.asarray([0.8, 4.0, 1.0], np.float32)), _t(np.asarray([1.0, 1.3, 0.7], np.float32)),
           _t(np.full(3, 0.18, np.float32)))
    st_a, out_a = tspec.spectral_hop_batched(cfg, state, _t(cur[0]), _t(prev[0]), *ctl)
    st_b, out_b = tspec.spectral_hop_batched(cfg, state, _t(cur[0]), _t(prev[0]), *ctl,
                                             use_kernel=True)
    np.testing.assert_array_equal(out_a.numpy(), out_b.numpy())
    for a, b in zip(st_a, st_b):
        assert torch.equal(a, b)


# ------------------------------------------------------------ scan form
@pytest.mark.parametrize("formants", [None, "auto", "base", "mixed"])
def test_scan_form_matches_serving_form(formants):
    """tests/test_spectral.py's check of the JAX pair, on the port's:
    chunk by chunk from the same carried state (the scan form advances
    it), one stream in the MINSTD regime."""
    cfg = tspec.SpectralConfig(2, 512, 128, formants=bool(formants))
    s_n, h = 3, 4
    t = np.arange(4096) / SR
    sig = np.stack([
        np.stack([(0.3 + 0.05 * c) * np.sin(2 * np.pi * (220 + 5 * k) * t)
                  + 0.2 * np.sin(2 * np.pi * (440 + 3 * c) * t) for c in range(2)])
        for k in range(s_n)]).astype(np.float32)
    rates = np.array([0.8, 1.5, 0.25], np.float32)
    semis = np.array([0.0, 4.0, -7.0], np.float32)
    ends = (600 + (np.arange(h)[None] * 128 * rates[:, None]).round()).astype(np.int32)
    mult = np.exp2(semis / 12.0).astype(np.float32)
    ctl = [_t(x) for x in (1.0 / rates, mult,
                           ((8000.0 / SR) / np.sqrt(mult)).astype(np.float32),
                           np.ones(s_n, np.float32))]
    if formants:
        base = {"auto": [0.0, 0.0, 0.0], "base": [200.0, 150.0, 300.0],
                "mixed": [0.0, 200.0, 0.0]}[formants]
        ctl += [_t(np.exp2(np.array([3.0, -5.0, 0.0]) / 12.0).astype(np.float32)),
                _t(np.array([0.0, 1.0, 1.0], np.float32)),
                _t((np.array(base) / SR).astype(np.float32))]
    st = tfid.init_batched_fidelity_state(cfg, s_n, "cpu")
    for k in range(3):
        e = _t(ends + 64 * k)
        sa, ea = tfid.batched_fidelity_chunk(cfg, st, _t(sig), e, *ctl)
        sb, eb = tfid.batched_fidelity_chunk_scan(cfg, st, _t(sig), e, *ctl)
        np.testing.assert_allclose(ea.numpy(), eb.numpy(), rtol=0, atol=2e-4)
        np.testing.assert_array_equal(sa[0].rng.numpy(), sb[0].rng.numpy())
        for la, lb in zip([*sa[0], sa[1]], [*sb[0], sb[1]]):
            np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=2e-4, atol=2e-4)
        st = sb
    assert int(st[0].rng[2]) != 1                             # the MINSTD stream drew
    if formants in ("auto", "mixed"):
        assert float(st[0].f_value_ema[0]) != 0.0             # a tracker stepped


# ------------------------------------------------------------- the render
def _render_inputs(split, formants=False):
    block, interval = 1024, 256
    cfg_j = jspec.SpectralConfig(2, block, interval, formants=formants, split=split)
    cfg_t = tspec.SpectralConfig(2, block, interval, formants=formants, split=split)
    from golden_wasm import material

    audio = material.case_input(1.0, 2, seconds=0.5)
    rate, semis = 0.8, -5.0
    h = 12
    ends = jfid.hop_frame_ends(cfg_j, h, rate, SR, split=split)
    mult = np.float32(np.exp2(semis / 12))
    ctl = (np.float32(1 / rate), mult, np.float32((8000 / SR) / np.sqrt(mult)))
    return cfg_j, cfg_t, audio, ends, ctl, h * interval


@pytest.mark.parametrize("split", [True, False], ids=["split_on", "split_off"])
def test_render_jit_matches_jax(split, jax_seq_compsum):
    cfg_j, cfg_t, audio, ends, ctl, n_out = _render_inputs(split)
    st_j, want = jfid._render_jit(
        cfg_j, jnp.asarray(audio), jnp.asarray(ends), n_out, *map(jnp.float32, ctl),
        jspec.init_spectral_state(cfg_j, seed=3), None, split)
    st_t, got = tfid._render_jit(
        cfg_t, _t(audio), _t(ends), n_out, *ctl, tspec.init_spectral_state(cfg_t, "cpu", 3),
        None, split)
    assert got.shape == (2, n_out)
    for c in range(2):
        assert _snr(np.asarray(want[c]), got[c].numpy()) >= 60.0
    assert int(st_t.rng) == int(st_j.rng)


@pytest.mark.parametrize("split", [True, False], ids=["split_on", "split_off"])
def test_render_jit_matches_the_serving_route(split):
    """The hop scan and the serving route render the same stream, a formant
    voice on auto f0: equal but for the overlap-add's order (the serving
    route sums chunk by chunk through its carried tail)."""
    _, cfg_t, audio, ends, ctl, n_out = _render_inputs(split, formants=True)
    _, got = tfid._render_jit(
        cfg_t, _t(audio), _t(ends), n_out, *ctl, tspec.init_spectral_state(cfg_t, "cpu", 3),
        (float(np.exp2(3.0 / 12)), 0.0, 0.0), split)
    serving = tfid.render_fidelity(
        audio, SR, n_out, rate=0.8, semitones=-5.0, block_ms=1024 / 44.1, interval_ms=256 / 44.1,
        seed=3, split_computation=split, formant_semitones=3.0, device="cpu")
    np.testing.assert_allclose(got.numpy(), serving, rtol=0, atol=1e-6)


def test_render_fidelity_state_carries_across_two_halves():
    """The first half through ``render_fidelity``, its state through the
    public one-stream step, the second half through ``render_fidelity``
    (state=) on the audio from where the first left off: the two halves
    equal one call.  Rate 1 and a 256-sample interval put every hop's
    frame end at h * interval + const, so the second call's frame ends
    are the first's shifted by the first half's hops."""
    block, interval, h1, hpc = 1024, 256, 8, 8
    kw = dict(block_ms=block / 44.1, interval_ms=interval / 44.1, semitones=3.0, seed=5,
              device="cpu")
    from golden_wasm import material

    audio = material.case_input(1.0, 2, seconds=0.5)
    n1 = h1 * interval
    whole = tfid.render_fidelity(audio, SR, 2 * n1, **kw)
    first = tfid.render_fidelity(audio, SR, n1, **kw)
    cfg = tspec.SpectralConfig(2, block, interval)
    ends = tfid.hop_frame_ends(cfg, 2 * h1, 1.0, SR)
    np.testing.assert_array_equal(ends, np.arange(2 * h1) * interval + ends[0])
    mult = float(np.exp2(3.0 / 12))
    state = tfid.init_fidelity_state(cfg, "cpu", 5)
    for c in range(h1 // hpc):
        state, _ = tfid.fidelity_chunk(cfg, state, _t(audio), _t(ends[c * hpc:(c + 1) * hpc]),
                                       1.0, mult, (8000 / SR) / np.sqrt(mult), 1.0,
                                       deterministic=True)
    second = tfid.render_fidelity(audio[:, n1:], SR, n1, state=state, **kw)
    np.testing.assert_array_equal(first, whole[:, :n1])
    np.testing.assert_array_equal(second, whole[:, n1:])
    # a spectral state alone (JAX's form) starts the overlap-add empty
    alone = tfid.render_fidelity(audio[:, n1:], SR, n1, state=state[0], **kw)
    np.testing.assert_array_equal(alone[:, block + interval:], second[:, block + interval:])
    assert not np.array_equal(alone[:, :block], second[:, :block])


def test_render_fidelity_state_matches_jax(jax_seq_compsum):
    """``render_fidelity(state=SpectralState)`` in both packages, from one
    mid-stream state (the port's serving route, JAX's hop scan)."""
    cfg_j, _, audio, _, _, n_out = _render_inputs(True)
    st_np = _random_state(cfg_j, np.random.default_rng(9), 12345)
    kw = dict(rate=0.8, semitones=-5.0, block_ms=1024 / 44.1, interval_ms=256 / 44.1)
    want = jfid.render_fidelity(audio, SR, n_out, state=jax.tree.map(jnp.asarray, st_np), **kw)
    got = tfid.render_fidelity(audio, SR, n_out,
                               state=tfid.fidelity_state_from_numpy((st_np,), "cpu")[0],
                               device="cpu", **kw)
    fresh = tfid.render_fidelity(audio, SR, n_out, device="cpu", **kw)
    for c in range(2):
        assert _snr(np.asarray(want[c]), got[c]) >= 60.0
        assert _snr(got[c], fresh[c]) < 40.0                   # the state was used
