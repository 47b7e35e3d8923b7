"""PyTorch port, engine/spectral: MINSTD, the smoother, the peaks map, the
band chain and the hop-local stage against the JAX package on the CPU
(Pallas kernels in interpret mode, JAX calls eager).

Bounds and why:
- MINSTD draws, the smoother and kernel 2 (the compensated cumsum) are
  bit-equal: integer math, or the same operations in the same order.
- The band chain is bit-equal against the Pallas kernel's arithmetic
  except where XLA contracts a multiply and an add into one FMA inside the
  interpreted loop, and differs from ``_band_chain_scan`` by its complex
  ``abs`` (hypot in the scan, re^2 + im^2 in the kernel): a relative bound.

The peaks map and the hop-local stage (``chain_inputs_hops``) are in
test_torch_chain_inputs.py.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu.ops.pallas.bandchain import band_chain as jax_band_chain
from bauklank_tpu.ops.pallas.compsum import LANE, comp_cumsum_seq
from bauklank_tpu_torch.engine import fidelity as tfid
from bauklank_tpu_torch.engine import spectral as tspec
from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
from bauklank_tpu_torch.kernels.smooth import smooth_pair

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
SR = 44100.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a.astype(np.complex128) - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_seq_compsum(x, axis):
    """JAX's _comp_cumsum as the TPU product path runs it: the sequential
    Pallas fold (interpret mode)."""
    n = x.shape[0]
    pad_n = (-n) % LANE
    xp = jnp.pad(x, ((0, pad_n), (0, 0), (0, 0)))
    hi, lo = comp_cumsum_seq(xp.transpose(2, 1, 0), True)
    return hi.transpose(2, 1, 0)[:n], lo.transpose(2, 1, 0)[:n]


@pytest.fixture
def jax_seq_compsum(monkeypatch):
    monkeypatch.setattr(jspec, "_comp_cumsum", _jax_seq_compsum)


# ------------------------------------------------------------------ MINSTD
def test_minstd_streams_exact():
    b_n = 512
    n = 2 * b_n - 2
    np.testing.assert_array_equal(tspec._minstd_powers(n), jspec._minstd_powers(n))
    np.testing.assert_array_equal(
        tspec._minstd_hop_powers(n, 8), jspec._minstd_hop_powers(n, 8))
    pows = _t(tspec._minstd_powers(n))
    for seed in (1, 48271, 123456789, 2147483646):
        want = np.asarray(jspec._modmul31(jnp.uint32(seed), jnp.asarray(jspec._minstd_powers(n))))
        seq = tspec._modmul31(torch.tensor(seed, dtype=torch.int64), pows)
        np.testing.assert_array_equal(seq.numpy(), want.astype(np.int64))
        for tf in (0.3, 1.0, 2.0, 2.0000002, 4.0, 1000.0, 1323.0):
            jd, ju, _ = jspec._minstd_steps(jnp.uint32(seed), jnp.float32(tf), b_n)
            td, tu = tspec._minstd_steps(seq, torch.tensor(tf, dtype=torch.float32))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


# --------------------------------------------------------------- smoother
def test_smooth_bidirectional_bit_equal():
    rng = np.random.default_rng(0)
    for b_n in (512, 777):   # even and odd lengths take both recursion branches
        e = np.abs(rng.standard_normal((6, b_n)) * np.exp2(rng.integers(-20, 20, (6, 1)))
                   ).astype(np.float32)
        carry = rng.uniform(0, 3, 6).astype(np.float32)
        coef = 1.0 / (0.5 * (1024 / 256) + 1.0)
        js, jc = jspec._smooth_bidirectional(jnp.asarray(e), coef, jnp.asarray(carry))
        ts, tc = tspec._smooth_bidirectional(_t(e), coef, _t(carry))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---------------------------------------------- kernel 8: the smoother pair
@pytest.mark.parametrize("b_n", [1, 2, 3, 7, 777, 3072])
@pytest.mark.parametrize("form", ["scalar", "rows"])
def test_smooth_pair_bit_equal(b_n, form):
    """smooth_pair on CPU tensors against JAX's two chained smoothers (the
    second from the first one's carry), in both coefficient forms; rows
    with exact zeros and large values (no denormals: XLA's CPU flushes
    them, PyTorch's does not)."""
    rng = np.random.default_rng(b_n)
    e = np.abs(rng.standard_normal((4, b_n)) * np.exp2(rng.integers(-20, 20, (4, 1)))
               ).astype(np.float32)
    e[0, ::3] = 0.0
    e[2] *= np.float32(1e30)
    e[3, b_n // 4:b_n // 4 + 40] = 0.0
    if form == "scalar":
        coef_j = coef_t = 1.0 / (0.5 * (6144 / 1536) + 1.0)
    else:
        coef = rng.uniform(0.01, 0.9, 4).astype(np.float32)
        coef_j, coef_t = jnp.asarray(coef), _t(coef)
    js, jc = jspec._smooth_bidirectional(jnp.asarray(e), coef_j, jnp.zeros(4))
    js, _ = jspec._smooth_bidirectional(js, coef_j, jc)
    got = smooth_pair(_t(e), coef_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", ["dtype", "dims", "coef-shape", "coef-int", "devices"])
def test_smooth_pair_refuses_bad_operands(case):
    e = torch.zeros(3, 16)
    args = {"dtype": (e.double(), 0.5), "dims": (e[None], 0.5),
            "coef-shape": (e, torch.full((4,), 0.5)),
            "coef-int": (e, torch.ones(3, dtype=torch.int32)),
            "devices": (e, torch.full((3,), 0.5, device="meta"))}[case]
    with pytest.raises(ValueError, match="smooth_pair"):
        smooth_pair(*args)


# ------------------------------------------------------ kernel 2: compsum
@pytest.fixture(scope="module")
def adversarial():
    rng = np.random.default_rng(7)
    # huge dynamic range, an exact-zero gap and a 0/1 integer channel: the
    # three channel regimes the peaks map feeds (w, w*b, run_start)
    x = rng.standard_normal((3, 700, 128)).astype(np.float32)
    x[0] *= np.exp2(rng.integers(-60, 60, (700, 128))).astype(np.float32)
    x[1, 100:200] = 0.0
    x[2] = rng.integers(0, 2, (700, 128)).astype(np.float32)
    return x


def test_comp_cumsum_ref_matches_pallas(adversarial):
    jhi, jlo = comp_cumsum_seq(jnp.asarray(adversarial), True)
    hi, lo = comp_cumsum_ref(_t(adversarial))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    whi, wlo = comp_cumsum(_t(adversarial))   # CPU tensor: the plain version
    np.testing.assert_array_equal(whi.numpy(), hi.numpy())
    np.testing.assert_array_equal(wlo.numpy(), lo.numpy())


@pytest.mark.parametrize("b_n", [1, 65, 700])
def test_comp_cumsum_ref_matches_pallas_ragged(b_n):
    """Bit-equal to the Pallas fold at a row count that is no multiple of
    32 (37 rows a channel; the Pallas kernel wants its 128 lanes, so its
    input is padded with rows of zeros) and at B one band, one over a
    64-band stage and a ragged multiple of it."""
    rng = np.random.default_rng(b_n)
    x = (rng.standard_normal((3, b_n, 37))
         * np.exp2(rng.integers(-30, 30, (3, b_n, 37)))).astype(np.float32)
    x[1, b_n // 3: b_n // 2] = 0.0
    x[2] = rng.integers(0, 2, (b_n, 37)).astype(np.float32)
    jhi, jlo = comp_cumsum_seq(jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, LANE - 37)))), True)
    hi, lo = comp_cumsum(_t(x))                  # CPU tensor: the plain version
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi)[..., :37])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo)[..., :37])


def test_comp_cumsum_invariants(adversarial):
    hi, lo = (v.numpy() for v in comp_cumsum_ref(_t(adversarial)))
    # folding exact zeros returns the bitwise-identical pair
    np.testing.assert_array_equal(hi[1, 99], hi[1, 199])
    np.testing.assert_array_equal(lo[1, 99], lo[1, 199])
    # the 0/1 channel stays the exact integer cumsum, lo identically zero
    np.testing.assert_array_equal(hi[2], np.cumsum(adversarial[2], axis=0))
    np.testing.assert_array_equal(lo[2], 0.0)


# ------------------------------------------------- shared test material
@functools.lru_cache(maxsize=4)
def _tonal_analyses(block, interval, s_n, h):
    """[H, S, C, B] analyses of the golden tonal material, per-stream offset."""
    cfg = tspec.SpectralConfig(2, block, interval)
    x = material.case_input(1.0, 2, seconds=1.0)
    audios = np.stack([np.roll(x, 1531 * i, axis=-1) for i in range(s_n)])
    ends = np.stack([np.arange(h) * interval * (i + 1) + 4000 for i in range(s_n)]).astype(np.int32)
    cur, prev = tfid._analyse_cur_prev(cfg, _t(audios), _t(ends))
    return cur.numpy(), prev.numpy()


# ------------------------------------------------- leader channel choice
def test_hop_post_gather_leader_ties():
    """``mc = argmax(pred_energy)`` over channels takes the FIRST maximum in
    both packages: bands with equal channel energies, and bands where a
    negative gradient zeroes every channel.  The other operands within a
    relative 2e-6 (XLA's FMA-contracted complex products)."""
    rng = np.random.default_rng(11)
    cfg_j, cfg_t = jspec.SpectralConfig(3, 128, 32), tspec.SpectralConfig(3, 128, 32)
    s_n, c_n, b_n = 2, 3, cfg_t.bands

    def cx(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    five, prev_interp = cx((1, s_n, c_n, 5 * b_n)), cx((1, s_n, c_n, b_n))
    pe_raw = rng.uniform(0.5, 2.0, (1, s_n, c_n, b_n)).astype(np.float32)
    pe_raw[..., 1:, ::3] = pe_raw[..., :1, ::3]       # all three channels tie
    pe_raw[..., 2, 1::3] = pe_raw[..., 1, 1::3]       # the last two tie
    grad = rng.uniform(0.2, 2.0, (1, s_n, b_n)).astype(np.float32)
    grad[..., 5::7] = -1.0                            # every channel zeroed
    got = tspec._hop_post_gather(cfg_t, _t(five), _t(pe_raw), _t(prev_interp), _t(grad))
    for s in range(s_n):
        want = jspec._hop_post_gather(cfg_j, jnp.asarray(five[0, s]), jnp.asarray(pe_raw[0, s]),
                                      jnp.asarray(prev_interp[0, s]), jnp.asarray(grad[0, s]))
        np.testing.assert_array_equal(got["mc"][0, s].numpy(), np.asarray(want["mc"]))
        for k in want:
            assert _rel(got[k][0, s], want[k]) < 2e-6, k
    assert (got["mc"][0, :, ::3] == 0).all() and (got["mc"][0, :, 5::7] == 0).all()


# ------------------------------------------------------ kernel 4: chain
def _random_chain(rng, s_n, c_n, b_n):
    def cx(shape, scale=1.0):
        return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
                ).astype(np.complex64)

    d1, d2, u12, pi_mc = cx((s_n, b_n)), cx((s_n, b_n)), cx((s_n, b_n), 3.0), cx((s_n, b_n))
    pe_mc = rng.uniform(0.1, 4.0, (s_n, b_n)).astype(np.float32)
    mc = rng.integers(0, c_n, (s_n, b_n)).astype(np.int32)
    lock, pred_input = cx((s_n, c_n, b_n)), cx((s_n, c_n, b_n))
    pred_energy = rng.uniform(0.1, 4.0, (s_n, c_n, b_n)).astype(np.float32)
    # EPS fallbacks: a vanishing phase sum, and a vanishing lock
    u12[:, 7] = 0
    d1[:, 7] = 0
    d2[:, 7] = 0
    lock[:, :, 11] = 0
    return (d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input)


@pytest.mark.parametrize("block,interval", [(1024, 256), (1024, 1024)])
def test_band_chain_vs_pallas_and_scan(block, interval):
    rng = np.random.default_rng(block + interval)
    cfg_j = jspec.SpectralConfig(2, block, interval)
    cfg_t = tspec.SpectralConfig(2, block, interval)
    assert cfg_t.long_step == (4 if interval == 256 else 1)
    chain = _random_chain(rng, 5, 2, cfg_t.bands)
    chain_j = tuple(jnp.asarray(c) for c in chain)
    chain_t = tuple(_t(c.astype(np.int64) if c.dtype == np.int32 else c) for c in chain)
    got = _np(tspec.band_chain_packed(cfg_t, chain_t))             # [S, C, B]
    kern = np.asarray(jspec._band_chain_kernel(cfg_j, chain_j))
    scan = np.asarray(jax.vmap(functools.partial(jspec._band_chain_scan, cfg_j))(chain_j))
    # the kernel's real-valued arithmetic, up to XLA's FMA contraction of
    # the interpreted loop body; the scan's complex abs rounds otherwise
    assert _rel(got, kern) < 1e-5
    assert _rel(got, scan) < 1e-5
    assert np.isfinite(got).all()


def _edge_chain_operands(rng, c_n, b_n, s_n):
    """Kernel-layout operands (lead [9, B, S], chan [C, 6, B, S]) with the
    leader channel switching at every band, the EPS fallback hit on the
    leader (a vanishing phase sum) and on the followers (a vanishing lock),
    and a band whose pe is 0.  |u| in [3, 5] and |d1|, |d2| in [0.2, 0.6]
    with |out| <= 2: the phase sum never nearly cancels, so a one-ulp
    difference is not amplified from band to band."""
    def polar(lo, hi):
        z = rng.uniform(lo, hi, (b_n, s_n)) * np.exp(2j * np.pi * rng.uniform(0, 1, (b_n, s_n)))
        return z.real, z.imag

    lead = rng.standard_normal((9, b_n, s_n)).astype(np.float32)
    lead[0], lead[1] = polar(0.2, 0.6)
    lead[2], lead[3] = polar(0.2, 0.6)
    lead[4], lead[5] = polar(3.0, 5.0)
    lead[8] = rng.uniform(0.1, 4.0, (b_n, s_n)).astype(np.float32)
    chan = rng.standard_normal((c_n, 6, b_n, s_n)).astype(np.float32)
    mc = (np.arange(b_n)[:, None] + np.arange(s_n)[None, :]) % c_n
    chan[:, 0] = mc[None] == np.arange(c_n)[:, None, None]
    chan[:, 3] = rng.uniform(0.1, 4.0, (c_n, b_n, s_n)).astype(np.float32)
    lead[:6, min(7, b_n - 1)] = 0.0           # d1 = d2 = u = 0: ph falls back to pi
    chan[:, 1:3, min(11, b_n // 2)] = 0.0     # lock = 0: the followers fall back to pic
    lead[8, (2 * b_n) // 3] = 0.0             # pe == 0: the leader's output is 0
    return lead, chan


@pytest.mark.parametrize("b_n", [1, 3, 300], ids=lambda v: f"b{v}")
@pytest.mark.parametrize("s_n", [1, 33], ids=lambda v: f"s{v}")
@pytest.mark.parametrize("long_step", [1, 2, 5, 16, 24, 40], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("c_n", [1, 2, 3], ids=lambda v: f"c{v}")
def test_band_chain_ref_vs_pallas_edges(c_n, long_step, s_n, b_n):
    """The plain version against the Pallas kernel in interpret mode (S
    padded with zero streams to its 128 lanes, as engine.spectral pads it)
    over the shapes the CUDA kernel's edges depend on: every channel form,
    long_step 1 (no ring), 2, 5 and 16, 24 (the card kernel's shared
    history) and 40 (its general form, which reads band b - L back from
    its output), one stream and 33, B of 1, under long_step and 300 (past
    2 long_step).  Relative 1e-5: XLA contracts the interpreted body's
    multiply-adds into FMAs."""
    rng = np.random.default_rng(((c_n * 17 + long_step) * 37 + s_n) * 311 + b_n)
    lead, chan = _edge_chain_operands(rng, c_n, b_n, s_n)
    pad = (-s_n) % LANE
    want = np.asarray(jax_band_chain(jnp.asarray(np.pad(lead, ((0, 0), (0, 0), (0, pad)))),
                                     jnp.asarray(np.pad(chan, ((0, 0),) * 3 + ((0, pad),))),
                                     long_step, True))[..., :s_n]
    got = band_chain(_t(lead), _t(chan), long_step)     # CPU tensors: the plain version
    assert torch.equal(got, band_chain_ref(_t(lead), _t(chan), long_step))
    assert got.shape == (c_n, 2, b_n, s_n) and np.isfinite(got.numpy()).all()
    assert _rel(got, want) < 1e-5
    if b_n == 300:
        # the edge cases were hit: an exact zero from pe == 0 on the leader
        # channel of that band, and the leader really switches
        zero_band = got.numpy()[:, :, (2 * b_n) // 3]
        assert (np.abs(zero_band).min(axis=(0, 1)) == 0.0).all()
