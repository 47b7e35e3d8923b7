"""PyTorch port, the slice: ``batched_fidelity_chunk`` against the JAX
package's, with state carried across chunks (JAX on the CPU, eager).

Three streams at rates {0.5, 1.3, 0.25} and semitones {-12, 0, +7}, the
third inactive; 3 chunks of H = 4 hops on tonal material, in the split-on,
split-off and overlap-1 (long_step 1) geometries.  Bound: per-stream SNR
>= 60 dB on the emitted audio.  The analyses agree bit for bit (see
test_torch_ops.py); what remains is XLA's FMA-contracted complex products
and the peaks map's prefix-sum order, which the renderer amplifies over
the hops (docs/WASM-ALGO.md "Sensitivity") — hence an SNR, not an ulp
bound.  The carried state is held to a relative bound for the same
reason; the inactive stream's state must stay exactly frozen.

The overlap-1 geometry and the resume from a JAX mid-stream state are in
test_torch_fidelity_resume.py, formant voices in
test_torch_fidelity_formants.py and the coupled (live) drive in
test_torch_live.py, to keep each file's run short.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bauklank_tpu.engine import fidelity as jfid
from bauklank_tpu.engine import spectral as jspec
from bauklank_tpu_torch.engine import fidelity as tfid

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
SR = 44100.0
RATES = (0.5, 1.3, 0.25)
SEMITONES = (-12.0, 0.0, 7.0)
ACTIVE = (1.0, 1.0, 0.0)
H = 4
CHUNKS = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _snr(ref, got):
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - got) ** 2), 1e-30)))


def _controls(interval, split):
    cfg = jspec.SpectralConfig(2, 1024, interval, split=split)
    x = material.case_input(2.0, 2, seconds=1.0)
    audios = np.stack([np.roll(x, 977 * i, axis=-1) for i in range(len(RATES))])
    ends = np.stack([jfid.hop_frame_ends(cfg, H * (CHUNKS + 2), r, SR, split=split)
                     for r in RATES])
    tf = np.asarray([min(1 / r, interval) for r in RATES], np.float32)
    mult = np.exp2(np.asarray(SEMITONES) / 12).astype(np.float32)
    limit = ((8000 / SR) / np.sqrt(mult)).astype(np.float32)
    return cfg, audios, ends, (tf, mult, limit, np.asarray(ACTIVE, np.float32))


def _run(cfg_j, state_j, state_t, audios, ends, ctl, chunks):
    cfg_t = tfid.SpectralConfig(cfg_j.channels, cfg_j.block, cfg_j.interval, split=cfg_j.split)
    out_j, out_t = [], []
    for c in range(chunks):
        e = ends[:, c * H:(c + 1) * H]
        state_j, ej = jfid.batched_fidelity_chunk(
            cfg_j, state_j, jnp.asarray(audios), jnp.asarray(e), *map(jnp.asarray, ctl))
        state_t, et = tfid.batched_fidelity_chunk(
            cfg_t, state_t, _t(audios), _t(e), *map(_t, ctl))
        out_j.append(np.asarray(ej))
        out_t.append(et.numpy())
    return state_j, state_t, np.concatenate(out_j, -1), np.concatenate(out_t, -1)


def _check(state_j, state_t, emit_j, emit_t, state0):
    assert emit_t.shape == emit_j.shape
    for i, a in enumerate(ACTIVE):
        if a:
            assert _snr(emit_j[i], emit_t[i]) >= 60.0, (i, _snr(emit_j[i], emit_t[i]))
        else:
            assert not emit_t[i].any() and not emit_j[i].any()
    got = tfid.fidelity_state_to_numpy(state_t)
    want = jax.tree.map(np.asarray, state_j)
    np.testing.assert_array_equal(got[0].rng, want[0].rng)
    for g, w in zip([*got[0], got[1]], [*want[0], want[1]]):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = np.abs(g.astype(np.complex128) - w).max()
        assert err <= 1e-3 * max(np.abs(w).max(), 1e-30), err
    # the inactive stream's state is frozen bit for bit
    for g, w0 in zip([*got[0], got[1]], [*state0[0], state0[1]]):
        np.testing.assert_array_equal(g[2], w0[2])


@pytest.mark.parametrize("interval,split", [(256, True), (256, False)],
                         ids=["split_on", "split_off"])
def test_slice_matches_jax(interval, split):
    cfg_j, audios, ends, ctl = _controls(interval, split)
    state_j = jfid.init_batched_fidelity_state(cfg_j, len(RATES))
    state0 = jax.tree.map(np.asarray, state_j)
    state_t = tfid.fidelity_state_from_numpy(state0, "cpu")
    out = _run(cfg_j, state_j, state_t, audios, ends, ctl, CHUNKS)
    _check(*out, state0)


def test_timepred_division_matches_xla():
    """The hop body's ``p_out * tw / den`` divides by a complex64 whose
    imaginary part is 0; the port divides the parts by the real ``den``,
    which is XLA's rounding (PyTorch's complex division is not): equal
    values, inf and nan included; only the sign of a zero part may differ
    (XLA adds ``b * 0`` to the real part), which no later step can see.
    Wide dynamic range, signed zeros, overflow, and den at EPS."""
    rng = np.random.default_rng(0)
    shape = (3, 2, 513)
    num = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
           * np.exp2(rng.integers(-40, 40, shape))).astype(np.complex64)
    num.flat[:5] = [0, complex(-0.0, 0), 1e-38 + 1e-38j, 3e38, complex(0, -0.0)]
    den = (rng.uniform(0, 4, shape) * np.exp2(rng.integers(-50, 30, shape))
           + 1e-15).astype(np.float32)
    den.flat[5:8] = 1e-15
    want = np.asarray(jax.jit(lambda n, d: n / d.astype(jnp.complex64))(num, den))
    got = tfid._div_real(_t(num), _t(den)).numpy()
    np.testing.assert_array_equal(got, want)


def test_formants_refused():
    """Nothing of the formant path is refused any more: a config with
    ``formants`` set steps with and without the controls (without them the
    formant chain does not run, as in JAX), and no ``NotImplementedError``
    about formants is left in the port's sources."""
    cfg = tfid.SpectralConfig(2, 1024, 256, formants=True)
    state = tfid.init_batched_fidelity_state(cfg, 1, "cpu")
    one = torch.ones(1)
    audio = _t(material.case_input(1.0, 2, seconds=0.2)[None, :, :4096])
    args = (audio, torch.full((1, 2), 3000), one, one, one, one)
    _, plain = tfid.batched_fidelity_chunk(cfg, state, *args)
    _, shifted = tfid.batched_fidelity_chunk(cfg, state, *args, one * 1.5, one * 0, one * 0)
    assert torch.isfinite(shifted).all() and plain.abs().max() > 0
    assert not torch.equal(plain, shifted)
    pkg = pathlib.Path(tfid.__file__).parents[1]
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not ("NotImplementedError" in line and "ormant" in line), (path.name, line)
        assert "FORMANTS_TODO" not in path.read_text(), path.name
