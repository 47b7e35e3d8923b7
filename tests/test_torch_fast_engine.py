"""PyTorch port, the fast engine against the JAX package on the CPU:
``hop_factors``, ``rotation_scan``, ``batched_process_chunk`` over three
streams from a carried state, and ``stretch_offline`` (identity, the
scalar reference renderer, the JAX driver).  Inputs come from
``numpy.random.default_rng`` and the golden material's tonal tracks.

Bounds: the scan bit-equal (the same combine tree, the complex product
rounded as XLA's CPU backend rounds it); the stages and renders as SNRs.
The JAX gather is a matrix product whose second product may be fused
with the sum, and XLA's CPU ``exp``, ``log`` and ``atan2`` round
otherwise than PyTorch's, so the port differs from it by ulps, which
the engine does not amplify (no sequential band chain): >= 80 dB with
formants off; >= 60 dB with a formant voice, whose detected f0 and
envelope sit behind a log and an exp (the JAX package's own jitted and
eager forms differ there at about 68 dB); > 50 dB identity and > 45 dB
against ``refdsp.render_offline``, the JAX package's own bars.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bauklank_tpu.engine import batched as jbatched
from bauklank_tpu.engine import core as jcore
from bauklank_tpu.engine import offline as joffline
from bauklank_tpu.engine.config import StretchConfig as JConfig
from bauklank_tpu.engine.params import StretchParams as JParams
from bauklank_tpu.refdsp import render_offline
from bauklank_tpu_torch.engine import core
from bauklank_tpu_torch.engine.batched import batched_process_chunk, init_batched_state
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.offline import frame_ends_for, stretch_offline
from bauklank_tpu_torch.engine.params import StretchParams

sys.path.insert(0, "tools")
from golden_wasm import material  # noqa: E402

torch.set_num_threads(1)
SR = 44100.0
RATES = (0.6, 1.0, 1.6)
TONES = (7.0, 0.0, -7.0)
ACTIVE = (1.0, 1.0, 0.0)
H = 8


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.sum(np.abs(ref.astype(np.complex128) - got) ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def _tracks(channels=2, seconds=1.5):
    x = material.case_input(1.0, channels, seconds=seconds)
    return np.stack([np.roll(x, 977 * i, axis=-1) for i in range(len(RATES))]).astype(np.float32)


def _controls(formant_voice: bool):
    """Per-stream controls; with ``formant_voice`` stream 0 shifts its
    formants (+3 st, compensation on, base detected per hop)."""
    out = []
    for i, (r, st, a) in enumerate(zip(RATES, TONES, ACTIVE)):
        kw = dict(active=a, rate=r, semitones=st, sample_rate=SR)
        if formant_voice and i == 0:
            kw.update(formant_semitones=3.0, formant_compensation=1.0)
        out.append(kw)
    return out


def _params(formant_voice: bool):
    ctl = _controls(formant_voice)
    return (JParams.stack([JParams.make(**kw) for kw in ctl]),
            StretchParams.stack([StretchParams.make(device="cpu", **kw) for kw in ctl]))


def _ends(cfg, chunk: int) -> np.ndarray:
    return np.stack([frame_ends_for(cfg, chunk * H * cfg.interval, H, r)
                     for r in RATES]).astype(np.int32)


def _jax_state(cfg_j, audio, p_j):
    """A mid-stream JAX state: one chunk from a fresh one."""
    state = jbatched.init_batched_state(cfg_j, len(RATES))
    state, _ = jbatched.batched_process_chunk(
        cfg_j, state, jnp.asarray(audio), jnp.asarray(_ends(cfg_j, 0)), p_j)
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("reset_db", [None, 6.0])
def test_hop_factors_and_rotation_scan_match_jax(reset_db):
    cfg_j = JConfig(channels=2, block=1024, interval=256, formants=False,
                    transient_reset_db=reset_db)
    cfg = StretchConfig(channels=2, block=1024, interval=256, formants=False,
                        transient_reset_db=reset_db)
    audio = _tracks()
    p_j, p = _params(False)
    st_np = _jax_state(cfg_j, audio, p_j)
    ends = _ends(cfg, 1)

    want = [jcore.hop_factors(cfg_j, jnp.asarray(audio[s]), jnp.asarray(ends[s]),
                              jax.tree.map(lambda f: f[s], p_j), jnp.asarray(st_np.prev_cur[s]))
            for s in range(len(RATES))]
    v, cur_m, gain, reset = core.hop_factors(
        cfg, torch.from_numpy(audio), torch.from_numpy(ends), p,
        torch.from_numpy(st_np.prev_cur))
    assert v.shape == (3, H, cfg.bins) and cur_m.shape == (3, 2, H, cfg.bins)
    assert gain.shape == (3, 1, H, cfg.bins) and reset.shape == v.shape
    stack = lambda k: np.stack([np.asarray(w[k]) for w in want])
    assert snr_db(stack(1), cur_m.numpy()) >= 100.0
    assert snr_db(stack(0), v.numpy()) >= 80.0
    assert snr_db(stack(2), gain.numpy()) >= 80.0
    j_reset = stack(3)
    assert np.mean(j_reset == reset.numpy()) >= 0.999
    assert j_reset.any() == (reset_db is not None)

    # the prefix alone, on the JAX factors: the same combine tree, bit-equal
    rot = core.rotation_scan(torch.from_numpy(st_np.rot), torch.from_numpy(stack(0)),
                             torch.from_numpy(j_reset))
    for s in range(len(RATES)):
        j_rot = jcore.rotation_scan(jnp.asarray(st_np.rot[s]), want[s][0], want[s][3])
        np.testing.assert_array_equal(rot[s].numpy(), np.asarray(j_rot))


@pytest.mark.parametrize("formant_voice", [False, True])
def test_batched_chunks_match_jax(formant_voice):
    """Three streams (rates 0.6/1.0/1.6, +-7 st, the last inactive), three
    chunks from a mid-stream JAX state carried across."""
    cfg_j = JConfig(channels=2, block=1024, interval=256, formants=formant_voice)
    cfg = StretchConfig(channels=2, block=1024, interval=256, formants=formant_voice)
    audio = _tracks()
    p_j, p = _params(formant_voice)
    st_np = _jax_state(cfg_j, audio, p_j)
    state_j = jax.tree.map(jnp.asarray, st_np)
    state = core.stretch_state_from_numpy(st_np, "cpu")
    outs_j, outs = [], []
    for c in (1, 2, 3):
        ends = _ends(cfg, c)
        state_j, o_j = jbatched.batched_process_chunk(
            cfg_j, state_j, jnp.asarray(audio), jnp.asarray(ends), p_j)
        state, o = batched_process_chunk(
            cfg, state, torch.from_numpy(audio), torch.from_numpy(ends), p)
        outs_j.append(np.asarray(o_j))
        outs.append(o.numpy())
    want, got = np.concatenate(outs_j, -1), np.concatenate(outs, -1)
    assert got.shape == want.shape == (3, 2, 3 * H * 256)
    assert np.abs(want[:2]).max() > 1e-2 and not got[2].any()   # stream 2 inactive
    bound = 60.0 if formant_voice else 80.0
    assert snr_db(want, got) >= bound
    back = core.stretch_state_to_numpy(state)
    for leaf_j, leaf in zip(jax.tree.map(np.asarray, state_j), back):
        assert leaf.dtype == leaf_j.dtype and leaf.shape == leaf_j.shape
    assert snr_db(np.asarray(state_j.ola_tail), back.ola_tail) >= bound


def test_offline_identity_reconstruction():
    """tests/test_engine.py's bar: rate 1, no pitch, > 50 dB after warm-up."""
    cfg = StretchConfig(channels=1, block=1764, interval=441, formants=True)
    x = (np.random.default_rng(0).standard_normal(int(SR)) * 0.3).astype(np.float32)
    y = stretch_offline(x[None], 1.0, cfg, device="cpu")
    b = cfg.block
    n = min(x.shape[0], y.shape[1]) - b
    assert snr_db(x[b:n], y[0, b:n]) > 50.0


def _material(n=30000):
    """tests/test_refdsp.py's input: noise and two tones."""
    t = np.arange(n) / SR
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32) * 0.1
    x += (np.sin(2 * np.pi * 440.0 * t) * 0.3 + np.sin(2 * np.pi * 1234.5 * t) * 0.2).astype(
        np.float32)
    return x[None, :]


@pytest.mark.parametrize("rate,semitones,formants", [(0.7, 0, False), (0.8, -7, True)])
def test_offline_matches_scalar_renderer(rate, semitones, formants):
    cfg = StretchConfig(channels=1, block=1024, interval=256, formants=formants)
    x = _material()
    params = StretchParams.make(rate=rate, semitones=semitones, tonality_hz=8000.0,
                                sample_rate=SR, device="cpu")
    got = stretch_offline(x, rate, cfg, params=params, n_out=16384, device="cpu")
    want = render_offline(x.astype(np.float64), rate, JConfig(
        channels=1, block=1024, interval=256, formants=formants), 16384,
        transpose_factor=2.0 ** (semitones / 12.0), tonality=8000.0 / SR)
    assert snr_db(want[:, cfg.block:], got[:, cfg.block:]) > 45.0


@pytest.mark.parametrize("formant_semitones,bound", [(0.0, 80.0), (-2.0, 60.0)])
def test_offline_matches_jax_driver(formant_semitones, bound):
    """Stereo, rate 1.3, +4 st: the port's chunk loop against the JAX
    driver's one jitted scan.  With formant controls the JAX package's own
    jitted and eager renders differ at about 68 dB (the gain is the square
    root of a ratio of envelope values that a fused exp or log moves), so
    that case is held at the formant bound."""
    kw = dict(rate=1.3, semitones=4.0, tonality_hz=6000.0,
              formant_semitones=formant_semitones, formant_base_hz=220.0, sample_rate=SR)
    x = _tracks(seconds=1.0)[0]
    want = joffline.stretch_offline(x, 1.3, JConfig(channels=2, block=1024, interval=256),
                                    params=JParams.make(**kw), n_out=12000, chunk_hops=16)
    got = stretch_offline(x, 1.3, StretchConfig(channels=2, block=1024, interval=256),
                          params=StretchParams.make(device="cpu", **kw), n_out=12000,
                          chunk_hops=16, device="cpu")
    assert got.shape == want.shape == (2, 12000)
    assert snr_db(want, got) >= bound


@pytest.mark.parametrize("formant_voice", [False, True])
@pytest.mark.parametrize("geometry", ["small", "preset"])
def test_card_arithmetic_within_chip_smoke_gates(monkeypatch, geometry, formant_voice):
    """The same inputs through the CPU path and through the formulas a CUDA
    tensor takes (PyTorch's own FFT, the float32 complex product,
    ``torch.abs``), run on the CPU: each stage and the 3-chunk render stay
    above ``chip_smoke.py``'s card-against-CPU gates, PARITY_DB (80 dB) and,
    for a formant voice's gain and render, FORMANT_PARITY_DB (45 dB).  The
    rotation factors are weighted by the magnitude they multiply: a silent
    band's phase is rounding noise on either path."""
    from bauklank_tpu_torch.engine.batched import formants_off
    from bauklank_tpu_torch.engine.config import preset_default
    from bauklank_tpu_torch.ops import formant, mdft, pitchmap

    rates, tones, active = (0.5, 1.3, 2.0, 0.8), (-12.0, 0.0, 7.0, 12.0), (1.0, 1.0, 1.0, 0.0)
    cfg, h = ((StretchConfig(2, 1024, 256), 8) if geometry == "small"
              else (preset_default(2, SR), 16))
    run_cfg = cfg if formant_voice else formants_off(cfg)
    src = material.case_input(2.0, 2, seconds=8.0)
    audio = torch.from_numpy(np.stack([np.roll(src, 977 * i, axis=-1)
                                       for i in range(len(rates))]).astype(np.float32))
    extra = {"formant_semitones": 3.0, "formant_compensation": 1.0}
    params = StretchParams.stack([
        StretchParams.make(active=a, rate=r, semitones=st, device="cpu",
                           **(extra if formant_voice and i == 1 else {}))
        for i, (r, st, a) in enumerate(zip(rates, tones, active))])
    ends = [torch.from_numpy(np.stack([frame_ends_for(cfg, c * h * cfg.interval, h, r)
                                       for r in rates]).astype(np.int32)) for c in range(4)]
    state, _ = core.process_chunk(run_cfg, core.fresh_state(run_cfg, len(rates), "cpu"),
                                  audio, ends[0], params)

    def run():
        stages = (core.analyse(run_cfg, audio, ends[1]),) + core.hop_factors(
            run_cfg, audio, ends[1], params, state.prev_cur)
        st, outs = state, []
        for c in (1, 2, 3):
            st, out = core.process_chunk(run_cfg, st, audio, ends[c], params)
            outs.append(out)
        return stages, torch.cat(outs, -1)

    cpu, cpu_render = run()
    monkeypatch.setattr(mdft, "_fft", lambda z, inverse=False: (
        torch.fft.ifft if inverse else torch.fft.fft)(z, dim=-1))
    monkeypatch.setattr(mdft, "cmul", lambda x, y: x * y)
    for mod in (mdft, formant, pitchmap):
        monkeypatch.setattr(mod, "cabs", torch.abs)
    monkeypatch.setattr(formant, "rfft", lambda x: torch.fft.rfft(x, dim=-1))
    monkeypatch.setattr(formant, "irfft", lambda z, n: torch.fft.irfft(z, n=n, dim=-1))
    card, card_render = run()

    mag = torch.sqrt(torch.sum(torch.square(torch.abs(cpu[2])), dim=1)).numpy()
    assert snr_db(cpu[0].numpy(), card[0].numpy()) >= 80.0          # analyses
    assert snr_db(cpu[2].numpy(), card[2].numpy()) >= 80.0          # cur_m
    assert snr_db(cpu[1].numpy() * mag, card[1].numpy() * mag) >= 80.0
    gate = 45.0 if formant_voice else 80.0
    assert snr_db(cpu[3][:, 0].numpy() * mag, card[3][:, 0].numpy() * mag) >= gate
    assert snr_db(cpu_render.numpy(), card_render.numpy()) >= gate


def test_init_state_layout():
    cfg = StretchConfig(channels=2, block=1024, interval=256)
    one, many = core.init_state(cfg, device="cpu"), init_batched_state(cfg, 3, device="cpu")
    j_one = jax.tree.map(np.asarray, jcore.init_state(JConfig(channels=2, block=1024,
                                                              interval=256)))
    for a, b, j in zip(one, many, j_one):
        assert a.shape == (1,) + j.shape and b.shape == (3,) + j.shape
        np.testing.assert_array_equal(a[0].numpy(), j)
        np.testing.assert_array_equal(b[2].numpy(), j)
