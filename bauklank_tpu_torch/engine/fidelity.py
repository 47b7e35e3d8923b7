"""Fidelity renderer: the reference worklet drive around the blob-exact core.

Port of ``bauklank_tpu/engine/fidelity.py`` for the serving forms.  One
pool step (:func:`batched_fidelity_chunk`) runs:

1. the windowed cur/prev frame fetch (kernel 1) and a batched MDFT;
2. ``engine.spectral.minstd_hops`` and ``chain_inputs_drawn`` (together
   ``chain_inputs_hops``): every hop-local input of the chunk in one
   batched pass (the smoother pair via kernel 8, the peaks
   map via kernel 2, gathers via kernel 3 or the fused kernel 7, the
   formant chain where a voice asks for it);
3. a Python loop over hops whose body rotates the carried spectrum, forms
   the time prediction and ``u12``, and runs the band chain (kernel 4);
4. the batched inverse MDFT and the overlap-add with the carried tail.

While a profiler records, each stage runs inside a ``record_function``
range (``utils.metrics.span``: ``fidelity.analyse``,
``fidelity.chain_inputs``, ``fidelity.hop_loop``, ``fidelity.synthesis``),
and the carried state's update after them (inactive streams keep theirs)
inside ``fidelity.carry``, so a profile splits the whole step's host and
device time by stage.  Stage 2's MINSTD part (``minstd_hops``: every
hop's seed, its 2B-2 draws, the state carried out) runs in a sibling
range before it, ``fidelity.minstd``, on a step outside the
deterministic regime (some stream at time factor > 2, or no word on the
regime); inside that regime it adds a second ``fidelity.chain_inputs``.

The host side (:func:`hop_frame_ends`) replicates the worklet's float time
accumulation bit-for-bit, as the JAX package does.

The per-hop forms the JAX suite pins the serving step against are here
too: :func:`batched_fidelity_chunk_scan` (every hop's chain inputs
recomputed inside the hop loop, ``engine.spectral.spectral_hop_batched``),
and the one-stream render :func:`_render_jit` over :func:`_scan_hops`,
which JAX's ``render_fidelity`` runs; the port's :func:`render_fidelity`
keeps the serving route.

:func:`batched_live_fidelity_chunk` is the coupled (live-input) drive:
the same step fed from a rolling input ring with constant frame ends.
"""

from __future__ import annotations

import numpy as np
import torch

from bauklank_tpu_torch.engine.spectral import (
    SpectralConfig,
    SpectralState,
    _div_real,
    _hop_chain,
    band_chain_packed,
    blob_window,
    chain_inputs_drawn,
    init_spectral_state,
    minstd_hops,
    spectral_hop,
    spectral_hop_batched,
)
from bauklank_tpu_torch.kernels.frames import frames_windowed
from bauklank_tpu_torch.ops import framing, mdft
from bauklank_tpu_torch.ops.mdft import unit_phase
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import span, table_cache
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = [
    "SpectralConfig",
    "hop_frame_ends",
    "analyse_frames",
    "synthesise_frames",
    "init_fidelity_state",
    "init_batched_fidelity_state",
    "fidelity_stages",
    "batched_fidelity_chunk",
    "batched_fidelity_chunk_scan",
    "fidelity_chunk",
    "live_fidelity_ring_len",
    "init_batched_live_fidelity_state",
    "batched_live_fidelity_chunk",
    "fidelity_state_from_numpy",
    "fidelity_state_to_numpy",
    "render_fidelity",
]

QUANTUM = 128  # browser render quantum (reference :820-826)


def hop_frame_ends(
    cfg: SpectralConfig,
    n_hops: int,
    rate: float,
    sample_rate: float,
    input_offset: float = 0.0,
    split: bool = True,
) -> np.ndarray:
    """Per-hop analysis frame ends (exclusive, in track samples).

    Hop ``h`` fires at output-counter sample ``o = h*interval``; its
    analyses see the ring primed by the seek of the quantum containing
    ``o``: inputEnd = round((seg.input + (q*128/sr + outLat_sec)*rate +
    inLat_sec) * sr), with the quantum clock ACCUMULATED in float64 exactly
    like the worklet — the rounding at half-sample boundaries depends on it.

    ``split``: splitComputation mode; it changes outputLatency (split off
    drops the +interval) and hence every inputEnd.
    """
    sr = float(sample_rate)
    in_lat = cfg.block // 2
    out_lat = (cfg.block - cfg.block // 2) + (cfg.interval if split else 0)
    in_lat_sec, out_lat_sec = in_lat / sr, out_lat / sr
    n_q = (n_hops * cfg.interval) // QUANTUM + 1
    ie_by_q = np.empty(n_q, np.int64)
    t = 0.0
    for q in range(n_q):
        ie_by_q[q] = round((input_offset + (t + out_lat_sec) * rate + in_lat_sec) * sr)
        t += QUANTUM / sr
    hops = np.arange(n_hops)
    return ie_by_q[(hops * cfg.interval) // QUANTUM].astype(np.int32)


@table_cache(maxsize=64)
def _consts(cfg: SpectralConfig, device: torch.device, zero_head: int = 0):
    """(window [block] f32, analysis reference rotation [bands] c64) on
    ``device``, built once per geometry; ``zero_head`` zeroes the first
    window samples (the split-off prev-analysis law)."""
    w = blob_window(cfg.block, cfg.interval).astype(np.float32)
    w[:zero_head] = 0.0
    a = cfg.block // 2
    rot = 2.0 * np.pi * (np.arange(cfg.bands) + 0.5) * a / cfg.fft  # analysis ref shift
    return torch.from_numpy(w).to(device), unit_phase(rot.astype(np.float32), device)


def _padded_spectra(cfg: SpectralConfig, padded: torch.Tensor) -> torch.Tensor:
    """Windowed frames zero-padded to [..., fft] -> zero-phase referenced
    [..., bands]."""
    _, rot = _consts(cfg, padded.device)
    return mdft.cmul(mdft.mdft(padded), rot)


def _spectra(cfg: SpectralConfig, windowed: torch.Tensor) -> torch.Tensor:
    """Windowed frames [..., block] -> zero-phase referenced [..., bands]."""
    return _padded_spectra(cfg, torch.nn.functional.pad(windowed, (0, cfg.fft - cfg.block)))


def analyse_frames(cfg: SpectralConfig, audio: torch.Tensor, ends: torch.Tensor,
                   zero_head: int = 0) -> torch.Tensor:
    """Blob analyses of frames ENDING at ``ends``: audio [C, T], ends [H]
    -> [H, C, bands] complex64.  ``zero_head`` zeroes the first samples of
    each window — the splitComputation=false PREV-analysis law."""
    frames = framing.gather_frames(audio, ends.to(torch.int64) - cfg.block, cfg.block)
    windowed = frames * _consts(cfg, audio.device, zero_head)[0]   # [C, H, block]
    return _spectra(cfg, windowed).transpose(0, 1)


def synthesise_frames(cfg: SpectralConfig, specs: torch.Tensor) -> torch.Tensor:
    """Inverse of analyse_frames: [..., H, C, bands] -> synthesis-windowed
    time frames [..., C, H, block], ready to overlap-add."""
    w, rot = _consts(cfg, specs.device)
    spec = mdft.cmul(specs.transpose(-3, -2), torch.conj(rot))
    blocks = mdft.imdft(spec, cfg.fft)[..., : cfg.block]
    return blocks * w


def _analyse_many(cfg: SpectralConfig, audios, ends, zero_head: int = 0):
    """Batched analyses across the pool: [S, C, T] x [S, F] ends ->
    [S, F, C, bands].  The windowed frame fetch is kernel 1; it reads
    exactly ``block`` samples per frame and writes them into rows of
    ``fft`` samples with a zero tail, so no pad pass runs on the card."""
    starts = (ends.to(torch.int64) - cfg.block).to(torch.int32).contiguous()
    window = _consts(cfg, audios.device, zero_head)[0]
    return _padded_spectra(cfg, frames_windowed(audios, starts, window, cfg.fft))


def _analyse_cur_prev(cfg: SpectralConfig, audios, ends, full_prev: bool = False):
    """Batched cur/prev analyses for a pool chunk ([S, H] ends ->
    [H, S, C, bands] each): with split on both frame families analyse in
    ONE batched pass; with split off the prev windows zero their first
    interval (the decoded split-off law).  ``full_prev`` takes the
    full-window prev analysis even with split off: the coupled (live)
    drive never seeks, and the zero head comes from the seek path's short
    prev refresh."""
    h = ends.shape[1]
    if cfg.split or full_prev:
        both = torch.cat([ends, ends - cfg.interval], dim=1)     # [S, 2H]
        specs = _analyse_many(cfg, audios, both)
        return specs[:, :h].transpose(0, 1), specs[:, h:].transpose(0, 1)
    cur = _analyse_many(cfg, audios, ends)
    prev = _analyse_many(cfg, audios, ends - cfg.interval, zero_head=cfg.interval)
    return cur.transpose(0, 1), prev.transpose(0, 1)


def _ola_emit(cfg: SpectralConfig, frames, tails, active, h: int):
    """Overlap-add + tail carry for every stream: frames [S, C, H, block],
    tails [S, C, block + interval], active [S].  Frame ``i`` lands at chunk
    samples [(i+1)*interval, ...) with split on (the measured placement),
    [i*interval, ...) with split off; contributions past the emitted chunk
    carry in the tail (always block + interval wide)."""
    interval, block = cfg.interval, cfg.block
    ola = framing.overlap_add(frames, interval, h * interval + block)
    pad = (interval, 0) if cfg.split else (0, interval)
    ola = torch.nn.functional.pad(ola, pad)
    ola[..., : block + interval] += tails
    emit = ola[..., : h * interval] * active[:, None, None]
    return emit, ola[..., h * interval:]


def init_fidelity_state(cfg: SpectralConfig, device, seed: int = 1):
    """(SpectralState, ola_tail [C, block + interval]) for one stream."""
    return (
        init_spectral_state(cfg, device, seed),
        torch.zeros((cfg.channels, cfg.block + cfg.interval), dtype=torch.float32,
                    device=device),
    )


def init_batched_fidelity_state(cfg: SpectralConfig, capacity: int, device, seed: int = 1):
    """The one-stream state repeated over a leading [capacity] axis."""
    spec, tail = init_fidelity_state(cfg, device, seed)
    rep = lambda x: x[None].repeat((capacity,) + (1,) * x.dim())
    return SpectralState(*[rep(x) for x in spec]), rep(tail)


def _hop_loop(cfg: SpectralConfig, prev_out: torch.Tensor, xs: dict) -> torch.Tensor:
    """The sequential part of a chunk: each hop rotates the carried
    spectrum, forms the time prediction and ``u12``, and runs the band
    chain (kernel 4).  prev_out [S, C, B]; ``xs`` from
    ``chain_inputs_drawn``.  Returns every hop's output [S, H, C, B]."""
    outs = []
    for i in range(xs["tw"].shape[0]):
        x = {k: v[i] for k, v in xs.items()}
        prev_out = band_chain_packed(cfg, _hop_chain(cfg, prev_out, x, x["den"]))
        outs.append(prev_out)
    return torch.stack(outs, dim=1)


def fidelity_stages(cfg: SpectralConfig, states, audios, ends, tf, mult, limit, active,
                    formant_factor=None, formant_compensation=None, formant_base=None,
                    coupled: bool = False, deterministic: bool | None = None):
    """:func:`batched_fidelity_chunk`'s stages, in step order: a list of
    (range name, stage), each stage a function of no arguments that reads
    what the stages before it left in the dict ``v`` and leaves its own
    results there.  Returns (v, stages); once every stage has run,
    ``v["states"]`` and ``v["emit"]`` are the chunk's results.

    The stages are apart so that a caller can run each inside its range
    or capture each as a CUDA graph of its own (``serve/graphs.py``)."""
    spec_states, tails = states
    h = ends.shape[1]
    v = {}

    def analyse():
        v["cur"], v["prev"] = _analyse_cur_prev(cfg, audios, ends, full_prev=coupled)

    def minstd():
        v["draws"] = minstd_hops(cfg, spec_states.rng, tf, h, deterministic)

    def chain_inputs():
        v["xs"], v["fv_fw"] = chain_inputs_drawn(
            cfg, spec_states, v["cur"], v["prev"], tf, mult, limit,
            formant_factor, formant_compensation, formant_base, deterministic, v["draws"])

    def hop_loop():
        xs, (fv, fw) = v["xs"], v["fv_fw"]
        v["outs"] = outs = _hop_loop(cfg, spec_states.prev_output, xs)   # [S, H, C, B]
        v["new_spec"] = SpectralState(
            prev_output=outs[:, -1],
            prev_pred_energy=xs["pred_energy"][-1],
            rng=v["draws"][2],
            f_value_ema=fv,
            f_weighted_ema=fw,
        )

    def synthesis():
        v["emit"], v["new_tails"] = _synthesis(cfg, v["outs"], tails, active)

    def carry():
        v["states"] = _carry((v["new_spec"], v["new_tails"]), states, active)

    # outside the deterministic regime the MINSTD seeds, draw streams and
    # carried state are a stage of their own
    return v, [("fidelity.analyse", analyse),
               ("fidelity.chain_inputs" if deterministic else "fidelity.minstd", minstd),
               ("fidelity.chain_inputs", chain_inputs),
               ("fidelity.hop_loop", hop_loop),
               ("fidelity.synthesis", synthesis),
               ("fidelity.carry", carry)]


def batched_fidelity_chunk(cfg: SpectralConfig, states, audios, ends, tf, mult, limit,
                           active, formant_factor=None, formant_compensation=None,
                           formant_base=None, coupled: bool = False,
                           deterministic: bool | None = None):
    """Whole-pool fidelity step, hop-parallel form: the stages of
    :func:`fidelity_stages`, each inside its range.

    states = (SpectralState with a leading [S] axis, tails [S, C, block +
    interval]); audios [S, C, T] f32; ends [S, H] int frame ends; tf, mult,
    limit, active and the three formant controls [S] f32 (the formant
    chain runs where ``cfg.formants`` and the controls are given).
    ``coupled``: the live drive, whose prev analysis keeps its full window
    with split off (only the placement half of the split-off law applies).
    ``deterministic``: the caller's word that every stream is at time
    factor <= 2 (``engine.spectral._hop_inputs_hoisted``).  Returns
    ((new_spec_state, new_tails), emit [S, C, H * interval]).  Inactive
    streams keep their state frozen and emit silence."""
    v, stages = fidelity_stages(cfg, states, audios, ends, tf, mult, limit, active,
                                formant_factor, formant_compensation, formant_base,
                                coupled, deterministic)
    for name, stage in stages:
        with span(name):
            stage()
    return v["states"], v["emit"]


def _synthesis(cfg: SpectralConfig, outs, tails, active):
    """Synthesis and overlap-add of every hop's output ``outs`` [S, H, C,
    B] with the carried ``tails``: (emit [S, C, H * interval], new tails)."""
    frames = synthesise_frames(cfg, outs)                           # [S, C, H, block]
    return _ola_emit(cfg, frames, tails, active, outs.shape[1])


def _carry(new, states, active):
    """The carried state: ``new`` (spec_state, tails) where a stream is
    active, ``states`` (the step's input) frozen where not."""
    keep = active > 0

    def freeze(a, old):
        return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, old)

    (spec, tails), (old_spec, old_tails) = new, states
    return (SpectralState(*[freeze(a, b) for a, b in zip(spec, old_spec)]),
            freeze(tails, old_tails))


def _finish(cfg: SpectralConfig, outs, new_spec: SpectralState, states, active):
    """:func:`_synthesis` and :func:`_carry` inside their ranges.  Returns
    ((spec_state, tails), emit [S, C, H * interval])."""
    with span("fidelity.synthesis"):
        emit, new_tails = _synthesis(cfg, outs, states[1], active)
    with span("fidelity.carry"):
        return _carry((new_spec, new_tails), states, active), emit


def batched_fidelity_chunk_scan(cfg: SpectralConfig, states, audios, ends, tf, mult, limit,
                                active, formant_factor=None, formant_compensation=None,
                                formant_base=None):
    """The hop-scan form of :func:`batched_fidelity_chunk`: the same
    analyses and synthesis, but each hop's chain inputs recomputed inside
    the hop loop (``engine.spectral.spectral_hop_batched``: the peaks map,
    the gathers and the formant chain once a hop, the band chain as
    kernel 4 on the card).  The JAX package keeps it as the cross-check
    oracle of the serving form; the tests hold the two to its bars.  Same
    arguments and results as :func:`batched_fidelity_chunk` (no coupled
    drive, no regime word)."""
    spec_states, _ = states
    cur, prev = _analyse_cur_prev(cfg, audios, ends)
    st, outs = spec_states, []
    for i in range(ends.shape[1]):
        st, out = spectral_hop_batched(cfg, st, cur[i], prev[i], tf, mult, limit,
                                       formant_factor, formant_compensation, formant_base)
        outs.append(out)
    return _finish(cfg, torch.stack(outs, dim=1), st, states, active)


def _scan_hops(cfg: SpectralConfig, state: SpectralState, cur, prev, time_factor, mult, limit,
               formant_factor=None, formant_compensation=None, formant_base=None):
    """:func:`engine.spectral.spectral_hop` over the hops of one stream:
    state without a stream axis, cur and prev [H, C, B], scalar controls.
    Returns (state, outs [H, C, B]).  A plain loop with complex operands
    (the JAX form carries them as float pairs through ``lax.scan``, which
    the TPU needs)."""
    outs = []
    for i in range(cur.shape[0]):
        state, out = spectral_hop(cfg, state, cur[i], prev[i], time_factor, mult, limit,
                                  formant_factor, formant_compensation, formant_base)
        outs.append(out)
    return state, torch.stack(outs)


def _render_jit(cfg: SpectralConfig, audio, frame_ends, n_out: int, time_factor, mult, limit,
                state: SpectralState, formants: tuple | None = None, split: bool = True):
    """One stream rendered hop by hop, JAX's ``render_fidelity`` body:
    analyses of every hop (split on: the cur and prev frames in one pass;
    split off: the prev windows with their first interval zeroed), then
    :func:`_scan_hops`, synthesis and one overlap-add, frames placed at
    ``(h + 1) * interval`` with split on and ``h * interval`` with split
    off.  audio [C, T]; frame_ends [H]; ``formants`` (factor,
    compensation, base) or None.  Returns (state, out [C, n_out]).  The
    name is JAX's; PyTorch runs it eagerly, with nothing to compile."""
    h = frame_ends.shape[0]
    if split:
        specs = analyse_frames(cfg, audio, torch.cat([frame_ends, frame_ends - cfg.interval]))
        cur, prev = specs[:h], specs[h:]
    else:
        cur = analyse_frames(cfg, audio, frame_ends)
        prev = analyse_frames(cfg, audio, frame_ends - cfg.interval, zero_head=cfg.interval)
    state, outs = _scan_hops(cfg, state, cur, prev, time_factor, mult, limit,
                             *(formants or ()))
    ola = framing.overlap_add(synthesise_frames(cfg, outs), cfg.interval, n_out)
    if split:
        ola = torch.nn.functional.pad(ola, (cfg.interval, 0))
    return state, ola[:, :n_out]


def fidelity_chunk(cfg: SpectralConfig, state, audio, frame_ends, time_factor, mult, limit,
                   active, formant_factor=None, formant_compensation=None, formant_base=None,
                   deterministic: bool | None = None):
    """One stream's step: :func:`batched_fidelity_chunk` with a stream
    axis added around its operands and stripped from its results.

    state = (SpectralState, ola_tail [C, block + interval]) of one stream;
    audio [C, T]; frame_ends [H]; the controls are scalars.  Returns
    (state, emit [C, H * interval])."""
    dev = audio.device
    one = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)
    formants = [None if x is None else one(x)
                for x in (formant_factor, formant_compensation, formant_base)]
    new, emit = batched_fidelity_chunk(
        cfg, tree_map(lambda x: x[None], state), audio[None], frame_ends[None],
        one(time_factor), one(mult), one(limit), one(active), *formants,
        deterministic=deterministic)
    return tree_map(lambda x: x[0], new), emit[0]


def live_fidelity_ring_len(cfg: SpectralConfig, hops: int) -> int:
    """Input-ring length of the coupled (live-input) drive: the oldest
    window a chunk of ``hops`` hops reads is the prev analysis of its first
    hop, ``block + interval`` samples before that hop's window end, which
    itself sits ``hops * interval`` before the ring's write head."""
    return cfg.block + (hops + 1) * cfg.interval


def init_batched_live_fidelity_state(cfg: SpectralConfig, hops: int, capacity: int,
                                     device, seed: int = 1):
    """(SpectralState, ola_tail, input_ring [S, C, L]) for ``capacity``
    streams.  The ring starts zeroed: the blob's freshly reset input ring
    (silence before the stream starts)."""
    spec, tails = init_batched_fidelity_state(cfg, capacity, device, seed)
    rings = torch.zeros((capacity, cfg.channels, live_fidelity_ring_len(cfg, hops)),
                        dtype=torch.float32, device=device)
    return spec, tails, rings


def batched_live_fidelity_chunk(cfg: SpectralConfig, states, chunks, mult, limit, active,
                                formant_factor=None, formant_compensation=None,
                                formant_base=None):
    """The coupled (live-input) pool step: consume ``chunks [S, C, H *
    interval]`` of live input per stream and emit as many processed
    samples.

    The reference's live branch copies each render quantum into the input
    ring and processes it with no seek, so input fills the ring in
    lockstep with the output: chunk-local hop ``i`` analyses the window
    ending ``(H - i) * interval`` before the ring's write head, the time
    factor is 1 (the deterministic regime, MINSTD never drawn), and with
    split off only the placement half of the split-off law applies.  This
    is :func:`batched_fidelity_chunk` on the rolled ring with constant
    frame ends and ``coupled=True``.

    states = (SpectralState, ola_tail, ring) from
    :func:`init_batched_live_fidelity_state`.  A chunk whose hops reach
    back further than the ring raises (the JAX package reads zeros there)."""
    spec_states, tails, rings = states
    s_n, _, n = chunks.shape
    interval = cfg.interval
    h = n // interval
    if h * interval != n:
        raise ValueError(f"chunk of {n} samples is not a whole number of {interval}-sample hops")
    el = rings.shape[-1]
    if el < live_fidelity_ring_len(cfg, h):
        raise ValueError(
            f"a chunk of {h} hops needs a ring of {live_fidelity_ring_len(cfg, h)} samples; "
            f"the state's ring holds {el} (build it with hops >= {h})")
    rings = torch.cat([rings[:, :, n:], chunks.to(torch.float32)], dim=-1)
    ends = el - (h - torch.arange(h, dtype=torch.int32, device=rings.device)) * interval
    (spec_states, tails), emit = batched_fidelity_chunk(
        cfg, (spec_states, tails), rings, ends[None].expand(s_n, h),
        torch.ones(s_n, dtype=torch.float32, device=rings.device), mult, limit, active,
        formant_factor, formant_compensation, formant_base,
        coupled=True, deterministic=True)
    return (spec_states, tails, rings), emit


def fidelity_state_from_numpy(tree, device):
    """The JAX state pytree ``(SpectralState, ola_tail)`` or, for the live
    drive, ``(SpectralState, ola_tail, input_ring)`` with numpy leaves (any
    leading batch axes) -> the port's tensors on ``device``.  The MINSTD
    state is uint32 in JAX and int64 here."""
    spec, *rest = tree
    po, ppe, rng, fv, fw = spec
    t = lambda x, dt: torch.from_numpy(np.array(x, dtype=dt)).to(device)
    return (
        SpectralState(
            prev_output=t(po, np.complex64),
            prev_pred_energy=t(ppe, np.float32),
            rng=t(np.asarray(rng).astype(np.int64), np.int64),
            f_value_ema=t(fv, np.float32),
            f_weighted_ema=t(fw, np.float32),
        ),
        *(t(x, np.float32) for x in rest),
    )


def fidelity_state_to_numpy(state):
    """Inverse of :func:`fidelity_state_from_numpy`: numpy leaves in the
    JAX layout and dtypes (rng back to uint32)."""
    spec, *rest = state
    n = lambda x: x.detach().cpu().numpy()
    return (
        SpectralState(
            prev_output=n(spec.prev_output),
            prev_pred_energy=n(spec.prev_pred_energy),
            rng=n(spec.rng).astype(np.uint32),
            f_value_ema=n(spec.f_value_ema),
            f_weighted_ema=n(spec.f_weighted_ema),
        ),
        *(n(x) for x in rest),
    )


def render_fidelity(
    audio: np.ndarray,
    sample_rate: float,
    n_out: int,
    rate: float = 1.0,
    semitones: float = 0.0,
    tonality_hz: float = 8000.0,
    block_ms: float = 120.0,
    interval_ms: float = 30.0,
    state=None,
    seed: int = 1,
    formant_semitones: float = 0.0,
    formant_compensation: bool = False,
    formant_base_hz: float = 0.0,
    split_computation: bool = True,
    hops_per_chunk: int = 8,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Render ``n_out`` frames of one stream in the serving form: the
    stream runs through :func:`batched_fidelity_chunk` chunk by chunk
    with carried state (the hop count padded to whole chunks).  Same
    arguments and semantics as the reference harness'
    ``native.render_reference``.  ``state``: the stream's state to start
    from instead of a fresh one seeded with ``seed``: a
    :class:`SpectralState` without a stream axis, as JAX's
    ``render_fidelity`` takes it (the overlap-add starts empty).  Beyond
    JAX's contract it also takes the pair (SpectralState, ola_tail) that
    :func:`fidelity_chunk` carries, and then continues a render exactly
    where another left off: two halves rendered so equal one call.
    It runs on ``device``, the card unless the caller passes another.
    audio [C, T] float32 -> [C, n_out] float32."""
    device = resolve_device(device)
    sr = float(sample_rate)
    use_formants = formant_semitones != 0.0 or bool(formant_compensation)
    cfg = SpectralConfig(channels=audio.shape[0], block=round(block_ms / 1000 * sr),
                         interval=round(interval_ms / 1000 * sr), formants=use_formants,
                         split=split_computation)
    n_hops = -(-n_out // cfg.interval)
    n_hops = -(-n_hops // hops_per_chunk) * hops_per_chunk
    ends = torch.from_numpy(hop_frame_ends(cfg, n_hops, rate, sr, split=split_computation))
    mult = float(np.exp2(semitones / 12.0))
    one = lambda v: torch.tensor([v], dtype=torch.float32, device=device)
    # blob seek law: timeFactor = f32(min(1/rate, interval))
    tf = min(1.0 / rate, float(cfg.interval))
    controls = [one(tf), one(mult), one((tonality_hz / sr) / np.sqrt(mult)), one(1.0)]
    if use_formants:
        controls += [one(float(np.exp2(formant_semitones / 12.0))),
                     one(1.0 if formant_compensation else 0.0), one(formant_base_hz / sr)]
    if state is None:
        state = init_fidelity_state(cfg, device, seed)
    elif isinstance(state, SpectralState):
        state = (state, init_fidelity_state(cfg, device)[1])
    state = tree_map(lambda x: torch.as_tensor(x).to(device)[None], state)
    audios = torch.from_numpy(np.asarray(audio, np.float32))[None].to(device)
    emitted = []
    for c in range(n_hops // hops_per_chunk):
        e = ends[c * hops_per_chunk:(c + 1) * hops_per_chunk][None].to(device)
        state, emit = batched_fidelity_chunk(cfg, state, audios, e, *controls,
                                             deterministic=float(np.float32(tf)) <= 2.0)
        emitted.append(emit[0])
    return torch.cat(emitted, dim=-1)[..., :n_out].cpu().numpy()
