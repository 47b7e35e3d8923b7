"""The fast stretch engine: hop-parallel spectral processing.

Port of ``bauklank_tpu/engine/core.py``, batched natively over a leading
stream axis (no ``vmap``): every function takes ``[S, ...]`` tensors and
every stream has its own controls.

For each synthesis hop the input is analysed at the mapped position and
one interval earlier; the per-band phase advance between the two is the
advance one output hop must add, whatever the stretch rate.  Output bands
read pitch-mapped input bands (``ops.pitchmap``, kernel 5) and are
rotated so each band's phase continues from the previous output hop:
``out_h = rot_h * cur_h`` with ``rot_h = rot_{h-1} * v_h``, where every
factor ``v_h`` comes from input analyses alone, so a chunk of hops is one
parallel prefix (``rotation_scan``).  A chunk runs as: the windowed frame
fetch (kernel 1) and a batched MDFT -> the pitch-map gather -> the
elementwise factors -> the prefix over hops -> the inverse MDFT and one
overlap-add.  The carried state between chunks is (rot, last mapped
spectrum, OLA tail).

The chunk is five stages (:func:`fast_stages`), which
:func:`process_chunk` runs in turn and a pool on the card captures as
CUDA graphs (``serve/graphs.py``).  While a profiler records, each stage
runs inside a ``record_function`` range (``utils.metrics.span``:
``fast.analyse``, ``fast.hop_factors``, ``fast.rotation_scan``,
``fast.synthesis``), and the carried state's update after them inside
``fast.carry``, so a profile splits the whole step by stage; a stage's
constant tables are looked up (built, on first use) inside its range.
The JAX module's fused-MDFT A/B (``_use_fused_mdft``, off by default
there) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.kernels.frames import frames_windowed
from bauklank_tpu_torch.ops import formant as formant_ops
from bauklank_tpu_torch.ops import framing, mdft, pitchmap, windows
from bauklank_tpu_torch.ops.scan import associative_scan
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.metrics import span, table_cache

__all__ = [
    "StretchState",
    "init_state",
    "process_chunk",
    "fast_stages",
    "analyse",
    "hop_factors",
    "rotation_scan",
    "synthesis",
    "flush",
    "stretch_state_from_numpy",
    "stretch_state_to_numpy",
]


class StretchState(NamedTuple):
    """Per-stream carried state, with a leading stream axis."""

    rot: torch.Tensor       # [S, bins] complex64 — accumulated band rotation
    prev_cur: torch.Tensor  # [S, C, bins] complex64 — last hop's mapped spectrum
    ola_tail: torch.Tensor  # [S, C, block] float32 — synthesized, not yet emitted


def fresh_state(config: StretchConfig, n_streams: int, device: torch.device) -> StretchState:
    """The reference ``_reset`` state for ``n_streams`` streams."""
    return StretchState(
        rot=torch.ones((n_streams, config.bins), dtype=torch.complex64, device=device),
        prev_cur=torch.zeros((n_streams, config.channels, config.bins), dtype=torch.complex64,
                             device=device),
        ola_tail=torch.zeros((n_streams, config.channels, config.block), dtype=torch.float32,
                             device=device),
    )


def init_state(config: StretchConfig, device=DEFAULT_DEVICE) -> StretchState:
    """Fresh state of one stream (a leading stream axis of 1) on ``device``."""
    return fresh_state(config, 1, resolve_device(device))


@table_cache(maxsize=32)
def _window_consts(block: int, interval: int, beta: float | None, device: torch.device):
    """(analysis window, synthesis window, band centre frequencies) on
    ``device``, built once per geometry."""
    wa, ws = windows.pr_window_pair(block, interval, beta=beta)
    freqs = ((np.arange(block // 2) + 0.5) / block).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (wa, ws, freqs))


@table_cache(maxsize=32)
def _lobe_alpha(block: int, interval: int, beta: float | None = None) -> float:
    """Gaussian model of the analysis window's spectral main lobe:
    |G(x bins)| ~= exp(-alpha x^2), calibrated at x = 1 bin (float32)."""
    wa, _ = windows.pr_window_pair(block, interval, beta=beta)
    n = np.arange(block)
    center = (block - 1) / 2.0
    g0 = np.abs(np.sum(wa))
    g1 = np.abs(np.sum(wa * np.exp(-2j * np.pi * (1.0 / block) * (n - center))))
    return float(np.float32(-np.log(max(g1 / g0, 1e-6))))


@table_cache(maxsize=32)
def _center_phase(bins: int, device: torch.device) -> torch.Tensor:
    """Zero-phase (frame-centre) referencing rotation e^{i pi (k+1/2)} =
    i (-1)^k: analysis spectra are rotated so the window's lobe is
    phase-flat, which keeps relocated bands coherent; synthesis applies
    the conjugate."""
    sign = np.where(np.arange(bins) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return torch.complex(torch.zeros(bins), torch.from_numpy(sign)).to(device)


def _expi(x: torch.Tensor) -> torch.Tensor:
    """e^{i x} for real float32 x."""
    return torch.complex(torch.cos(x), torch.sin(x))


def _power(z: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over ``dim`` of |z|^2."""
    return torch.sum(torch.square(mdft.cabs(z)), dim=dim)


def analyse(config: StretchConfig, audio: torch.Tensor, frame_ends: torch.Tensor) -> torch.Tensor:
    """Centre-referenced spectra of each hop's current frame and of the
    frame one interval earlier, in one windowed fetch (kernel 1) and one
    batched MDFT: audio [S, C, T], frame_ends [S, H] -> [S, 2H, C, bins]
    (the H current frames first)."""
    with span("fast.analyse"):
        return _analyse(config, audio, frame_ends)


def _analyse(config: StretchConfig, audio: torch.Tensor, frame_ends: torch.Tensor) -> torch.Tensor:
    """:func:`analyse` outside its range."""
    block, interval = config.block, config.interval
    wa, _, _ = _window_consts(block, interval, config.window_beta, audio.device)
    starts_cur = frame_ends.to(torch.int32) - block
    starts = torch.cat([starts_cur, starts_cur - interval], dim=1).contiguous()
    frames = frames_windowed(audio, starts, wa)                         # [S, 2H, C, block]
    return mdft.cmul(mdft.mdft(frames), _center_phase(config.bins, audio.device))


def hop_factors(config: StretchConfig, audio: torch.Tensor, frame_ends: torch.Tensor,
                params: StretchParams, prev_cur: torch.Tensor):
    """Per-hop spectral quantities of every stream.

    audio [S, C, T], frame_ends [S, H] (exclusive ends of the current
    analysis frames), params [S] fields, prev_cur [S, C, bins].  Returns
    (v [S, H, bins] rotation factors, cur_m [S, C, H, bins] mapped
    spectra, gain [S, 1, H, bins], reset [S, H, bins] bool)."""
    specs = analyse(config, audio, frame_ends)                          # [S, 2H, C, bins]
    with span("fast.hop_factors"):
        return _factors(config, specs, params, prev_cur)


def _factors(config: StretchConfig, specs: torch.Tensor, params: StretchParams,
             prev_cur: torch.Tensor):
    """:func:`hop_factors` of the analysed ``specs`` [S, 2H, C, bins],
    outside its range."""
    block, interval = config.block, config.interval
    dev = specs.device
    h = specs.shape[1] // 2
    _, _, band_f = _window_consts(block, interval, config.window_beta, dev)
    tf = params.transpose_factor[:, None]                               # [S, 1]
    limit = pitchmap.effective_tonality_limit(tf, params.tonality[:, None])
    pos, dfreq = pitchmap.source_positions(band_f, tf, limit, block)       # [S, bins]
    specs_m = pitchmap.gather_fractional(specs, pos).transpose(1, 2)      # [S, C, 2H, bins]
    cur_m, prev_m = specs_m[:, :, :h], specs_m[:, :, h:]

    # Output phase rule: each band advances per hop by 2 pi f_out I plus
    # the measured deviation of its input content from the band centre,
    # scaled by the local map gradient g.  With out_h = rot_h * cur_h the
    # rotation update is rot_h = rot_{h-1} * a_h * b_h,
    #   a_h = unit(sum_c cur_{h-1} conj(cur_h))   (cancel cur's own progression)
    #   b_h = exp(i (2 pi f_out I + g dev_h))      (impose the desired advance)
    prev_hop_cur = torch.cat([prev_cur[:, :, None], cur_m[:, :, : h - 1]], dim=2)
    f_in = band_f - dfreq                                               # [S, bins]
    grad = torch.where(band_f <= limit * tf, tf, 1.0)                   # [S, bins]
    two_pi_i = float(np.float32(2.0 * np.pi * interval))

    w = pitchmap.unit(torch.sum(mdft.cmul(cur_m, torch.conj(prev_m)), dim=1))  # [S, H, bins]
    dev_h = torch.angle(mdft.cmul(w, _expi(-(two_pi_i * f_in))[:, None]))     # (-pi, pi]
    corr_a = torch.sum(mdft.cmul(prev_hop_cur, torch.conj(cur_m)), dim=1)
    v = mdft.cmul(pitchmap.unit(corr_a),
                  _expi(two_pi_i * band_f + grad[:, None] * dev_h))
    # no previous-output energy in a band: keep the rotation, so the
    # output phase restarts from the input phase
    v = torch.where(mdft.cabs(corr_a) > 1e-12, v, torch.ones((), dtype=v.dtype, device=dev))

    # lobe-consistent magnitude correction L(g delta) / L(delta), Gaussian
    # lobe model; exactly 1 where g == 1
    alpha = _lobe_alpha(block, interval, config.window_beta)
    delta = dev_h * float(np.float32(block / (2.0 * np.pi * interval)))
    gain = torch.clamp(torch.exp(((-alpha) * (torch.square(grad) - 1.0))[:, None]
                                 * torch.square(delta)), 0.05, 4.0)      # [S, H, bins]

    if config.formants:
        # one channel-summed envelope for all channels
        psum = _power(specs[:, :h], dim=2)                              # [S, H, bins]
        f0 = formant_ops.detect_f0_bands(psum)                          # [S, H]
        base_bands = (params.formant_base * block)[:, None]
        sigma = 0.5 * torch.where(base_bands > 0, base_bands, f0)
        env = formant_ops.spectral_envelope(psum, sigma)
        gain = gain * formant_ops.formant_gain(
            env, band_f, pos, params.formant_factor[:, None],
            params.formant_compensation[:, None], tf, limit, block)

    # transient detection: a band's onset is an energy jump over one interval
    if config.transient_reset_db is not None:
        thresh = float(np.float32(10.0 ** (config.transient_reset_db / 10.0)))
        e_cur, e_prev = _power(cur_m, dim=1), _power(prev_m, dim=1)
        reset = (e_cur > thresh * (e_prev + 1e-12)) & (e_cur > 1e-10)
    else:
        reset = torch.zeros(v.shape, dtype=torch.bool, device=dev)
    return v, cur_m, gain[:, None], reset


def _combine(a, b):
    """The "last reset wins" semigroup (ra, za) . (rb, zb) =
    (ra | rb, zb if rb else za * zb)."""
    (ra, za), (rb, zb) = a, b
    return [ra | rb, torch.where(rb, zb, mdft.cmul(za, zb))]


def rotation_scan(rot0: torch.Tensor, v: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Cumulative rotation with per-band resets, as one parallel prefix:
    rot_h = 1 where reset_h else rot_{h-1} * v_h, seeded with ``rot0``.
    rot0 [S, bins], v and reset [S, H, bins] -> [S, H, bins]."""
    flags = torch.cat([torch.zeros_like(reset[:, :1]), reset], dim=1)
    one = torch.ones((), dtype=v.dtype, device=v.device)
    vals = torch.cat([rot0[:, None], torch.where(reset, one, v)], dim=1)
    _, zs = associative_scan(_combine, [flags, vals], dim=1)
    return zs[:, 1:]


def fast_stages(config: StretchConfig, state: StretchState, audio: torch.Tensor,
                frame_ends: torch.Tensor, params: StretchParams):
    """:func:`process_chunk`'s stages, in step order: a list of (range
    name, stage), each stage a function of no arguments that reads what
    the stages before it left in the dict ``v`` and leaves its own results
    there.  Returns (v, stages); once every stage has run, ``v["states"]``
    and ``v["emit"]`` are the chunk's results.

    The stages are apart so that a caller can run each inside its range
    or capture each as a CUDA graph of its own (``serve/graphs.py``)."""
    v = {}

    def analyse_stage():
        v["specs"] = _analyse(config, audio, frame_ends)

    def factors():
        v["v"], v["cur_m"], v["gain"], v["reset"] = _factors(
            config, v.pop("specs"), params, state.prev_cur)

    def scan():
        v["rot_seq"] = rotation_scan(state.rot, v.pop("v"), v.pop("reset"))   # [S, H, bins]

    def synthesis_stage():
        v["emit"], v["new_tail"] = _synthesise(config, v["rot_seq"], v["cur_m"], v.pop("gain"),
                                               state.ola_tail, params.active)

    def carry():
        v["states"] = StretchState(
            rot=pitchmap.unit(v.pop("rot_seq")[:, -1]),
            prev_cur=v.pop("cur_m")[:, :, -1].contiguous(),
            ola_tail=v.pop("new_tail"),
        )

    return v, [("fast.analyse", analyse_stage),
               ("fast.hop_factors", factors),
               ("fast.rotation_scan", scan),
               ("fast.synthesis", synthesis_stage),
               ("fast.carry", carry)]


def process_chunk(config: StretchConfig, state: StretchState, audio: torch.Tensor,
                  frame_ends: torch.Tensor, params: StretchParams):
    """Process ``H`` hops of every stream: the stages of
    :func:`fast_stages`, each inside its range.

    state: :class:`StretchState` [S]; audio [S, C, T] source samples
    (out-of-range reads are zero); frame_ends [S, H] int, per hop the
    exclusive end of the current analysis frame (``round(input_center) +
    block // 2``); params [S] fields.  Returns ``(new_state, out)`` with
    out [S, C, H * interval] float32.  Inactive streams keep updating
    their state and emit silence."""
    v, stages = fast_stages(config, state, audio, frame_ends, params)
    for name, stage in stages:
        with span(name):
            stage()
    return v["states"], v["emit"]


def synthesis(config: StretchConfig, rot_seq: torch.Tensor, cur_m: torch.Tensor,
              gain: torch.Tensor, ola_tail: torch.Tensor, active: torch.Tensor):
    """Rotate, inverse-transform and overlap-add one chunk: rot_seq
    [S, H, bins], cur_m [S, C, H, bins], gain [S, 1, H, bins], ola_tail
    [S, C, block], active [S] -> (emit [S, C, H * interval], new tail)."""
    with span("fast.synthesis"):
        return _synthesise(config, rot_seq, cur_m, gain, ola_tail, active)


def _synthesise(config: StretchConfig, rot_seq: torch.Tensor, cur_m: torch.Tensor,
                gain: torch.Tensor, ola_tail: torch.Tensor, active: torch.Tensor):
    """:func:`synthesis` outside its range."""
    block, interval = config.block, config.interval
    h = cur_m.shape[2]
    _, ws, _ = _window_consts(block, interval, config.window_beta, cur_m.device)
    out_spec = mdft.cmul(rot_seq[:, None], cur_m) * gain                # [S, C, H, bins]
    out_spec = mdft.cmul(out_spec, torch.conj(_center_phase(config.bins, cur_m.device)))
    out_frames = mdft.imdft(out_spec, block) * ws                       # [S, C, H, block]
    ola = framing.overlap_add(out_frames, interval, h * interval + block)
    ola[..., :block] += ola_tail
    emit = ola[..., : h * interval] * active[:, None, None]
    new_tail = ola[..., h * interval: h * interval + block].contiguous()
    return emit, new_tail


def flush(config: StretchConfig, state: StretchState):
    """Emit the remaining OLA tail and reset it — the reference ``_flush``.
    Returns (state, tail [S, C, block])."""
    tail = state.ola_tail
    return state._replace(ola_tail=torch.zeros_like(tail)), tail


def stretch_state_from_numpy(tree, device) -> StretchState:
    """The JAX ``StretchState`` with numpy leaves (any leading batch axes)
    -> the port's tensors on ``device``."""
    rot, prev_cur, tail = tree
    t = lambda x, dt: torch.from_numpy(np.array(x, dtype=dt)).to(device)
    return StretchState(rot=t(rot, np.complex64), prev_cur=t(prev_cur, np.complex64),
                        ola_tail=t(tail, np.float32))


def stretch_state_to_numpy(state: StretchState) -> StretchState:
    """Inverse of :func:`stretch_state_from_numpy`: numpy leaves in the
    JAX layout and dtypes."""
    return StretchState(*[x.detach().cpu().numpy() for x in state])
