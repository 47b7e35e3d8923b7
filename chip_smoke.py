#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bauklank_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero without the result line):

1. device: the card's name and power limit, TF32 off;
2. build the seven CUDA kernels from ``bauklank_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, on operands
   captured from one step of the fidelity preset serving pool (S=128,
   H=8, 120/30 ms), of the same pool with the fused fetch switched on
   (``BAUKLANK_CHAINFETCH=1``: kernel 7, also held bit-equal to the two
   frac_gather launches it replaces), of the fidelity kiosk pool (S=64,
   H=4, 200/200 ms, rate 0.001) and of the fast preset pool (S=128, H=32,
   120/30 ms; the envelope gathers from a step with one formant voice),
   with both times, the least time the card could take (``bound``) and,
   where one PyTorch call computes the same function, that call's time;
   ``pallas_gather``, which no step calls, on the fidelity pools'
   five-family operands;
4. each stage of both engines' steps on the card against the same stage
   on the host CPU, fed the same inputs (the CPU path is the one the
   tests hold against the JAX package): the MDFT within a relative bound,
   every stage's output >= 80 dB SNR (the fast engine's gain for a
   formant voice >= 45 dB), the fidelity step also with formant voices
   and as a live (coupled) chunk, and the fast engine's whole 3-chunk
   render;
5. five golden cases rendered on the card through the fidelity serving
   forms (a formant case and a coupled one among them), each > 40 dB
   against the blob renders in tests/golden/golden_v1.npz, and a
   fast-engine identity render (``stretch_offline``, rate 1, 0 st)
   > 50 dB against its input;
6. serving: the two fidelity pools, the preset pool with the fused fetch
   (its master held equal, bit for bit, to the unfused pool's) and the
   fast pool driven through ``StreamPool`` (tracks, starts, ``set``
   messages through ``protocol.parse_line`` and ``apply_set``), 2 warm-up
   and 6 to 10 timed steps each, the launch counts set to 0 before each
   pool and read after it; then 5 steps of the fidelity preset pool and of
   the fast pool with a formant voice, and ``pallas_gather`` driven
   directly, once;
7. where the time goes: a ``torch.profiler`` run of 5 more steps of each
   pool, split by the step's stages (host and device time each) and
   the card's busy share.

It prints one JSON line of per-kernel results, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  It needs CUDA; without a card
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100.0
TOLERANCE = 0.0   # every kernel is held bit-equal to its plain version
# card against host CPU, each stage fed the same inputs: cuFFT against
# pocketfft, the card's float32 complex product and hypot round a few ulps
# otherwise (~120 dB); a flipped leader channel or peak assignment in a
# few bands costs more; a wrong formula or a misplaced sample costs far more
PARITY_DB = 80.0
PARITY_MC = 0.999  # share of (hop, stream, band) with the same leader channel
MDFT_REL = 1e-5    # max |card - cpu| / max |cpu| of one MDFT, float32 FFTs
# a formant voice's gain is the square root of a ratio of envelope values;
# the envelope comes out of an FFT, whose rounding floor sits ~1e-7 below
# its peak, so the ratio of two small values moves by percent (the card's
# formulas run on the CPU stay above this gate:
# tests/test_torch_fast_engine.py::test_card_arithmetic_within_chip_smoke_gates)
FORMANT_PARITY_DB = 45.0
# each engine's record_function ranges (the pool's host-side packing of
# the step's controls, then the step's stages), with the kernels each launches
# (the profiler does not link a kernel launched through ctypes to its range)
STAGES = {
    "fidelity": {"pool.pack": (),
                 "fidelity.analyse": ("frames_windowed",),
                 "fidelity.chain_inputs": ("comp_cumsum", "frac_gather", "chainfetch"),
                 "fidelity.hop_loop": ("band_chain",),
                 "fidelity.synthesis": ()},
    "fast": {"pool.pack": (),
             "fast.analyse": ("frames_windowed",),
             "fast.hop_factors": ("banded_interp",),
             "fast.rotation_scan": (),
             "fast.synthesis": ()},
}
# the kernels each served pool launches every step, and how often; every
# other count must stay 0 (the fused route trades the two frac_gather
# launches for one chainfetch; H launches of the band chain)
PER_STEP = {
    "preset": {"frames_windowed": 1, "comp_cumsum": 1, "frac_gather": 2, "band_chain": 8},
    "preset-fused": {"frames_windowed": 1, "comp_cumsum": 1, "chainfetch": 1, "band_chain": 8},
    "kiosk": {"frames_windowed": 1, "comp_cumsum": 1, "frac_gather": 2, "band_chain": 4},
    "fast": {"frames_windowed": 1, "banded_interp": 1},
}
KERNELS = {
    # name: (source, the TPU kernel's pl.pallas_call it replaces, the pool
    # whose first captured operands the result line reports)
    "frames_windowed": ("bauklank_tpu_torch/csrc/frames.cu",
                        "bauklank_tpu/ops/pallas/frames.py:122", "preset"),
    "comp_cumsum": ("bauklank_tpu_torch/csrc/compsum.cu",
                    "bauklank_tpu/ops/pallas/compsum.py:103", "preset"),
    "frac_gather": ("bauklank_tpu_torch/csrc/frac_gather.cu",
                    "bauklank_tpu/ops/pallas/wintaps.py:129", "preset"),
    "band_chain": ("bauklank_tpu_torch/csrc/bandchain.cu",
                   "bauklank_tpu/ops/pallas/bandchain.py:149", "preset"),
    "banded_interp": ("bauklank_tpu_torch/csrc/interp.cu",
                      "bauklank_tpu/ops/pallas/interp.py:110", "fast"),
    "pallas_gather": ("bauklank_tpu_torch/csrc/frac_gather.cu",
                      "bauklank_tpu/ops/pallas/selection.py:87", "preset"),
    "chainfetch": ("bauklank_tpu_torch/csrc/chainfetch.cu",
                   "bauklank_tpu/ops/pallas/chainfetch.py:114", "preset-fused"),
}
# the H100 SXM's published peaks (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores, which none of the kernels use
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per output, counted from each plain version
# (band_chain: per band and stream, 26 for the leader plus 25 a channel)
OPS_PER_OUTPUT = {"frames_windowed": 1, "comp_cumsum": 10, "frac_gather": 3,
                  "banded_interp": 3, "pallas_gather": 3, "chainfetch": 3}
# the dependent float32 operations one step of a chain waits on (one
# band of the band chain, one TwoSum of the compensated sum), each at
# least the 4-cycle latency of a float32 add or multiply
CHAIN_DEPTH = {"band_chain": 19, "comp_cumsum": 7}
DEP_CYCLES = 4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    """The card's highest SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def capture_operands(store: dict, engine: str):
    """Record the first operands each kernel wrapper gets on the main path
    (the engine modules hold the wrappers by name).  frac_gather keeps its
    first two call shapes (the five-family and the prev|energy gather),
    banded_interp its first three (the spectra, and with formants on the
    natural and the target envelope)."""
    from bauklank_tpu_torch.engine import core, fidelity, spectral
    from bauklank_tpu_torch.ops import pitchmap

    if engine == "fidelity":
        sites = [(fidelity, "frames_windowed"), (spectral, "comp_cumsum"),
                 (spectral, "frac_gather"), (spectral, "chainfetch"),
                 (spectral, "band_chain")]
    else:
        sites = [(core, "frames_windowed"), (pitchmap, "banded_interp")]
    keep = {"frac_gather": 2, "banded_interp": 3}
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def recorder(name, fn):
        def call(*args):
            calls = store.setdefault(name, [])
            if len(calls) < keep.get(name, 1):
                calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
            return fn(*args)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, recorder(name, fn))
    try:
        yield store
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def chainfetch_switch(on: bool):
    """The JAX package's switch for the fused six-family fetch, set for
    the steps inside the block."""
    old = os.environ.get("BAUKLANK_CHAINFETCH")
    os.environ["BAUKLANK_CHAINFETCH"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["BAUKLANK_CHAINFETCH"]
        else:
            os.environ["BAUKLANK_CHAINFETCH"] = old


def make_pool(kind: str, device: str):
    """The fidelity preset serving pool (S=128, H=8, 120/30 ms; "preset"
    and "preset-fused" build the same pool, the latter is stepped with the
    fused fetch switched on), the
    fidelity kiosk pool (S=64, H=4, StretchConfig(8820, 8820) as the
    unified pool builds it) or the fast preset pool (S=128, H=32,
    120/30 ms, bench.py's fast shape), with tonal tracks loaded, voices
    started and a few ``set`` messages applied."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from golden_wasm import material

    from bauklank_tpu_torch.engine.config import StretchConfig
    from bauklank_tpu_torch.serve import protocol
    from bauklank_tpu_torch.serve.pool import StreamPool

    if kind in ("preset", "preset-fused", "fast"):
        if kind != "fast":
            pool = StreamPool(capacity=128, hops_per_step=8, engine="fidelity", device=device)
        else:
            pool = StreamPool(capacity=128, hops_per_step=32, engine="fast", device=device)
        rates = np.linspace(0.5, 2.0, 128)
        tones = np.linspace(-12.0, 12.0, 128)[np.random.default_rng(0).permutation(128)]
    else:
        pool = StreamPool(capacity=64, hops_per_step=4, engine="fidelity", device=device,
                          config=StretchConfig(block=8820, interval=8820))
        rates = np.full(64, 0.001)
        tones = np.zeros(64)
    x = material.case_input(1.0, 2, seconds=6.0)[:, : int(6 * SR)]
    for i in range(pool.capacity):
        name = f"s{i:02d}"
        pool.load_track(name, np.roll(x, 1009 * i, axis=-1))
        pool.start(name, rate=float(rates[i]), semitones=float(tones[i]))
    keys = {"tone": "semitones", "volume": "volumePercent"}  # the server's mapping
    for line in (
        '{"type": "set", "channel": "s00", "key": "rate", "value": 0.75}',
        '{"type": "set", "channel": "s01", "key": "tone", "value": -7}',
        '{"type": "set", "channel": "s02", "key": "volume", "value": 40}',
        '{"type": "set", "channel": "s03", "key": "pan", "value": -0.5}',
    ):
        msg = protocol.parse_line(line)
        if not pool.apply_set(msg["channel"], keys.get(msg["key"], msg["key"]), msg["value"]):
            raise RuntimeError(f"set message refused: {line}")
    return pool


def _taps_needed(pos, bins: int) -> int:
    """Distinct (row, input band) pairs that linear interpolation at
    ``pos`` [N, K] reads: floor(p) and floor(p) + 1 inside [0, bins)."""
    import torch

    i0 = torch.floor(pos).to(torch.int64)
    taps = torch.cat([i0, i0 + 1], dim=1)
    taps = torch.where((taps >= 0) & (taps < bins), taps, bins)
    mask = torch.zeros((pos.shape[0], bins + 1), dtype=torch.bool, device=pos.device)
    mask.scatter_(1, taps, True)
    return int(mask[:, :bins].sum())


def _samples_needed(starts, block: int, t_n: int) -> int:
    """Distinct samples of each stream inside [0, t_n) that frames of
    ``block`` samples at ``starts`` [S, F] cover."""
    import torch

    lo = torch.sort(starts.to(torch.int64), dim=1).values
    hi = (lo + block).clamp(0, t_n)
    lo = lo.clamp(0, t_n)
    covered = torch.cat([torch.zeros_like(hi[:, :1]), torch.cummax(hi, dim=1).values[:, :-1]], 1)
    return int((hi - torch.maximum(lo, covered)).clamp_min(0).sum())


def _five_positions(ib, us, ul, step, long_step: int):
    """The five-family position table [N, 5B] that kernel 7 forms from its
    three tables and ``step``: what the two gathers it replaces are given."""
    import torch

    c = step[:, None]
    return torch.cat([ib, ib - c, ib - float(long_step) * c, us, ul], dim=1)


def bound(name: str, args) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, operations): the least time the card
    could take for this call, the larger of its bytes over the memory rate
    and its float32 operations over the float32 rate.  Bytes count each
    input element the function needs once (for a gather, the taps these
    positions address; for the frame fetch, the samples these frames
    cover) and each output once."""
    if name == "frames_windowed":
        audio, starts, window = args
        s_n, c_n, t_n = audio.shape
        out = s_n * starts.shape[1] * c_n * window.shape[0]
        need = _samples_needed(starts, window.shape[0], t_n) * c_n + starts.numel() + window.numel()
    elif name == "comp_cumsum":
        out = 2 * args[0].numel()
        need = args[0].numel()
    elif name == "chainfetch":
        spec, prev, energy, ib, us, ul, step, long_step = args
        pos5 = _five_positions(ib, us, ul, step, long_step)
        out = ib.numel() * (5 * spec.shape[2] + prev.shape[2] + energy.shape[2])
        need = (_taps_needed(pos5, spec.shape[1]) * spec.shape[2]
                + _taps_needed(ib, spec.shape[1]) * (prev.shape[2] + energy.shape[2])
                + 3 * ib.numel() + step.numel())
    elif name in ("frac_gather", "pallas_gather"):
        planes, pos = args
        out = pos.numel() * planes.shape[2]
        need = _taps_needed(pos, planes.shape[1]) * planes.shape[2] + pos.numel()
    elif name == "banded_interp":
        x, pos = args[0], args[1]
        out = pos.numel() * x.shape[1]
        need = _taps_needed(pos, x.shape[2]) * x.shape[1] + pos.numel()
    else:  # band_chain
        lead, chan = args[0], args[1]
        out = chan.shape[0] * 2 * lead.shape[1] * lead.shape[2]
        need = lead.numel() + chan.numel()
    if name == "band_chain":
        ops = lead.shape[1] * lead.shape[2] * (26 + 25 * chan.shape[0])
    else:
        ops = OPS_PER_OUTPUT[name] * (args[0].numel() if name == "comp_cumsum" else out)
    nbytes = 4 * (need + out)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def library_call(name: str, args):
    """One PyTorch call computing the same function, or None: for the
    linear-interpolation gathers, ``grid_sample`` along one axis (bilinear
    on a height-1 image, zeros outside, ``align_corners=True`` so that
    grid -1..1 spans bands 0..bins-1).  Timed beside the kernel, used
    nowhere in the port.  Returns (call, to the kernel's layout)."""
    import torch
    import torch.nn.functional as F

    if name == "banded_interp":
        img, pos = args[0][:, :, None, :], args[1]                       # [S, P, 1, bins]
        layout = lambda y: y[:, :, 0]
    elif name in ("frac_gather", "pallas_gather"):
        img, pos = args[0].permute(0, 2, 1)[:, :, None, :], args[1]       # [N, P, 1, B]
        layout = lambda y: y[:, :, 0].transpose(1, 2)
    elif name == "chainfetch":
        # its two outputs are two such calls, timed together
        spec, prev, energy, ib, us, ul, step, long_step = args
        pos5 = _five_positions(ib, us, ul, step, long_step)
        five, layout = library_call("frac_gather", (spec, pos5))
        comb, _ = library_call("frac_gather", (torch.cat([prev, energy], dim=2), ib))
        return (lambda: (five(), comb())), (lambda y: layout(y[0]))
    else:
        return None
    gx = pos * (2.0 / (img.shape[-1] - 1)) - 1.0
    grid = torch.stack([gx, torch.zeros_like(gx)], dim=-1)[:, None]    # [N, 1, K, 2]
    return (lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                  align_corners=True)), layout


def compare_kernels(ops: dict, tag: str, results: dict, mhz: float) -> None:
    """Each captured kernel call against its plain version on the card,
    with its time, its plain version's, its bound and, where there is
    one, the library call's."""
    import torch

    from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
    from bauklank_tpu_torch.kernels.chainfetch import chainfetch, chainfetch_ref
    from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
    from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
    from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref, pallas_gather
    from bauklank_tpu_torch.kernels.interp import banded_interp, banded_interp_ref

    pairs = {
        "frames_windowed": (frames_windowed, frames_windowed_ref),
        "comp_cumsum": (comp_cumsum, comp_cumsum_ref),
        "frac_gather": (frac_gather, frac_gather_ref),
        "band_chain": (band_chain, band_chain_ref),
        "banded_interp": (banded_interp, banded_interp_ref),
        "pallas_gather": (pallas_gather, frac_gather_ref),
        "chainfetch": (chainfetch, chainfetch_ref),
    }
    for name, calls in ops.items():
        kern, ref = pairs[name]
        for j, args in enumerate(calls):
            got, want = kern(*args), ref(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            if name == "chainfetch":
                # and against the two launches it replaces
                spec, prev, energy, ib, us, ul, step, long_step = args
                pos5 = _five_positions(ib, us, ul, step, long_step)
                two = (frac_gather(spec, pos5),
                       frac_gather(torch.cat([prev, energy], dim=2), ib))
                if not all(torch.equal(g, t) for g, t in zip(got, two)):
                    raise AssertionError(f"chainfetch ({tag}) differs from the two frac_gather "
                                         "launches it replaces")
            ms = cuda_ms(lambda: kern(*args), reps=20, warm=2)
            plain_reps = 2 if name in ("band_chain", "comp_cumsum") else 10
            plain_ms = cuda_ms(lambda: ref(*args), reps=plain_reps, warm=1)
            bound_ms, bound_by, nbytes, nops = bound(name, args)
            if name in CHAIN_DEPTH:
                # a chain's operations wait on each other: its operations
                # bound is the dependent chain's latency where that is longer
                steps = args[0].shape[1]
                chain_ms = steps * CHAIN_DEPTH[name] * DEP_CYCLES / (mhz * 1e3)
                log(f"[bound] {tag} {name}#{j}: dependent chain {steps} steps x "
                    f"{CHAIN_DEPTH[name]} ops x {DEP_CYCLES} cycles at {mhz:.0f} MHz = "
                    f"{chain_ms:.4f} ms")
                if chain_ms > bound_ms:
                    bound_ms, bound_by = chain_ms, "operations"
            lib = library_call(name, args)
            lib_ms, lib_note = None, ""
            if lib is not None:
                call, layout = lib
                lib_err = float((layout(call()) - got[0]).abs().max() / got[0].abs().max())
                lib_ms = cuda_ms(call, reps=10, warm=1)
                what = "two grid_sample calls" if name == "chainfetch" else "grid_sample"
                lib_note = f", {what} {lib_ms:.4f} ms (rel. diff {lib_err:.2e})"
            shapes = " ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))
            log(f"[kernel] {tag} {name}#{j} {shapes}: max_abs_err={err!r} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_note}; bound {bound_ms:.4f} ms "
                f"by {bound_by} ({nbytes / 1e6:.1f} MB, {nops / 1e6:.1f} Mop; "
                f"{bound_ms / ms:.1%} of it reached)")
            if not finite or err > TOLERANCE:
                raise AssertionError(f"{name} ({tag}) disagrees with its plain version: {err}")
            if tag == KERNELS[name][2] and j == 0:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": lib_ms}


def _snr(ref, got) -> float:
    """10 log10(sum |ref|^2 / sum |ref - got|^2) over a whole tensor."""
    import torch

    wide = torch.complex128 if ref.is_complex() else torch.float64
    ref, got = ref.detach().cpu().to(wide), got.detach().cpu().to(wide)
    err = float((ref - got).abs().square().sum())
    return float("inf") if err == 0 else float(10 * np.log10(float(ref.abs().square().sum()) / err))


def _to_cuda(tree):
    """A tensor, named tuple, dict or tuple of them, moved to the card."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cuda()
    if hasattr(tree, "_fields"):
        return type(tree)(*map(_to_cuda, tree))
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return type(tree)(map(_to_cuda, tree))


def device_parity() -> None:
    """Each stage of the step on the card against the same stage on the
    host CPU, both fed the CPU's inputs to that stage: four streams (rates
    0.5, 1.3, 0.25, 0.001; the last inactive) from a mid-stream state, in
    the small test geometries and the preset one; then with formant voices
    (the formant trackers compared too), and as a live (coupled) chunk,
    whose audio is the rolled input ring.  Fed its own inputs the
    card would drift from the CPU within a few hops, as any one-ulp change
    does (the renderer is chaotic, docs/WASM-ALGO.md "Sensitivity"); stage
    by stage its error stays at the rounding level, which is what the
    bounds hold."""
    import torch

    from golden_wasm import material

    from bauklank_tpu_torch.engine import fidelity as fid
    from bauklank_tpu_torch.engine import spectral
    from bauklank_tpu_torch.ops import mdft

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 2, 6144)).astype(np.float32))
    want = mdft.mdft(x)
    got = mdft.mdft(x.cuda()).cpu()
    rel = float((got - want).abs().max() / want.abs().max())
    back = float((mdft.imdft(want.cuda(), 6144).cpu() - mdft.imdft(want, 6144)).abs().max()
                 / x.abs().max())
    log(f"[parity] mdft [4, 2, 6144] card vs cpu: rel err {rel!r}, imdft {back!r} "
        f"(bound {MDFT_REL})")
    if not (rel <= MDFT_REL and back <= MDFT_REL):
        raise AssertionError(f"mdft on the card disagrees with the CPU: {rel}, {back}")

    rates, tones = (0.5, 1.3, 0.25, 0.001), (-12.0, 0.0, 7.0, 0.0)
    active = np.asarray([1, 1, 1, 0], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    # formant voices: compensation under the pitch shift and a formant
    # shift (both on auto f0), a shift on an explicit base, a neutral voice
    formant_ctl = tuple(t(np.asarray(v, np.float32)) for v in (
        np.exp2(np.asarray([0.0, 4.0, -5.0, 0.0]) / 12), [1, 0, 1, 0], [0, 0, 200 / SR, 0]))
    for tag, block, interval, split, h, formants, live in (
            ("small", 1024, 256, True, 4, False, False),
            ("small split-off", 1024, 256, False, 4, False, False),
            ("small L=1", 1024, 1024, True, 4, False, False),
            ("small formant voices", 1024, 256, True, 4, True, False),
            ("small live split-off", 1024, 256, False, 4, False, True),
            ("preset", 5292, 1323, True, 8, False, False),
            ("preset formant voices", 5292, 1323, True, 8, True, False),
            ("preset live", 5292, 1323, True, 8, False, True)):
        cfg = fid.SpectralConfig(2, block, interval, formants=formants, split=split)
        src = material.case_input(2.0, 2, seconds=2.0)
        audios = t(np.stack([np.roll(src, 977 * i, axis=-1) for i in range(len(rates))]))
        mult = np.exp2(np.asarray(tones) / 12).astype(np.float32)
        mult, limit, act = (t(v) for v in (
            mult, ((8000 / SR) / np.sqrt(mult)).astype(np.float32), active))
        fctl = formant_ctl if formants else (None, None, None)
        # a mid-stream state: one chunk on the CPU
        if live:
            # the coupled drive: the second chunk's rolled ring is the audio,
            # with constant ends, time factor 1 and the full-window prev
            n = h * interval
            state = fid.init_batched_live_fidelity_state(cfg, h, len(rates), "cpu")
            state, _ = fid.batched_live_fidelity_chunk(cfg, state, audios[..., :n], mult, limit, act)
            chunk = audios[..., n:2 * n]
            (spec, tails, ring0) = state
            state2, emit_cpu = fid.batched_live_fidelity_chunk(cfg, state, chunk, mult, limit, act)
            g_state2, g_emit = fid.batched_live_fidelity_chunk(
                cfg, _to_cuda(state), chunk.cuda(), mult.cuda(), limit.cuda(), act.cuda())
            if not torch.equal(g_state2[2].cpu(), state2[2]):
                raise AssertionError(f"{tag}: the card's input ring differs from the CPU's")
            if not bool(torch.isfinite(g_emit).all()):
                raise AssertionError(f"{tag}: non-finite live chunk on the card")
            whole = _snr(emit_cpu, g_emit)
            audios = state2[2]
            el = audios.shape[-1]
            e = (el - (h - torch.arange(h, dtype=torch.int32)) * interval)[None].expand(
                len(rates), h).contiguous()
            tf = torch.ones(len(rates))
        else:
            ends = t(np.stack([fid.hop_frame_ends(cfg, 2 * h, r, SR, split=split) for r in rates]))
            tf = t(np.asarray([min(1 / r, interval) for r in rates], np.float32))
            (spec, tails), _ = fid.batched_fidelity_chunk(
                cfg, fid.init_batched_fidelity_state(cfg, len(rates), "cpu"), audios,
                ends[:, :h], tf, mult, limit, act, *fctl)
            e = ends[:, h:]

        snr = {}
        cur, prev = fid._analyse_cur_prev(cfg, audios, e, full_prev=live)
        g = fid._analyse_cur_prev(cfg, audios.cuda(), e.cuda(), full_prev=live)
        snr["1 analyses cur"], snr["1 analyses prev"] = _snr(cur, g[0]), _snr(prev, g[1])
        xs, carried = spectral.chain_inputs_hops(cfg, spec, cur, prev, tf, mult, limit, *fctl)
        g_xs, g_carried = spectral.chain_inputs_hops(
            cfg, _to_cuda(spec), cur.cuda(), prev.cuda(), tf.cuda(), mult.cuda(), limit.cuda(),
            *(None if c is None else c.cuda() for c in fctl))
        for k in xs:
            if k != "mc":
                snr[f"2 chain inputs {k}"] = _snr(xs[k], g_xs[k])
        mc_same = float((xs["mc"] == g_xs["mc"].cpu()).double().mean())
        rng_same = bool(torch.equal(carried[0], g_carried[0].cpu()))
        note = ""
        if formants:
            # the formant trackers, and that the voices did move them
            for name, c_ema, g_ema, old in zip(("f_value_ema", "f_weighted_ema"), carried[1:],
                                               g_carried[1:], spec[3:]):
                snr[f"2 chain inputs {name}"] = _snr(c_ema, g_ema)
                if torch.equal(c_ema[:2], old[:2]) or not torch.equal(c_ema[2:], old[2:]):
                    raise AssertionError(f"{tag}: {name} moved for the wrong voices")
            plain, _ = spectral.chain_inputs_hops(cfg, spec, cur, prev, tf, mult, limit)
            note = (f"; the formant gain changes pred_energy by "
                    f"{-_snr(plain['pred_energy'], xs['pred_energy']):.1f} dB relative to it")
        if live:
            note = f"; the whole live chunk, card against CPU from one state: {whole:.2f} dB"
        outs = fid._hop_loop(cfg, spec.prev_output, xs)
        snr["3 hop loop"] = _snr(outs, fid._hop_loop(cfg, spec.prev_output.cuda(), _to_cuda(xs)))
        frames = fid.synthesise_frames(cfg, outs)
        emit, _ = fid._ola_emit(cfg, frames, tails, act, h)
        g_frames = fid.synthesise_frames(cfg, outs.cuda())
        snr["4 synthesis"] = _snr(emit, fid._ola_emit(cfg, g_frames, tails.cuda(), act.cuda(), h)[0])
        worst = {}
        for k, v in snr.items():
            stage = k.split(" ")[0]
            if stage not in worst or v < worst[stage][1]:
                worst[stage] = (k, v)
        log(f"[parity] {tag} (block {block}, interval {interval}, L={cfg.long_step}, "
            f"S={len(rates)}, H={h}) card vs cpu, stage by stage: "
            + "; ".join(f"{k} {v:.2f} dB" for k, v in worst.values())
            + f"; mc equal {mc_same:.6f}, rng equal {rng_same}{note} "
            f"(bounds {PARITY_DB} dB, mc {PARITY_MC})")
        bad = {k: v for k, v in snr.items() if not v >= PARITY_DB}
        if bad or mc_same < PARITY_MC or not rng_same:
            raise AssertionError(f"{tag}: the card's stages disagree with the CPU's: "
                                 f"{bad}, mc {mc_same}, rng {rng_same}")


def fast_parity() -> None:
    """Each stage of the fast engine's chunk on the card against the same
    stage on the host CPU, both fed the CPU's inputs to that stage: four
    streams (rates 0.5, 1.3, 2.0, 0.8; -12, 0, +7, +12 st; the last
    inactive) from a mid-stream state, in the small test geometry and the
    preset one; formants off (the serving pool's usual step), then on
    with one formant voice.  The rotation factors and gains are weighted
    by the magnitude they multiply in the output (a silent band's phase is
    rounding noise on either device and reaches no output).  Then the
    whole 3-chunk render, each device fed its own state."""
    import torch

    from golden_wasm import material

    from bauklank_tpu_torch.engine import core
    from bauklank_tpu_torch.engine.batched import batched_process_chunk, formants_off
    from bauklank_tpu_torch.engine.config import StretchConfig, preset_default
    from bauklank_tpu_torch.engine.offline import frame_ends_for
    from bauklank_tpu_torch.engine.params import StretchParams

    rates, tones, active = (0.5, 1.3, 2.0, 0.8), (-12.0, 0.0, 7.0, 12.0), (1.0, 1.0, 1.0, 0.0)
    src = material.case_input(2.0, 2, seconds=8.0)
    audio = torch.from_numpy(np.stack([np.roll(src, 977 * i, axis=-1)
                                       for i in range(len(rates))]).astype(np.float32))
    g_audio = audio.cuda()
    for tag, cfg, h in (("small", StretchConfig(2, 1024, 256), 8),
                        ("preset", preset_default(2, SR), 16)):
        for formant_voice in (False, True):
            run_cfg = cfg if formant_voice else formants_off(cfg)
            extra = {"formant_semitones": 3.0, "formant_compensation": 1.0}
            params = StretchParams.stack([
                StretchParams.make(active=a, rate=r, semitones=st, device="cpu",
                                   **(extra if formant_voice and i == 1 else {}))
                for i, (r, st, a) in enumerate(zip(rates, tones, active))])
            g_params = StretchParams(*[f.cuda() for f in params])
            ends = [torch.from_numpy(np.stack([
                frame_ends_for(cfg, c * h * cfg.interval, h, r) for r in rates]).astype(np.int32))
                for c in range(4)]
            state, _ = batched_process_chunk(  # a mid-stream state: one chunk on the CPU
                run_cfg, core.fresh_state(run_cfg, len(rates), "cpu"), audio, ends[0], params)
            g_state = core.StretchState(*[x.cuda() for x in state])

            snr = {"1 analyses": _snr(core.analyse(run_cfg, audio, ends[1]),
                                      core.analyse(run_cfg, g_audio, ends[1].cuda()))}
            v, cur_m, gain, reset = core.hop_factors(run_cfg, audio, ends[1], params, state.prev_cur)
            g = core.hop_factors(run_cfg, g_audio, ends[1].cuda(), g_params, g_state.prev_cur)
            mag = torch.sqrt(torch.sum(torch.square(torch.abs(cur_m)), dim=1))   # [S, H, bins]
            snr["2 hop_factors cur_m"] = _snr(cur_m, g[1])
            snr["2 hop_factors v"] = _snr(v * mag, g[0].cpu() * mag)
            snr["2 hop_factors gain"] = _snr(gain[:, 0] * mag, g[2][:, 0].cpu() * mag)
            reset_same = bool(torch.equal(reset, g[3].cpu()))
            rot = core.rotation_scan(state.rot, v, reset)
            snr["3 rotation_scan"] = _snr(rot, core.rotation_scan(g_state.rot, v.cuda(), reset.cuda()))
            emit, tail = core.synthesis(run_cfg, rot, cur_m, gain, state.ola_tail, params.active)
            g_emit, g_tail = core.synthesis(run_cfg, rot.cuda(), cur_m.cuda(), gain.cuda(),
                                            g_state.ola_tail, g_params.active)
            snr["4 synthesis"] = min(_snr(emit, g_emit), _snr(tail, g_tail))
            outs, g_outs = [], []
            for c in (1, 2, 3):
                state, out = batched_process_chunk(run_cfg, state, audio, ends[c], params)
                g_state, g_out = batched_process_chunk(run_cfg, g_state, g_audio, ends[c].cuda(),
                                                       g_params)
                outs.append(out)
                g_outs.append(g_out)
            render = _snr(torch.cat(outs, -1), torch.cat(g_outs, -1))
            label = "formant voice" if formant_voice else "formants off"
            log(f"[parity] fast {tag} {label} (block {cfg.block}, interval {cfg.interval}, "
                f"S={len(rates)}, H={h}) card vs cpu, stage by stage: "
                + "; ".join(f"{k} {v_:.2f} dB" for k, v_ in snr.items())
                + f"; reset equal {reset_same}; 3-chunk render {render:.2f} dB "
                f"(bounds {PARITY_DB} dB, a formant voice's gain and render {FORMANT_PARITY_DB} dB)")
            loose = ("2 hop_factors gain",) if formant_voice else ()
            bad = {k: v_ for k, v_ in snr.items()
                   if not v_ >= (FORMANT_PARITY_DB if k in loose else PARITY_DB)}
            if not render >= (FORMANT_PARITY_DB if formant_voice else PARITY_DB):
                bad["render"] = render
            if bad or not reset_same:
                raise AssertionError(f"fast {tag} {label}: the card's stages disagree with the "
                                     f"CPU's: {bad}, reset equal {reset_same}")


def identity_render(card: str) -> None:
    """The fast engine's offline renderer on the card at rate 1, 0 st, the
    preset geometry: > 50 dB against its input (tests/test_engine.py's bar)."""
    from golden_wasm import material

    from bauklank_tpu_torch.engine.config import preset_default
    from bauklank_tpu_torch.engine.offline import stretch_offline

    cfg = preset_default(2, SR)
    x = material.case_input(1.0, 2, seconds=4.0)
    t0 = time.perf_counter()
    y = stretch_offline(x, 1.0, cfg, device="cuda")
    b = cfg.block
    n = min(x.shape[1], y.shape[1]) - b
    ref, got = x[:, b:n].astype(np.float64), y[:, b:n].astype(np.float64)
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-300))
    log(f"[identity] fast stretch_offline rate 1, 0 st, block {cfg.block}, interval "
        f"{cfg.interval}, {x.shape[1] / SR:.1f} s stereo: {snr:.2f} dB against the input "
        f"({time.perf_counter() - t0:.2f} s) | {card}")
    if not snr > 50.0:
        raise AssertionError(f"identity render {snr:.2f} dB <= 50 dB")


def live_golden(name: str, golden) -> float:
    """A coupled golden case on the card through
    ``batched_live_fidelity_chunk``, input pushed 8 hops a chunk with
    carried state (as tests/test_torch_golden_live.py drives it on the
    CPU); dB against the blob's live render, skipping the latency ramp-in."""
    import torch

    from golden_wasm import material

    from bauklank_tpu_torch.engine import fidelity as fid

    _, semitones, channels, extras = next(c for c in material.LIVE_CASES if c[0] == name)
    geom = material.case_render_kwargs(extras)
    cfg = fid.SpectralConfig(channels, round(geom["block_ms"] / 1000 * SR),
                             round(geom["interval_ms"] / 1000 * SR),
                             split=bool(extras.get("split_computation", True)))
    n_out = int(material.SECONDS * SR)
    x = torch.from_numpy(material.case_input(1.0, channels)[:, :n_out]).cuda()
    hops = 8
    n = hops * cfg.interval
    x = torch.nn.functional.pad(x, (0, -n_out % n))[None]
    mult = float(np.exp2(semitones / 12.0))
    one = lambda v: torch.tensor([v], dtype=torch.float32, device="cuda")
    controls = (one(mult), one((material.TONALITY_HZ / SR) / np.sqrt(mult)), one(1.0))
    state = fid.init_batched_live_fidelity_state(cfg, hops, 1, "cuda")
    emitted = []
    for c in range(x.shape[-1] // n):
        state, emit = fid.batched_live_fidelity_chunk(
            cfg, state, x[..., c * n:(c + 1) * n], *controls)
        emitted.append(emit[0])
    got = torch.cat(emitted, dim=-1)[..., :n_out].cpu().numpy()
    return material.snr_db(golden[name], got, material.case_skip(extras) + cfg.interval)


def step_pool(pool, warm: int, timed: int):
    import torch

    for _ in range(warm):
        pool.step(fetch=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masters = [pool.step(fetch=True)[0] for _ in range(timed)]
    dt = (time.perf_counter() - t0) / timed
    master = np.concatenate(masters, axis=-1)
    if not np.isfinite(master).all():
        raise AssertionError("non-finite master")
    if not np.abs(master).max() > 0:
        raise AssertionError("silent master")
    return dt, master


def where_time_goes(kind: str, pool, steps: int, step_ms: float, card: str) -> None:
    """Profile ``steps`` pool steps: the card's busy share, each stage's
    host and device time (the engine's ``record_function`` ranges), and
    the kernels that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with chainfetch_switch(kind == "preset-fused"), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            pool.step(fetch=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    events = prof.events()
    dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev_events) / steps / 1e3
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[profile] {kind}: device busy {busy:.3f} ms/step; profiled wall {wall:.3f} ms/step "
        f"({busy / wall:.1%} busy); unprofiled step {step_ms:.3f} ms "
        f"({busy / step_ms:.1%} busy) | {card}")
    per_kernel: dict = {}
    for e in dev_events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.self_device_time_total
    for name, own in STAGES[pool.engine].items():
        rows = [e for e in events
                if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
        host = sum(e.cpu_time_total for e in rows) / steps / 1e3
        ops = sum(e.device_time_total for e in rows) / steps / 1e3
        kern = sum(us for k, us in per_kernel.items()
                   if any(f"{o}_kernel" in k for o in own)) / steps / 1e3
        log(f"[profile] {kind} {name}: host {host:.3f} ms/step, device {ops + kern:.3f} "
            f"ms/step (PyTorch ops {ops:.3f}, own kernels {kern:.3f})")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile] {kind} top: {us / steps / 1e3:.3f} ms/step "
            f"({us / steps / 1e3 / busy:.1%}) {name[:90]}")


def serve(kind: str, pool, warm: int, timed: int, card: str, launches: dict):
    """Drive one pool with the launch counts set to 0 just before and read
    just after; fails unless each kernel of the pool's path was launched
    its number of times a step and no other kernel at all.  Adds the
    counts to ``launches`` and returns (ms/step, the timed steps' master)."""
    from bauklank_tpu_torch import kernels

    kernels.reset_launches()
    with chainfetch_switch(kind == "preset-fused"):
        dt, master = step_pool(pool, warm, timed)
    counts = dict(kernels.LAUNCHES)
    want = {k: PER_STEP[kind].get(k, 0) * (warm + timed) for k in counts}
    if counts != want:
        raise AssertionError(f"{kind} pool launched {counts}, not {want}")
    for k, v in counts.items():
        launches[k] += v
    peak = float(np.abs(master).max())
    s_n, h = pool.capacity, pool.hops_per_step
    block, interval, _ = pool._sizes
    rtf = s_n * h * interval / SR / dt
    shape = (f"fft={pool.scfg.fft} L={pool.scfg.long_step}" if pool.engine == "fidelity"
             else f"bands={block // 2}")
    log(f"[serve] {kind} ({pool.engine}): S={s_n} H={h} block={block} interval={interval} "
        f"{shape}: {dt * 1e3:.2f} ms/step, aggregate RTF {rtf:.1f}x, master peak {peak:.4f}, "
        f"launches {counts} | {card}")
    log(f"[serve] {kind} metrics {pool.metrics()}")
    return dt * 1e3, master


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    sys.path.insert(0, ROOT)
    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.kernels import build

    # 1. device
    t_start = time.perf_counter()
    card = card_line()
    mhz = max_sm_mhz()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card} | max SM clock {mhz:.0f} MHz | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.2f} s -> {os.path.relpath(lib_path, ROOT)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")

    # 3. kernels against their plain versions, on main-path operands
    results: dict = {}
    gather_args = None
    for kind in ("preset", "kiosk", "fast"):
        ops: dict = {}
        pool = make_pool(kind, "cuda")
        with capture_operands(ops, pool.engine):
            pool.step(fetch=True)
        compare_kernels(ops, kind, results, mhz)
        if pool.engine == "fidelity":
            # kernel 6, which no step calls, on the call it would serve: the
            # five-family gather
            compare_kernels({"pallas_gather": ops["frac_gather"][:1]}, kind, results, mhz)
        if kind == "preset":
            gather_args = ops["frac_gather"][0]
            # kernel 7: the next step of the same pool with the fused fetch
            ops = {}
            with chainfetch_switch(True), capture_operands(ops, "fidelity"):
                pool.step(fetch=True)
            if set(ops) != {"frames_windowed", "comp_cumsum", "chainfetch", "band_chain"}:
                raise AssertionError(f"the fused step called {sorted(ops)}")
            compare_kernels({"chainfetch": ops["chainfetch"]}, "preset-fused", results, mhz)
        if kind == "fast":
            # the envelope gathers: a step with one formant voice
            ops = {}
            if not pool.apply_set("s05", "formantSemitones", 4.0, lookahead=0.0):
                raise RuntimeError("formant control refused")
            with capture_operands(ops, "fast"):
                pool.step(fetch=True)
            if len(ops["banded_interp"]) != 3:
                raise AssertionError(f"formant step gathered {len(ops['banded_interp'])} times")
            compare_kernels({"banded_interp": ops["banded_interp"][1:]}, "fast-formant",
                            results, mhz)
        del pool, ops
        torch.cuda.empty_cache()

    # 4. each stage of both steps on the card against the host CPU's
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    device_parity()
    fast_parity()

    # 5. golden cases and the identity render on the card
    from golden_wasm import material

    from bauklank_tpu_torch.engine.fidelity import render_fidelity

    golden = np.load(os.path.join(ROOT, "tests", "golden", "golden_v1.npz"))
    for name in ("r05_stp12", "r025_st0", "kiosk_r0001_st0", "r10_fp7"):
        _, rate, st, ch, extras = next(c for c in material.CASES if c[0] == name)
        t1 = time.perf_counter()
        got = render_fidelity(
            material.case_input(rate, ch), SR, int(material.SECONDS * SR), rate=rate,
            semitones=st, tonality_hz=material.TONALITY_HZ,
            seed=int(golden[name + "__seed"]) if name + "__seed" in golden.files else 1,
            device="cuda", **material.case_render_kwargs(extras))
        end = int(extras.get("_compare_sec", material.SECONDS) * SR)
        snr = material.snr_db(golden[name][..., :end], got[..., :end],
                              material.case_skip(extras))
        log(f"[golden] {name}: {snr:.2f} dB ({time.perf_counter() - t1:.2f} s)")
        if not snr > 40.0:
            raise AssertionError(f"golden {name}: {snr:.2f} dB <= 40 dB")
    t1 = time.perf_counter()
    snr = live_golden("live_stp12", golden)
    log(f"[golden] live_stp12 (coupled, 8 hops a chunk): {snr:.2f} dB "
        f"({time.perf_counter() - t1:.2f} s)")
    if not snr > 40.0:
        raise AssertionError(f"golden live_stp12: {snr:.2f} dB <= 40 dB")
    identity_render(card)

    # 6. serving: each pool's main path, with its launch counts
    kinds = ("preset", "preset-fused", "kiosk", "fast")
    timed = {"preset": 10, "preset-fused": 10, "kiosk": 6, "fast": 6}
    pools = {kind: make_pool(kind, "cuda") for kind in kinds}
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    served = {kind: serve(kind, pool, 2, timed[kind], card, launches)
              for kind, pool in pools.items()}
    step_ms = {kind: ms for kind, (ms, _) in served.items()}
    # the fused fetch is bit-equal, so the same tracks and controls give the same master
    if not np.array_equal(served["preset"][1], served["preset-fused"][1]):
        diff = float(np.abs(served["preset"][1] - served["preset-fused"][1]).max())
        raise AssertionError(f"the fused pool's master differs from the unfused pool's by {diff}")
    log(f"[serve] preset-fused master equals preset's bit for bit over "
        f"{served['preset'][1].shape[-1]} samples")
    # the fidelity preset pool with a formant voice: the envelope lookup is a
    # third frac_gather launch a step; the fast pool: three gathers a step
    for kind, per_step in (("preset", {**PER_STEP["preset"], "frac_gather": 3}),
                           ("fast", {**PER_STEP["fast"], "banded_interp": 3})):
        pool = pools[kind]
        if not pool.apply_set("s05", "formantSemitones", 4.0, lookahead=0.0):
            raise RuntimeError("formant control refused")
        kernels.reset_launches()
        t0 = time.perf_counter()
        masters = [pool.step(fetch=True)[0] for _ in range(5)]
        dt = (time.perf_counter() - t0) / 5
        counts = dict(kernels.LAUNCHES)
        if not np.isfinite(np.concatenate(masters, axis=-1)).all():
            raise AssertionError(f"non-finite {kind} master with a formant voice")
        if counts != {k: 5 * per_step.get(k, 0) for k in counts}:
            raise AssertionError(f"{kind} formant steps launched {counts}, not 5 x {per_step}")
        if kind == "preset" and not float(pool.states[0].f_value_ema[5]) > 0:
            raise AssertionError("the formant voice's f0 tracker did not move")
        for k, v in counts.items():
            launches[k] += v
        log(f"[serve] {kind} with a formant voice: {dt * 1e3:.2f} ms/step over 5 steps, "
            f"launches {counts} | {card}")
        # back to no formant voice before the profile
        pool.apply_set("s05", "formantSemitones", 0.0, lookahead=0.0)
        pool.step(fetch=True)
    # kernel 6 is on no step's path in either package: driven directly, once,
    # through its entry point, on the preset pool's five-family operands
    from bauklank_tpu_torch.ops.gather import pallas_gather

    kernels.reset_launches()
    out = pallas_gather(*gather_args)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if counts != {**dict.fromkeys(counts, 0), "pallas_gather": 1}:
        raise AssertionError(f"the direct pallas_gather call launched {counts}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite pallas_gather output")
    launches["pallas_gather"] += 1
    log(f"[serve] pallas_gather (on no pool's path; called directly on "
        f"{tuple(gather_args[0].shape)} at {tuple(gather_args[1].shape)}): launches {counts}")
    del gather_args, out

    # 7. where the time goes
    for kind, pool in pools.items():
        where_time_goes(kind, pool, 5, step_ms[kind], card)
    del pools, pool
    torch.cuda.empty_cache()

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep, _) in KERNELS.items()]}))
    log(f"[time] {time.perf_counter() - t_start:.1f} s from the device check to the result")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
