#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bauklank_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero without the result line):

1. device: the card's name and power limit, TF32 off;
2. build the eight CUDA kernels from ``bauklank_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, on operands
   captured from one step of the fidelity preset serving pool (S=128,
   H=8, 120/30 ms), of the same pool with the fused fetch switched on
   (``BAUKLANK_CHAINFETCH=1``: kernel 7, also held bit-equal to the two
   frac_gather launches it replaces), of the fidelity kiosk pool (S=64,
   H=4, 200/200 ms, rate 0.001) and of the fast preset pool (S=128, H=32,
   120/30 ms; the envelope gathers from a step with one formant voice; so
   is the fidelity formant chain's one-plane gather), with both times,
   the least time the card could take (``bound``) and,
   where one PyTorch call computes the same function, that call's time;
   ``pallas_gather``, which no step calls, on the fidelity pools'
   five-family operands; the interleaved-complex entry point of
   ``banded_interp`` also against the planar one on the stacked copy of its
   rows (bit-equal), which is what ``grid_sample`` is timed on; the two
   sequential kernels (``band_chain``, ``comp_cumsum``) also timed with
   their operands left in the L2, the band chain's branch-free
   ``sqrt(a / b)`` held to the library's rounding on 2^30 random pairs, and
   the cycles one band's step takes from registers (what its loop could
   reach at best; the band chain's second bound); the frame fetch
   (kernel 1) in both forms, the plain rows and the rows padded to the
   fidelity FFT size, at each pool's shape and at the front door's two
   fidelity bucket shapes (S=64, two frames a stream, block 5376 and 9216);
   the stage-2 smoother pair (kernel 8) also at the one-hop cell's rows
   (the preset's first 64) and at 512 kiosk rows, and in its per-row
   coefficient form on the formant step's envelope;
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
   pool and read after it; the two fidelity pools again with the analysis
   on the plain frame rows padded by PyTorch (as before kernel 1 wrote
   padded rows), their masters held equal bit for bit; then 5 steps of
   the fidelity preset pool and of the fast pool with a formant voice, and
   ``pallas_gather`` driven directly, once;
7. where the time goes: the pools of both engines replay their step
   graphs (``serve/graphs.py``): each one's untraced step time with
   graphs, its ``graph_replays / steps``, and an eager twin (the same
   pool with its graphs taken off, as it stepped before the graphs),
   timed in the same call, whose master must equal the served one bit
   for bit, and every op under the twin's analysis (which must hold no
   pad); then
   a ``torch.profiler`` run of 5 more steps of each pool, split by the
   step's stages (host and device time each), the PyTorch ops that take
   most device time inside the gather stage, each kernel of the pool's
   path seen to run its number of times a step, and the card's busy
   share;
8. the serving front door, as ``serve/server.py`` builds it: a
   ``UnifiedPool`` with pipelined fetch for each engine (fidelity: 64
   preset and 64 kiosk file voices and 16 live ones; fast: 32, 32 and 8;
   every bucket grown from 4 by doubling), 4 s of master in 30 ms quanta
   with the quantum's host time and each bucket's launches, a twin with
   blocking fetch whose master must be equal bit for bit (the fidelity
   twin's analysis on the plain frame rows padded by PyTorch), ``analyze`` of a
   file and a live voice, and ``save_unified``/``load_unified`` resumed
   bit for bit; a fidelity and a fast ``StretchNode`` at the kiosk
   configure and a fidelity node at ``configure(block=2048, interval=64)``
   (long_step 32); the band chain at long_step 32, 24 and 40 (the general
   form) and the two sequential kernels at S = 4 and 8, each against its
   plain version.  The launch counts are set to 0 before each pool or
   node and read after it;
9. the server and the CLI as a user starts them: ``stretch`` through
   ``bauklank_tpu_torch.cli.main`` in this process and as ``python3 -m
   bauklank_tpu_torch`` (a 30 s stereo tone and noise from ``--seed``,
   rate 0.5, -12 st, 20 s out), the two files equal bit for bit, both
   >= 80 dB against ``stretch_offline`` on the card, dominant 220 Hz; then
   the ``ControlServer`` as ``serve/server.py:main`` builds it
   (``build_parser``, ``build_server``) for ``--pool stream|unified`` x
   ``--engine fast|fidelity`` at ``--engine-count 2 --pool-capacity 2``:
   30 s tracks in A (rate 0.001, -5 st) and B (rate 0.5, +7 st), an audio
   sink 0.25 s ahead, a FakeController turning a knob every 0.5 s and,
   where ``websockets`` imports, a WebSocket client sending sets and one
   ``analyze`` through ``ControlServer.run()``, for 6 s each: every set
   must reach the pool, the master be finite and not silent, the reply
   carry the JAX server's keys, no task restart, the engine's kernels
   launched on the card; it prints the step times against the 30 ms hop,
   the least lead of the render loop and the underruns;
10. the parallel paths (``parallel/``) and the per-hop forms: at world
   size 1 on NCCL in this process, ``sharded_step`` at the fast pool's
   shape (S=128, H=32), ``sharded_fidelity_step`` at the preset (S=128,
   H=8; a formant run too) and ``sharded_live_fidelity_step`` (S=64,
   H=8), two steps each, held bit-equal to the unsharded step and timed
   beside it; ``stretch_offline_sharded`` on a (1, 1) mesh, 8 streams of
   60 s (2,000 hops, formants), each > 45 dB after the first block against
   ``stretch_offline`` on the card, with its wall time and aggregate RTF;
   then four spawned ranks on gloo sharing the card (joined under a
   deadline): the render on a 2 x 2 mesh (4 streams, 20 s) > 45 dB the
   same way, and the preset fidelity step over a four-rank stream mesh
   (32 streams a rank) against the unsharded step, bit-equal or >= 80 dB a
   voice; last ``batched_fidelity_chunk_scan`` against
   ``batched_fidelity_chunk`` at the preset, chunk by chunk from one state
   (JAX's bars: emit within 2e-4, state within 2e-4 relative and absolute,
   the MINSTD state equal), with both step times and launch counts.  Every
   path's launches are counted from 0 and join the kernels line.

It prints one JSON line of per-kernel results, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  It needs CUDA; without a card
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import re
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
                 "fidelity.chain_inputs": ("smooth_pair", "comp_cumsum", "frac_gather",
                                           "chainfetch"),
                 "fidelity.hop_loop": ("band_chain",),
                 "fidelity.synthesis": ()},
    "fast": {"pool.pack": (),
             "fast.analyse": ("frames_windowed",),
             "fast.hop_factors": ("banded_interp",),
             "fast.rotation_scan": (),
             "fast.synthesis": ()},
}
# the stage whose PyTorch ops the profile lists one by one: the one around
# this engine's gather kernels
GATHER_STAGE = {"fidelity": "fidelity.chain_inputs", "fast": "fast.hop_factors"}
# the kernels each served pool launches every step, and how often; every
# other count must stay 0 (the fused route trades the two frac_gather
# launches for one chainfetch; H launches of the band chain)
PER_STEP = {
    "preset": {"frames_windowed": 1, "smooth_pair": 1, "comp_cumsum": 1, "frac_gather": 2,
               "band_chain": 8},
    "preset-fused": {"frames_windowed": 1, "smooth_pair": 1, "comp_cumsum": 1, "chainfetch": 1,
                     "band_chain": 8},
    "kiosk": {"frames_windowed": 1, "smooth_pair": 1, "comp_cumsum": 1, "frac_gather": 2,
              "band_chain": 4},
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
    "smooth_pair": ("bauklank_tpu_torch/csrc/smooth.cu",
                    "none (bauklank_tpu/engine/spectral.py:_smooth_bidirectional x2, "
                    "lax.associative_scan)", "preset"),
}
# the H100 SXM's published peaks (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores, which none of the kernels use
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per output, counted from each plain version
# (band_chain: per band and stream, 26 for the leader plus 25 a channel;
# smooth_pair: in each of its four scans the pre-multiply, a multiply and
# an add up the tree and down it, and the carry's multiply and add)
OPS_PER_OUTPUT = {"frames_windowed": 1, "comp_cumsum": 10, "frac_gather": 3,
                  "banded_interp": 3, "banded_interp_complex": 3, "pallas_gather": 3,
                  "chainfetch": 3, "smooth_pair": 28}
# the dependent float32 operations one step of a chain waits on (one
# band of the band chain, one TwoSum of the compensated sum), each at
# least the 4-cycle latency of a float32 add or multiply.  The band
# chain's 19 counts its divide and its square root as one operation each
# and only the leader's pair; the card runs each as a reciprocal (or
# reciprocal root) of 17-19 cycles and 3-5 dependent multiply-adds, twice
# a band (leader, then follower), so a band's step read from registers
# takes 232 cycles, not 76 (PERF.md section 6).  The bound is left as it
# was: it is a floor, and the rows keep one yardstick.  Beside it phase 3
# prints a second bound, the band's step read from registers
# (band_step_cycles), so that the share of the first is not read as
# headroom.  The smoother pair's steps are not bands but tree levels, a
# multiply and an add each: 2 floor(log2 B) + 2 a scan (the pre-multiply
# and the carry's pair count as a level), four scans (chain_steps).
CHAIN_DEPTH = {"band_chain": 19, "comp_cumsum": 7, "smooth_pair": 2}
DEP_CYCLES = 4


def chain_steps(name: str, args) -> int:
    """The dependent steps of one of the CHAIN_DEPTH kernels' calls."""
    b_n = args[0].shape[1]
    return 4 * (2 * (b_n.bit_length() - 1) + 2) if name == "smooth_pair" else b_n
# set once in main: the nvidia-smi name and power limit that label every
# reading, and band_step_cycles()'s reading, the band chain's second bound
CARD = ""
STEP_CYCLES: dict = {}


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


# device work queued ahead of a timed run: passes over a 256 MB buffer,
# ~0.17 ms each at the card's memory rate
STALL_PASSES = 24
L2_BYTES = 50e6


@functools.lru_cache(maxsize=1)
def _stall_buffer():
    import torch

    return torch.zeros(64 << 20, dtype=torch.float32, device="cuda")


def cold_sets(args, nbytes: int) -> list:
    """``args`` and enough copies of its tensors that a run cycling through
    them moves three L2 sizes before it meets a set again: a call whose
    operands and result would fit the 50 MB L2 is then timed against device
    memory, as the step's call finds them, not against the cache."""
    copies = 0 if nbytes >= 3 * L2_BYTES else min(int(3 * L2_BYTES // nbytes), 15)
    clone = lambda a: a.clone() if hasattr(a, "clone") else a
    return [args] + [tuple(map(clone, args)) for _ in range(copies)]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events).  A
    few milliseconds of other device work are queued first, so that the
    host has the launches enqueued before the card reaches them: a call
    shorter than its wrapper's host time (~30 us) is then timed on the
    card, not on the host."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(STALL_PASSES):
        _stall_buffer().add_(1.0)
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
    first three call shapes (the five-family and the prev|energy gather
    and, with a formant voice, the envelope lookup), smooth_pair its two
    (with a formant voice: the envelope's, then the peaks map's),
    banded_interp its two
    entry points' (the complex spectra; with formants on the natural and
    the target envelope)."""
    from bauklank_tpu_torch.engine import core, fidelity, spectral
    from bauklank_tpu_torch.ops import pitchmap

    if engine == "fidelity":
        sites = [(fidelity, "frames_windowed"), (spectral, "smooth_pair"),
                 (spectral, "comp_cumsum"),
                 (spectral, "frac_gather"), (spectral, "chainfetch"),
                 (spectral, "band_chain")]
    else:
        sites = [(core, "frames_windowed"), (pitchmap, "banded_interp"),
                 (pitchmap, "banded_interp_complex")]
    keep = {"frac_gather": 3, "banded_interp": 2, "smooth_pair": 2}
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


@contextlib.contextmanager
def plain_frame_rows():
    """The fidelity analysis as it ran before kernel 1 wrote padded rows:
    the plain frame fetch, then PyTorch's pad to the FFT size."""
    import torch

    from bauklank_tpu_torch.engine import fidelity
    from bauklank_tpu_torch.kernels.frames import frames_windowed

    def plain_then_pad(audio, starts, window, pitch=None):
        rows = frames_windowed(audio, starts, window)
        return rows if pitch is None else torch.nn.functional.pad(
            rows, (0, pitch - window.shape[0]))

    saved = fidelity.frames_windowed
    fidelity.frames_windowed = plain_then_pad
    try:
        yield
    finally:
        fidelity.frames_windowed = saved


def make_pool(kind: str, device: str):
    """The fidelity preset serving pool (S=128, H=8, 120/30 ms; "preset"
    and "preset-fused" build the same pool, the latter is stepped with the
    fused fetch switched on), the
    fidelity kiosk pool (S=64, H=4, block and interval 8820 unrounded, as
    the kiosk's deployment runs it) or the fast preset pool (S=128, H=32,
    120/30 ms, bench.py's fast shape), with tonal tracks loaded, voices
    started and a few ``set`` messages applied."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from golden_wasm import material

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
                          block=8820, interval=8820)
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


def _pitch(args) -> int:
    """The row pitch of a frame fetch: its fourth argument, else the block."""
    return args[3] if len(args) > 3 and args[3] is not None else args[2].shape[0]


def frame_forms(args) -> list:
    """Kernel 1's call as the path made it, and its other form: the plain
    rows (pitch = block, the fast engine's) and rows of the fidelity FFT
    size for this block with a zero tail (the fidelity analysis's)."""
    from bauklank_tpu_torch.engine.spectral import SpectralConfig

    audio, starts, window = args[:3]
    plain = (audio, starts, window)
    padded = plain + (SpectralConfig(audio.shape[1], window.shape[0], 1).fft,)
    return [args, plain if len(args) > 3 else padded]


def bound(name: str, args) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, operations): the least time the card
    could take for this call, the larger of its bytes over the memory rate
    and its float32 operations over the float32 rate.  Bytes count each
    input element the function needs once (for a gather, the taps these
    positions address; for the frame fetch, the samples these frames
    cover) and each output once."""
    if name == "frames_windowed":
        audio, starts, window = args[:3]
        s_n, c_n, t_n = audio.shape
        out = s_n * starts.shape[1] * c_n * _pitch(args)
        need = _samples_needed(starts, window.shape[0], t_n) * c_n + starts.numel() + window.numel()
    elif name == "comp_cumsum":
        out = 2 * args[0].numel()
        need = args[0].numel()
    elif name == "smooth_pair":
        e, coef = args
        out = e.numel()
        need = e.numel() + (coef.numel() if hasattr(coef, "numel") else 0)
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
    elif name in ("banded_interp", "banded_interp_complex"):
        x, pos = args[0], args[1]
        width = x.shape[1] * (2 if name == "banded_interp_complex" else 1)
        out = pos.numel() * width
        need = _taps_needed(pos, x.shape[2]) * width + pos.numel()
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


def kernel_pairs() -> dict:
    """Each kernel wrapper's name: (the wrapper, its plain version)."""
    from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
    from bauklank_tpu_torch.kernels.chainfetch import chainfetch, chainfetch_ref
    from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
    from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
    from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref, pallas_gather
    from bauklank_tpu_torch.kernels.interp import (banded_interp, banded_interp_complex,
                                                   banded_interp_ref)
    from bauklank_tpu_torch.kernels.smooth import smooth_pair, smooth_pair_ref

    return {
        "frames_windowed": (frames_windowed, frames_windowed_ref),
        "comp_cumsum": (comp_cumsum, comp_cumsum_ref),
        "frac_gather": (frac_gather, frac_gather_ref),
        "band_chain": (band_chain, band_chain_ref),
        "banded_interp": (banded_interp, banded_interp_ref),
        "banded_interp_complex": (banded_interp_complex, banded_interp_ref),
        "pallas_gather": (pallas_gather, frac_gather_ref),
        "chainfetch": (chainfetch, chainfetch_ref),
        "smooth_pair": (smooth_pair, smooth_pair_ref),
    }


def hold_to_plain(ops: dict, what: str) -> dict:
    """Each kernel call captured on a path (:func:`capture_operands`)
    against its plain version on the same operands: bit-equal
    (TOLERANCE), finite.  Untimed.  Returns each kernel's worst max
    |diff| and the shapes it was held at."""
    import torch

    pairs = kernel_pairs()
    held = {}
    for name, calls in ops.items():
        kern, ref = pairs[name]
        for args in calls:
            got, want = kern(*args), ref(*args)
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or err > TOLERANCE:
                raise AssertionError(f"{name} ({what}) disagrees with its plain version at "
                                     f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}"
                                     f": {err}")
            worst, shapes = held.get(name, (0.0, []))
            held[name] = (max(worst, err), shapes + [
                " ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))])
            del got, want
    return held


def compare_kernels(ops: dict, tag: str, results: dict, mhz: float) -> None:
    """Each captured kernel call against its plain version on the card,
    with its time, its plain version's, its bound and, where there is
    one, the library call's."""
    import torch

    from bauklank_tpu_torch.kernels.gather import frac_gather
    from bauklank_tpu_torch.kernels.interp import banded_interp

    pairs = kernel_pairs()
    for name, calls in ops.items():
        kern, ref = pairs[name]
        if name == "frames_windowed":
            calls = frame_forms(calls[0])
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
            lib_name, lib_args, lib_want, copy_note = name, args, got[0], ""
            if name == "banded_interp_complex":
                # and against the planar entry point on the stacked copy of the
                # same rows, which is also what grid_sample can be given; the
                # copy is made once, outside every timing
                x, pos, window = args
                half = x.shape[1]
                stacked = torch.cat([x[..., 0], x[..., 1]], dim=1).contiguous()
                planar = banded_interp(stacked, pos, window)
                if not (torch.equal(got[0][..., 0], planar[:, :half])
                        and torch.equal(got[0][..., 1], planar[:, half:])):
                    raise AssertionError(f"banded_interp_complex ({tag}) differs from the "
                                         "planar kernel on the stacked rows")
                planar_ms = cuda_ms(lambda: banded_interp(stacked, pos, window), reps=20, warm=2)
                copy_note = (f"; planar kernel on the stacked copy {tuple(stacked.shape)} "
                             f"{planar_ms:.4f} ms, equal bit for bit (grid_sample is timed on "
                             "that copy; making the copy is in neither time)")
                lib_name, lib_args, lib_want = "banded_interp", (stacked, pos), planar
            bound_ms, bound_by, nbytes, nops = bound(name, args)
            sets = itertools.cycle(cold_sets(args, nbytes))
            ms = cuda_ms(lambda: kern(*next(sets)), reps=20, warm=2)
            plain_reps = 2 if name in ("band_chain", "comp_cumsum") else 10
            plain_ms = cuda_ms(lambda: ref(*args), reps=plain_reps, warm=1)
            warm_note = ""
            if name in CHAIN_DEPTH:
                # with its operands left in the L2: a chain that waits on its
                # own loads reads faster there
                warm_ms = cuda_ms(lambda: kern(*args), reps=20, warm=2)
                warm_note = f" (operands left in the L2: {warm_ms:.4f} ms)"
                # a chain's operations wait on each other: its operations
                # bound is the dependent chain's latency where that is longer
                steps = chain_steps(name, args)
                chain_ms = steps * CHAIN_DEPTH[name] * DEP_CYCLES / (mhz * 1e3)
                log(f"[bound] {tag} {name}#{j}: dependent chain {steps} steps x "
                    f"{CHAIN_DEPTH[name]} ops x {DEP_CYCLES} cycles at {mhz:.0f} MHz = "
                    f"{chain_ms:.4f} ms")
                if chain_ms > bound_ms:
                    bound_ms, bound_by = chain_ms, "operations"
                if name == "band_chain" and STEP_CYCLES:
                    # the second column: the step as the card runs it, read
                    # from registers (the floor the loop could reach)
                    lead, chan, long_step = args
                    key = ("step_1ch" if chan.shape[0] == 1 else
                           "step_2ch_long_step_1" if long_step == 1 else "step_2ch")
                    reg_ms = steps * STEP_CYCLES[key] / (mhz * 1e3)
                    warm_note += (f"; the step from registers ({key} {STEP_CYCLES[key]:.1f} "
                                  f"cycles a band) {reg_ms:.4f} ms, {reg_ms / ms:.1%} of it "
                                  "reached")
            lib = library_call(lib_name, lib_args)
            lib_ms, lib_note = None, ""
            if lib is not None:
                call, layout = lib
                lib_err = float((layout(call()) - lib_want).abs().max() / lib_want.abs().max())
                lib_calls = itertools.cycle(
                    [call] + [library_call(lib_name, a)[0]
                              for a in cold_sets(lib_args, nbytes)[1:]])
                lib_ms = cuda_ms(lambda: next(lib_calls)(), reps=10, warm=1)
                what = "two grid_sample calls" if name == "chainfetch" else "grid_sample"
                lib_note = f", {what} {lib_ms:.4f} ms (rel. diff {lib_err:.2e})"
            shapes = " ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))
            if name == "frames_windowed":
                shapes += (f" pitch {_pitch(args)}"
                           + (" (the path's form)" if j == 0 else " (the other form)"))
            log(f"[kernel] {tag} {name}#{j} {shapes}: max_abs_err={err!r} "
                f"kernel {ms:.4f} ms{warm_note}, plain {plain_ms:.4f} ms{lib_note}; "
                f"bound {bound_ms:.4f} ms "
                f"by {bound_by} ({nbytes / 1e6:.1f} MB, {nops / 1e6:.1f} Mop; "
                f"{bound_ms / ms:.1%} of it reached){copy_note} | {CARD}")
            if not finite or err > TOLERANCE:
                raise AssertionError(f"{name} ({tag}) disagrees with its plain version: {err}")
            # the result line reports kernel 5 at the main path's call: the
            # complex spectra through the interleaved entry point
            name = "banded_interp" if name == "banded_interp_complex" else name
            if tag == KERNELS[name][2] and j == 0:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": lib_ms}


def front_bucket_frames(results: dict, mhz: float) -> None:
    """Kernel 1 at the front door's fidelity bucket shapes (phase 8's
    UnifiedPool): 64 voices a bucket stepping H = 1, so two frames a
    stream; the preset bucket (120 ms, overlap 4: block 5376 after the
    grid rounding) and the kiosk one (200 ms, overlap 1: block 9216), on
    operands captured from one step of a pool built as the bucket is."""
    from golden_wasm import material

    from bauklank_tpu_torch.engine.config import StretchConfig
    from bauklank_tpu_torch.serve.pool import StreamPool

    x = material.case_input(1.0, 2, seconds=6.0)[:, : int(6 * SR)]
    for tag, block, interval, rates, offset in (
            ("front-preset", 5292, 1323, np.linspace(0.5, 2.0, 64), 0.0),
            ("front-kiosk", 8820, 8820, np.full(64, 0.001), 1.0)):
        pool = StreamPool(capacity=64, hops_per_step=1, engine="fidelity", max_track_sec=6.0,
                          config=StretchConfig(block=block, interval=interval), device="cuda")
        for i in range(64):
            pool.load_track(f"s{i:02d}", np.roll(x, 1009 * i, axis=-1))
            pool.start(f"s{i:02d}", when=0.0, offset=offset, rate=float(rates[i]))
        ops: dict = {}
        with capture_operands(ops, "fidelity"):
            pool.step(fetch=True)
        compare_kernels({"frames_windowed": ops["frames_windowed"]}, tag, results, mhz)


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


def graphs_against_eager(kind: str, pool, served, warm: int, timed: int, card: str) -> None:
    """A pool's step graphs against its eager twin: the served
    steps' time (``served``: ms/step and the timed steps' master, from
    :func:`serve`), ``graph_replays / steps`` of ``pool``, and a twin from
    :func:`make_pool` with its graphs taken off (its steps run the eager
    chain, as the pool stepped before it had graphs), stepped as many
    times and timed alike, whose master must equal the served one bit for
    bit.  Then every op under the twin's analysis in one profiled step,
    which must hold no pad: kernel 1 writes the padded rows (a replay
    shows no op there, only the graph's launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graphed_ms, master = served
    twin = make_pool(kind, "cuda")
    twin._graphs = None
    with chainfetch_switch(kind == "preset-fused"):
        eager_s, eager = step_pool(twin, warm, timed)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            twin.step(fetch=True)
    if not np.array_equal(eager, master):
        diff = float(np.abs(eager - master).max())
        raise AssertionError(f"{kind}: the master with step graphs differs from the eager "
                             f"step's by {diff}")
    m = pool.metrics()
    if not m["graph_replays"] > 0:
        raise AssertionError(f"{kind}: no step graph replayed ({m})")
    log(f"[graphs] {kind}: {graphed_ms:.2f} ms/step with step graphs, {eager_s * 1e3:.2f} "
        f"ms/step eager (untraced, {timed} steps each); graph_replays / steps "
        f"{m['graph_replays']} / {m['steps']} ({m['graph_replays'] / m['steps']:.1%}), "
        f"graph_captures {m['graph_captures']}; the masters equal bit for bit over "
        f"{master.shape[-1]} samples | {card}")
    below: dict = {}

    def walk(event):
        for child in event.cpu_children:
            below[child.name] = below.get(child.name, 0) + 1
            walk(child)

    analyse = f"{pool.engine}.analyse"
    for e in prof.events():
        if e.name == analyse and e.device_type == torch.autograd.DeviceType.CPU:
            walk(e)
    log(f"[graphs] {kind} eager {analyse}, every op below it: " + ", ".join(
        f"{name} x{n:g}" for name, n in sorted(below.items())))
    pads = sorted(name for name in below if "pad" in name)
    if pads:
        raise AssertionError(f"{kind}: the {pool.engine} analysis ran {pads}")
    del twin
    torch.cuda.empty_cache()


def where_time_goes(kind: str, pool, steps: int, step_ms: float, card: str) -> None:
    """Profile ``steps`` pool steps: the card's busy share, each stage's
    host and device time (the engine's ``record_function`` ranges), the
    kernels that take most device time, and each kernel of the pool's
    path seen to run its number of times a step (replays included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bauklank_tpu_torch import kernels

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
    # each kernel of the pool's path ran its number of times a step, as the
    # profiler saw it: a replayed step's kernels are not issued by the host
    ran = {k: sum(bool(re.search(rf"\b{k}(_\w+)?_kernel", e.name)) for e in dev_events)
           for k in kernels.LAUNCHES}
    if ran != {k: PER_STEP[kind].get(k, 0) * steps for k in ran}:
        raise AssertionError(f"{kind}: the profiler saw {ran} in {steps} steps, not "
                             f"{steps} x {PER_STEP[kind]}")
    m = pool.metrics()
    log(f"[profile] {kind} kernels that ran, as the profiler saw them: {ran} in {steps} "
        f"steps (graph_replays {m['graph_replays']} of {m['steps']} steps)")
    # the PyTorch ops called directly inside the gather stage, by device time
    stage = GATHER_STAGE[pool.engine]
    inside: dict = {}
    for e in events:
        if e.name == stage and e.device_type == torch.autograd.DeviceType.CPU:
            for child in e.cpu_children:
                us, calls = inside.get(child.name, (0.0, 0))
                inside[child.name] = (us + child.device_time_total, calls + 1)
    log(f"[profile] {kind} {stage} ops: " + "; ".join(
        f"{name} {us / steps / 1e3:.3f} ms/step ({calls // steps} calls)"
        for name, (us, calls) in sorted(inside.items(), key=lambda kv: -kv[1][0])[:10]))


def issued_steps(pool, before: dict) -> int:
    """The steps whose launches the host issued since ``pool.metrics()``
    read ``before``: each eager step and each capture of step graphs."""
    m = pool.metrics()
    return (m["steps"] - before["steps"] - (m["graph_replays"] - before["graph_replays"])
            + m["graph_captures"] - before["graph_captures"])


def serve(kind: str, pool, warm: int, timed: int, card: str, launches: dict):
    """Drive one pool with the launch counts set to 0 just before and read
    just after; fails unless each kernel of the pool's path was launched
    its number of times a step and no other kernel at all: by the host in
    each step it issued, eagerly or into a graph's capture (a replayed
    step issues none; :func:`where_time_goes` counts what ran).  Adds the
    counts to ``launches`` and returns (ms/step, the timed steps' master)."""
    from bauklank_tpu_torch import kernels

    kernels.reset_launches()
    before = pool.metrics()
    with chainfetch_switch(kind == "preset-fused"):
        dt, master = step_pool(pool, warm, timed)
    counts = dict(kernels.LAUNCHES)
    want = {k: PER_STEP[kind].get(k, 0) * issued_steps(pool, before) for k in counts}
    if counts != want:
        raise AssertionError(f"{kind} pool launched {counts}, not {want}")
    for k, v in counts.items():
        launches[k] += v
    peak = float(np.abs(master).max())
    s_n, h = pool.capacity, pool.hops_per_step
    block, interval = pool.drive.block, pool.drive.interval
    rtf = s_n * h * interval / SR / dt
    shape = (f"fft={pool.scfg.fft} L={pool.scfg.long_step}" if pool.engine == "fidelity"
             else f"bands={block // 2}")
    log(f"[serve] {kind} ({pool.engine}): S={s_n} H={h} block={block} interval={interval} "
        f"{shape}: {dt * 1e3:.2f} ms/step, aggregate RTF {rtf:.1f}x, master peak {peak:.4f}, "
        f"launches {counts} | {card}")
    log(f"[serve] {kind} metrics {pool.metrics()}")
    return dt * 1e3, master


# 8. the serving front door: the pools and the node as the server builds them
FRONT_PATH = {"fidelity": ("frames_windowed", "smooth_pair", "comp_cumsum", "frac_gather",
                           "band_chain"),
              "fast": ("frames_windowed", "banded_interp")}
# (preset, kiosk, live) voices of each UnifiedPool; each bucket grows from 4
FRONT_VOICES = {"fidelity": (64, 64, 16), "fast": (32, 32, 8)}
FRONT_SECONDS = 4.0
FRONT_WARM = 10     # quanta left out of the quantum-time percentiles
RESUME_QUANTA = 10


def _check_path(what: str, engine: str, counts: dict, on_card: bool) -> None:
    """Every kernel of the engine's path launched in the run, no other."""
    if not on_card:
        return
    path = FRONT_PATH[engine]
    missing = [k for k in path if counts[k] == 0]
    stray = {k: v for k, v in counts.items() if k not in path and v}
    if missing or stray:
        raise AssertionError(f"{what} launched {counts}: none of {missing}, stray {stray}")


@contextlib.contextmanager
def per_bucket_launches(store: dict):
    """Count each unified bucket's steps and kernel launches (the bucket's
    ``render_chunk`` is wrapped for the run)."""
    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.serve import unified

    orig = unified._Bucket.render_chunk

    def counted(bucket):
        before = dict(kernels.LAUNCHES)
        out = orig(bucket)
        rec = store.setdefault(bucket.key, dict.fromkeys(("steps", *before), 0))
        rec["steps"] += 1
        for k, v in kernels.LAUNCHES.items():
            rec[k] += v - before[k]
        return out

    unified._Bucket.render_chunk = counted
    try:
        yield store
    finally:
        unified._Bucket.render_chunk = orig


def build_unified(engine: str, pipeline: bool, device: str, voices=None, track_sec: float = 6.0):
    """A UnifiedPool as the server builds it (``--pool unified``), filled
    voice by voice so each bucket grows from 4: preset file voices (120 ms,
    overlap 4; rates 0.5-2.0, -12..+12 st), kiosk file voices (200 ms,
    overlap 1; rate 0.001, -12..+12 st) and live voices (120 ms, overlap 4;
    -12..+12 st)."""
    from golden_wasm import material

    from bauklank_tpu_torch.serve.unified import UnifiedPool

    n_preset, n_kiosk, n_live = voices or FRONT_VOICES[engine]
    pool = UnifiedPool(sample_rate=SR, engine=engine, pipeline_fetch=pipeline,
                       max_track_sec=track_sec, device=device)
    x = material.case_input(1.0, 2, seconds=track_sec)[:, : int(track_sec * SR)]
    tones = lambda n: np.linspace(-12.0, 12.0, n) if n > 1 else np.zeros(n)
    for i, (rate, st) in enumerate(zip(np.linspace(0.5, 2.0, n_preset), tones(n_preset))):
        pool.add_voice(f"p{i:02d}")
        pool.load_track(f"p{i:02d}", np.roll(x, 1009 * i, axis=-1))
        pool.start(f"p{i:02d}", when=0.0, rate=float(rate), semitones=float(st))
    for i, st in enumerate(tones(n_kiosk)):
        pool.add_voice(f"k{i:02d}", block_ms=200.0, overlap=1.0)
        pool.load_track(f"k{i:02d}", np.roll(x, 2003 * i, axis=-1))
        pool.start(f"k{i:02d}", when=0.0, offset=1.0, rate=0.001, semitones=float(st))
    for i, st in enumerate(tones(n_live)):
        pool.add_voice(f"l{i:02d}", mode="live")
        pool.schedule(f"l{i:02d}", {"output": 0.0, "active": True, "semitones": float(st)})
    return pool, x


def render_unified(pool, quanta: int, first: int, times: list | None = None) -> np.ndarray:
    """``quanta`` quanta of master, every live voice fed the quanta
    ``first``.. of a 220 Hz tone; each quantum's host time to ``times``."""
    n = pool.quantum
    t = np.arange(first * n, (first + quanta) * n) / SR
    src = (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    live = [name for name, v in pool.voices.items() if v.mode == "live"]
    out = []
    for q in range(quanta):
        for name in live:
            pool.feed(name, src[q * n:(q + 1) * n])
        t0 = time.perf_counter()
        out.append(pool.render(n))
        if times is not None:
            times.append(time.perf_counter() - t0)
    return np.concatenate(out, axis=1)


def front_door_pool(engine: str, device: str, card: str, launches: dict,
                    voices=None, seconds: float = FRONT_SECONDS, track_sec: float = 6.0) -> None:
    """One UnifiedPool with pipelined fetch: its buckets grown to size, the
    render timed quantum by quantum with the launch counts set to 0 before
    and read after; a twin with blocking fetch whose master must be equal
    bit for bit; analyze of a file and a live voice; save_unified and
    load_unified into a fresh pool, whose next quanta must equal the
    original's bit for bit."""
    import tempfile

    import torch

    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.utils import checkpoint

    on_card = device == "cuda"
    t0 = time.perf_counter()
    pool, x = build_unified(engine, True, device, voices, track_sec)
    twin, _ = build_unified(engine, False, device, voices, track_sec)
    caps = {f"{k[0]}:{k[1]}/{k[2]}": b.pool.capacity for k, b in pool.buckets.items()}
    log(f"[front] {engine} unified pool built in {time.perf_counter() - t0:.2f} s: bucket "
        f"capacities {caps} (each grown from {pool.bucket_capacity} by doubling)")
    quanta = int(round(seconds * SR / pool.quantum))
    times: list = []
    per_bucket: dict = {}
    kernels.reset_launches()
    with per_bucket_launches(per_bucket):
        master = render_unified(pool, quanta, 0, times)
    if on_card:
        torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    _check_path(f"{engine} unified pool", engine, counts, on_card)
    kernels.reset_launches()
    # the fidelity twin's analysis pads the plain rows with PyTorch, as it
    # ran before kernel 1 wrote padded rows: the masters must still agree
    with plain_frame_rows() if engine == "fidelity" else contextlib.nullcontext():
        twin_master = render_unified(twin, quanta, 0)
    twin_counts = dict(kernels.LAUNCHES)
    _check_path(f"{engine} unified twin", engine, twin_counts, on_card)
    for k in launches:
        launches[k] += counts[k] + twin_counts[k]
    if not (np.isfinite(master).all() and np.abs(master).max() > 0):
        raise AssertionError(f"{engine} unified master is not finite or silent")
    if not np.array_equal(master, twin_master):
        raise AssertionError(f"{engine} unified master with pipelined fetch differs from the "
                             f"blocking fetch's by {float(np.abs(master - twin_master).max())}")
    steady = np.asarray(times[FRONT_WARM:]) * 1e3
    per_q = {f"{k[0]}:{k[1]}/{k[2]}": {"steps": r["steps"], **{
        name: round(v / quanta, 3) for name, v in r.items() if name != "steps" and v}}
        for k, r in per_bucket.items()}
    log(f"[front] {engine} unified: {quanta} quanta of {pool.quantum} samples "
        f"({len(pool.voices)} voices); quantum p50 {np.percentile(steady, 50):.3f} ms, p99 "
        f"{np.percentile(steady, 99):.3f} ms, max {steady.max():.3f} ms (first {FRONT_WARM} "
        f"quanta apart: {np.asarray(times[:FRONT_WARM]).sum() * 1e3:.1f} ms in all); master "
        f"equals the blocking-fetch twin's bit for bit over {master.shape[-1]} samples"
        + (" (the twin's analysis on the plain frame rows padded by PyTorch)"
           if engine == "fidelity" else "") + f" | {card}")
    log(f"[front] {engine} unified launches {counts}; per quantum by bucket {per_q}")
    log(f"[front] {engine} unified metrics {pool.metrics()}")
    for name in ("p00", "l00"):
        a = pool.analyze(name, n_buckets=64)
        if a is None or not np.isfinite(a["spectrum"]).all() or not max(a["levels"]["peak"]) > 0:
            raise AssertionError(f"{engine} analyze({name}) gave {a}")
        log(f"[front] {engine} analyze {name}: peak {a['levels']['peak']}, rms "
            f"{a['levels']['rms']}, {len(a['spectrum'])} spectrum bins")
    del twin
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unified")
        checkpoint.save_unified(path, pool)
        want = render_unified(pool, RESUME_QUANTA, quanta)
        fresh = type(pool)(sample_rate=SR, engine=engine, pipeline_fetch=True,
                           max_track_sec=track_sec, device=device)
        checkpoint.load_unified(path, fresh)
    for name, v in fresh.voices.items():
        if v.mode == "file":
            k = int(name[1:])
            fresh.load_track(name, np.roll(x, (1009 if name[0] == "p" else 2003) * k, axis=-1))
    got = render_unified(fresh, RESUME_QUANTA, quanta)
    if not np.array_equal(want, got):
        raise AssertionError(f"{engine} unified pool resumed from its checkpoint differs by "
                             f"{float(np.abs(want - got).max())}")
    log(f"[front] {engine} unified save/load on the card: the next {RESUME_QUANTA} quanta equal "
        "the uninterrupted pool's bit for bit")


def front_door_nodes(device: str, card: str, launches: dict, seconds: float = FRONT_SECONDS,
                     long_sec: float = 0.5) -> None:
    """A fidelity and a fast StretchNode at the kiosk configure, pulled in
    30 ms quanta; then a fidelity node at configure(block=2048,
    interval=64), long_step 32, whose band chain runs past the old bound
    of 16."""
    import torch

    from golden_wasm import material

    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.node import StretchNode

    on_card = device == "cuda"
    x = material.case_input(1.0, 2, seconds=6.0)
    n = round(SR * 0.03)
    for engine in ("fidelity", "fast"):
        node = StretchNode(sample_rate=SR, channels=2, engine=engine, device=device)
        node.configure(blockMs=200, overlap=1.0, splitComputation=True)
        node.add_buffers([x[0], x[1]])
        node.start(when=0.0, offset=0.5, rate=0.25, semitones=-5)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = np.concatenate([node.process_output(n) for _ in range(int(seconds * SR / n))], 1)
        dt = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        _check_path(f"{engine} node", engine, counts, on_card)
        for k in launches:
            launches[k] += counts[k]
        if not (np.isfinite(out).all() and np.abs(out).max() > 0):
            raise AssertionError(f"{engine} node output is not finite or silent")
        log(f"[front] {engine} node, kiosk configure (block {node.block_samples}, interval "
            f"{node.interval_samples}): {out.shape[-1] / SR:.2f} s pulled in {n}-sample quanta "
            f"in {dt:.2f} s, peak {float(np.abs(out).max()):.4f}, launches {counts} | {card}")
    node = StretchNode(sample_rate=SR, channels=2, engine="fidelity", device=device)
    node.configure(block=2048, interval=64)
    node.add_buffers([x[0], x[1]])
    node.start(when=0.0, offset=0.5, rate=0.7)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = node.process_output(int(long_sec * SR))
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    _check_path("long-step node", "fidelity", counts, on_card)
    for k in launches:
        launches[k] += counts[k]
    if not (np.isfinite(out).all() and np.abs(out).max() > 0):
        raise AssertionError("long-step node output is not finite or silent")
    log(f"[front] fidelity node at configure(block=2048, interval=64): long_step "
        f"{node.drive.scfg.long_step}, {out.shape[-1] / SR:.2f} s in {dt:.2f} s, peak "
        f"{float(np.abs(out).max()):.4f}, launches {counts} | {card}")


def long_step_chains(mhz: float, results: dict) -> None:
    """The band chain past the old bound of 16, held bit-equal to its plain
    version in phase 3's manner: the node's L = 32 (the shared history at
    its limit) and pools of 64 streams at L = 24 (the history) and L = 40
    (the general form, band b - L read back from the out planes); and the
    two sequential kernels at S = 4 and 8, the unified buckets' first
    widths."""
    from bauklank_tpu_torch.engine.config import StretchConfig
    from bauklank_tpu_torch.node import StretchNode
    from bauklank_tpu_torch.serve.pool import StreamPool
    from golden_wasm import material

    x = material.case_input(1.0, 2, seconds=6.0)[:, : int(6 * SR)]
    node = StretchNode(sample_rate=SR, channels=2, engine="fidelity", device="cuda")
    node.configure(block=2048, interval=64)
    node.add_buffers([x[0], x[1]])
    node.start(when=0.0, offset=0.5, rate=0.7)
    ops: dict = {}
    with capture_operands(ops, "fidelity"):
        node.process_output(64)
    compare_kernels({"band_chain": ops["band_chain"]}, f"node-L{node.drive.scfg.long_step}",
                    results, mhz)
    # blocks on the pool's FFT grid whose fft / 64 is 24 (fft 1536) and 40
    # (fft 2560); the preset at the unified buckets' first widths
    for block, s_n, h in ((1536, 64, 4), (2304, 64, 4), (5292, 4, 8), (5292, 8, 8)):
        cfg = None if block == 5292 else StretchConfig(block=block, interval=64)
        pool = StreamPool(capacity=s_n, hops_per_step=h, engine="fidelity", config=cfg,
                          max_track_sec=6.0, device="cuda")
        for i in range(s_n):
            pool.load_track(f"s{i:02d}", np.roll(x, 1009 * i, axis=-1))
            pool.start(f"s{i:02d}", rate=float(np.linspace(0.5, 2.0, s_n)[i]))
        ops = {}
        with capture_operands(ops, "fidelity"):
            pool.step(fetch=True)
        if cfg is not None and pool.scfg.long_step not in (24, 40):
            raise AssertionError(f"block {block} gave long_step {pool.scfg.long_step}")
        tag = (f"pool-L{pool.scfg.long_step}" if cfg is not None else f"preset-S{s_n}")
        want = ("band_chain",) if cfg is not None else ("band_chain", "comp_cumsum")
        compare_kernels({k: ops[k] for k in want}, tag, results, mhz)


# 9. the server and the CLI: ``python -m bauklank_tpu_torch stretch`` and
# ``serve`` as a user starts them
STRETCH_ARGS = ["--rate", "0.5", "--semitones", "-12", "--max-seconds", "20"]
STRETCH_TRACK_SEC = 30.0
SERVE_SECONDS = 6.0
SERVE_TURN_SEC = 0.5
RENDER_AHEAD_SEC = 0.25   # ControlServer's default, as main builds it
HOP_DEADLINE_MS = 30.0    # one hop (and one unified quantum) of audio
FIRST_SEC = 1.0           # underruns of the first second counted apart
# the keys of the JAX server's ``analysis`` reply (serve/server.py's
# ``{"type": "analysis", **pool.analyze(slot)}``)
ANALYSIS_KEYS = {"type", "slot", "scope", "spectrum", "spectrumHzPerBin", "levels"}
# (key, value) turns of the fake controller, one every SERVE_TURN_SEC, the
# channel alternating A, B; the WebSocket client's sets fall between them.
# The last of either lands a second before the run ends, so every one has
# reached the pool when it is read.
TURNS = [("rate", 0.002), ("tone", -4), ("volume", 35), ("rate", 0.4), ("tone", 5),
         ("volume", 60), ("rate", 0.001), ("tone", -6), ("volume", 45), ("rate", 0.6)]
WS_SETS = [("B", "pan", 0.25), ("A", "pan", -0.5), ("B", "tone", 6), ("A", "volume", 40),
           ("B", "rate", 0.45), ("A", "tone", -7)]
# the (engine, key, value) of every set broadcast the run must see
_SETS = set(WS_SETS) | {("AB"[i % 2], k, v) for i, (k, v) in enumerate(TURNS)}


def _dominant_hz(x: np.ndarray, sr: float) -> float:
    """The strongest spectral peak, refined by parabolic interpolation."""
    x = np.asarray(x, np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    k = int(np.argmax(spec[1:-1])) + 1
    a, b, c = np.log(spec[k - 1:k + 2] + 1e-30)
    denom = a - 2 * b + c
    return (k + (0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0)) / len(x) * sr


def cli_stretch(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """(a) ``stretch`` through the CLI: a 30 s stereo 44.1 kHz WAV (a 440 Hz
    tone and low noise from ``seed``) stretched twice as long and an octave
    down, in this process and as ``python3 -m bauklank_tpu_torch``; the two
    files equal bit for bit, both >= 80 dB against ``stretch_offline``
    called directly, the dominant frequency 220 Hz."""
    import tempfile

    import torch

    from bauklank_tpu_torch import cli, kernels
    from bauklank_tpu_torch.engine import StretchConfig, StretchParams, stretch_offline
    from bauklank_tpu_torch.runtime import native_available
    from bauklank_tpu_torch.utils.audio import load_audio, save_audio

    sr = int(SR)
    rng = np.random.default_rng(seed)
    t = np.arange(int(STRETCH_TRACK_SEC * sr)) / sr
    planes = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t + ph) + 0.01 * rng.standard_normal(t.size)
                       for ph in (0.0, 0.3)]).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src, out_in, out_sub = (os.path.join(tmp, n) for n in ("in.wav", "cli.wav", "sub.wav"))
        save_audio(src, planes, sr)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if cli.main(["stretch", src, out_in, *STRETCH_ARGS, "--device", device]) != 0:
            raise AssertionError("cli stretch returned non-zero")
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        _check_path("cli stretch", "fast", counts, device == "cuda")
        for k in launches:
            launches[k] += counts[k]
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "bauklank_tpu_torch", "stretch", src, out_sub,
                        *STRETCH_ARGS, "--device", device], cwd=ROOT, check=True, timeout=600)
        wall_sub = time.perf_counter() - t0
        same = open(out_in, "rb").read() == open(out_sub, "rb").read()
        got, sr_out = load_audio(out_in)
        sub, _ = load_audio(out_sub)
        x, _ = load_audio(src)
    if not same:
        raise AssertionError(f"the subprocess's file differs from the in-process one "
                             f"({_snr(torch.from_numpy(got), torch.from_numpy(sub)):.2f} dB)")
    block = round(0.12 * sr)
    cfg = StretchConfig(channels=2, block=block, interval=round(block / 4.0),
                        split_computation=True, formants=False)
    params = StretchParams.make(rate=0.5, semitones=-12.0, sample_rate=sr, device=device)
    ref = stretch_offline(x, 0.5, cfg, params=params, n_out=20 * sr, device=device)
    snr = _snr(torch.from_numpy(ref), torch.from_numpy(got))
    hz = _dominant_hz(got[0, 5 * sr:5 * sr + 32768], sr)
    secs = got.shape[1] / sr
    log(f"[cli] stretch {STRETCH_TRACK_SEC:.0f} s stereo -> {secs:.1f} s {' '.join(STRETCH_ARGS)}: "
        f"in-process {wall:.2f} s wall ({secs / wall:.1f} s of audio a second), subprocess "
        f"{wall_sub:.2f} s wall; the two files equal bit for bit; {snr:.2f} dB against "
        f"stretch_offline on {device}; dominant {hz:.2f} Hz; native WAV codec "
        f"{'built' if native_available() else 'NOT built (stdlib wave)'}; launches {counts} "
        f"| {card}")
    if sr_out != sr or got.shape != (2, 20 * sr) or not np.isfinite(got).all():
        raise AssertionError(f"cli stretch wrote {got.shape} at {sr_out} Hz")
    if not snr >= 80.0:
        raise AssertionError(f"cli stretch {snr:.2f} dB < 80 dB against stretch_offline")
    if abs(hz - 220.0) > 0.02 * 220.0:
        raise AssertionError(f"cli stretch dominant frequency {hz:.2f} Hz, not 220 Hz")


def _pct(a, q: float) -> float:
    """The q-th percentile of ``a``; nan when ``a`` is empty."""
    return float(np.percentile(a, q)) if len(a) else float("nan")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _controls(pool, slot: str) -> dict:
    """A voice's rate, tone, volume (percent) and pan, in either pool kind."""
    v = pool.voices[slot] if hasattr(pool, "voices") else pool.slots[pool._by_name[slot]]
    seg = v.timemap.segments[-1]
    return {"rate": seg.rate, "tone": seg.semitones, "volume": v.volume * 100.0, "pan": v.pan}


@contextlib.contextmanager
def _restarts():
    """The supervisor's restart lines (``task ... crashed``) logged while
    the block runs."""
    import logging

    lines: list = []

    class Handler(logging.Handler):
        def emit(self, record):
            if "crashed" in record.getMessage():
                lines.append(record.getMessage())

    handler, logger = Handler(), logging.getLogger("bauklank.serve")
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)


async def _drive_server(server, fc, use_ws: bool, port: int, rec: dict) -> None:
    """Run the server for SERVE_SECONDS: the controller turns a knob every
    SERVE_TURN_SEC; with ``use_ws`` a WebSocket client sends its sets
    between turns, one ``analyze``, and reads the broadcasts."""
    import asyncio

    rec["t0"] = time.monotonic()
    if use_ws:
        main_task = asyncio.create_task(server.run())
    else:
        main_task = asyncio.gather(
            server._supervise(server.serial_manager_task, "serial"),
            server._supervise(server.heartbeat_task, "heartbeat"),
            server._supervise(server.render_loop_task, "render-loop"),
            server._supervise(server.time_status_task, "time-status"))

    async def controller():
        for i, (key, value) in enumerate(TURNS):
            await asyncio.sleep(SERVE_TURN_SEC)
            ch = "AB"[i % 2]
            rec["turn_at"][(ch, key, value)] = time.monotonic()
            fc.turn(ch, key, value)
            rec["last"][(ch, key)] = value

    async def client():
        import websockets

        await asyncio.sleep(0.1)
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            pending = list(WS_SETS)
            next_send = time.monotonic() + SERVE_TURN_SEC / 2
            end, late_end = rec["t0"] + SERVE_SECONDS - 0.3, rec["t0"] + SERVE_SECONDS + 5.0
            asked = False
            # past ``end`` only while broadcasts are still due (a slow step
            # holds the pool lock that each set waits for)
            while time.monotonic() < end or (time.monotonic() < late_end and (
                    rec["analysis"] is None or not _SETS <= set(rec["sets"]))):
                now = time.monotonic()
                if pending and now >= next_send:
                    ch, key, value = pending.pop(0)
                    rec["sent_at"][(ch, key, value)] = now
                    await ws.send(json.dumps({"type": "set", "channel": ch, "key": key,
                                              "value": value}))
                    rec["last"][(ch, key)] = value
                    next_send = now + SERVE_TURN_SEC
                elif not asked and now - rec["t0"] > SERVE_SECONDS / 2:
                    await ws.send(json.dumps({"type": "analyze", "slot": "B"}))
                    asked = True
                try:
                    raw = await asyncio.wait_for(ws.recv(), 0.05)
                except asyncio.TimeoutError:
                    continue
                m = json.loads(raw)
                at = time.monotonic()
                if m["type"] == "set":
                    k = (m["engine"], m["key"], m["value"])
                    start = rec["sent_at"].get(k, rec["turn_at"].get(k))
                    rec["sets"].append(k)
                    if start is not None:
                        rec["set_ms"].append((at - start) * 1e3)
                elif m["type"] == "time":
                    rec["times"].setdefault(m["slot"], []).append(m["inputTime"])
                elif m["type"] == "analysis":
                    rec["analysis"] = m

    helpers = [asyncio.create_task(controller())]
    if use_ws:
        helpers.append(asyncio.create_task(client()))
    try:
        await asyncio.sleep(SERVE_SECONDS)
        for h in helpers:
            await h  # raises what failed in the controller or the client
    finally:
        server.stop()
        await asyncio.sleep(0.3)   # the loops see the stop and return
        main_task.cancel()         # the heartbeat sleeps 60 s between lines
        try:
            await main_task
        except asyncio.CancelledError:
            pass


def serve_setups(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """(b) The ControlServer as ``serve/server.py:main`` builds it
    (``build_parser`` and ``build_server``), for ``--pool stream|unified``
    x ``--engine fast|fidelity`` at ``--engine-count 2 --pool-capacity 2``:
    30 s tracks in A (rate 0.001, -5 st, the kiosk's) and B (rate 0.5,
    +7 st), an audio sink that records each master and its arrival, a
    FakeController in channel mode, SERVE_SECONDS of wall clock.  The
    tracks are two tones and low noise from ``seed``."""
    import asyncio
    import importlib.util

    import torch

    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.serve.serial import FakeController
    from bauklank_tpu_torch.serve.server import build_parser, build_server

    use_ws = importlib.util.find_spec("websockets") is not None
    if not use_ws:
        log("[server] websockets is not installed: the WebSocket round trip (WS sets, "
            "analyze over WS, set and time broadcasts) is NOT run; the serial manager, render "
            "loop, time push and heartbeat run under asyncio, analyze through the server's "
            "locked call")
    rng = np.random.default_rng(seed + 1)
    t = np.arange(int(30 * SR)) / SR
    track = np.stack([0.3 * np.sin(2 * np.pi * 220.0 * t), 0.3 * np.sin(2 * np.pi * 330.0 * t)])
    track = (track + 0.01 * rng.standard_normal(track.shape)).astype(np.float32)
    for pool_kind in ("stream", "unified"):
        for engine in ("fast", "fidelity"):
            port = _free_port()
            args = build_parser().parse_args([
                "--engine-count", "2", "--pool-capacity", "2", "--pool", pool_kind,
                "--engine", engine, "--ws-host", "127.0.0.1", "--ws-port", str(port),
                "--no-serial-scan", "--device", device])
            arrivals: list = []
            sink = lambda m: arrivals.append((time.monotonic(), np.array(m, copy=True)))
            t_build = time.perf_counter()
            server = build_server(args, audio_sink=sink, render_ahead_sec=RENDER_AHEAD_SEC)
            pool = server.pool
            for slot, (rate, st) in (("A", (0.001, -5.0)), ("B", (0.5, 7.0))):
                pool.load_track(slot, [track[0], track[1]])
                pool.start(slot, when=0.0, offset=0.0, rate=rate, semitones=st)
            t_build = time.perf_counter() - t_build
            fc = FakeController("controller-1")
            server.add_transport(fc)
            rec = {"turn_at": {}, "sent_at": {}, "last": {}, "sets": [], "set_ms": [],
                   "times": {}, "analysis": None}
            kernels.reset_launches()
            with _restarts() as crashes:
                asyncio.run(_drive_server(server, fc, use_ws, port, rec))
            if device == "cuda":
                torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            for k in launches:
                launches[k] += counts[k]
            tag = f"--pool {pool_kind} --engine {engine}"
            if pool.device.type != device:
                raise AssertionError(f"{tag}: the pool is on {pool.device}")
            _check_path(f"server {tag}", engine, counts, device == "cuda")
            if crashes:
                raise AssertionError(f"{tag}: the supervisor restarted a task: {crashes}")
            if len(server.sessions) != 1:
                raise AssertionError(f"{tag}: the controller did not attach")
            # every turn and WS set reached the pool: the voice shows the last value
            for (slot, key), value in rec["last"].items():
                have = _controls(pool, slot)[key]
                if not abs(float(have) - float(value)) < 1e-9:
                    raise AssertionError(f"{tag}: {slot}.{key} is {have}, the last set was "
                                         f"{value}")
            masters = [m for _, m in arrivals]
            master = np.concatenate(masters, axis=1)
            if not (np.isfinite(master).all() and np.abs(master).max() > 0):
                raise AssertionError(f"{tag}: the master is not finite or silent")
            # the lead at each arrival, and the chunks that came after their
            # audio should have started (t0 taken just before run(), a few ms
            # before the render loop's own: both read a little low)
            pos, leads, late = 0, {True: [], False: []}, {True: 0, False: 0}
            for at, m in arrivals:
                first = pos / SR < FIRST_SEC
                late[first] += at - rec["t0"] > pos / SR
                pos += m.shape[1]
                leads[first].append(pos / SR - (at - rec["t0"]))
            steps = np.asarray(pool.timer.durations) * 1e3
            steady = steps[int(FIRST_SEC * SR / masters[0].shape[1]):]
            if use_ws:
                a = rec["analysis"]
                # (a UnifiedPool's reply names the bucket's inner slot, as the
                # JAX UnifiedPool's does: ROADMAP section 3)
                if a is None or set(a) != ANALYSIS_KEYS:
                    raise AssertionError(f"{tag}: analyze over WS gave {a}")
                missing = _SETS - set(rec["sets"])
                if missing:
                    raise AssertionError(f"{tag}: no set broadcast for {sorted(missing)}")
                if not all(rec["times"].get(s) for s in "AB"):
                    raise AssertionError(f"{tag}: no time push for both voices: "
                                         f"{ {s: len(v) for s, v in rec['times'].items()} }")
                ws_note = (f"WS: {len(rec['sets'])} set broadcasts (set to broadcast p50 "
                           f"{np.percentile(rec['set_ms'], 50):.1f} ms, max "
                           f"{max(rec['set_ms']):.1f} ms), time pushes "
                           f"{ {s: len(v) for s, v in rec['times'].items()} }, analyze of B keys ok "
                           f"(slot {a['slot']!r})")
            else:
                a = server._locked_analyze("B")
                if a is None or set({"type": "analysis", **a}) != ANALYSIS_KEYS:
                    raise AssertionError(f"{tag}: analyze gave {a}")
                ws_note = "WS round trip not run (no websockets)"
            log(f"[server] {tag}: built in {t_build:.2f} s; {pool.timer.total_steps} steps "
                f"in {SERVE_SECONDS:.0f} s, step p50 {np.percentile(steps, 50):.2f} ms p99 "
                f"{np.percentile(steps, 99):.2f} ms max {steps.max():.2f} ms (after the first "
                f"second: p50 {_pct(steady, 50):.2f} p99 {_pct(steady, 99):.2f}"
                f" ms) against the {HOP_DEADLINE_MS:.0f} ms hop; {len(arrivals)} chunks, "
                f"{master.shape[1] / SR:.2f} s of master; least lead "
                f"{min(leads[True] + leads[False]) * 1e3:.1f} ms (after the first second "
                f"{_pct(leads[False], 0) * 1e3:.1f} ms); underruns {late[True]} in the first "
                f"second, {late[False]} after; "
                f"{len(TURNS)} turns; {ws_note}; launches {counts} | {card}")
            del server, pool
            if device == "cuda":
                torch.cuda.empty_cache()


# 10. the parallel paths and the per-hop forms
PARALLEL_DEADLINE_SEC = 300.0   # the four spawned ranks sharing the card are joined under it
SEQPAR_DB = 45.0                # JAX's bar for the hop-sharded render (tests/test_seqpar.py)
# the wrappers a hop-sharded render calls (kernel 5's two entry points)
SEQPAR_KERNELS = {"frames_windowed", "banded_interp", "banded_interp_complex"}
SCAN_ATOL = 2e-4                # JAX's bars for the per-hop form (tests/test_spectral.py)
TIMED_PAIRS = 6                 # sharded and unsharded steps timed in turns after the check
# phase 10's shapes: (streams, hops a step) of each step, (streams, seconds
# out) of each hop-sharded render
P10 = {"fast": (128, 32), "fidelity": (128, 8), "live": (64, 8), "seqpar": (8, 60.0),
       "seqpar4": (4, 20.0)}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tracks(s_n: int, n: int, seed: int, device):
    """[S, 2, n] float32 made on ``device`` from ``seed``: two tones a
    stream and channel and a little noise."""
    import torch

    f = np.random.default_rng(seed).uniform(110.0, 880.0, (s_n, 2, 2))
    f = torch.from_numpy(f).to(device)
    t = torch.arange(n, dtype=torch.float64, device=device) / SR
    x = (0.3 * torch.sin(2 * np.pi * f[..., :1] * t)
         + 0.15 * torch.sin(2 * np.pi * f[..., 1:] * t)).to(torch.float32)
    g = torch.Generator(device=device).manual_seed(seed)
    return x + 0.02 * torch.randn(x.shape, generator=g, device=device)


def _voices(s_n: int):
    """Rates 0.5-2.0 and semitones -12..+12 across the streams."""
    return np.linspace(0.5, 2.0, s_n), np.linspace(-12.0, 12.0, s_n)


def _fast_inputs(s_n: int, h: int, steps: int, seed: int, device):
    """The fast pool's shape: formants off (no voice uses them), 120/30 ms."""
    import torch

    from bauklank_tpu_torch.engine.batched import formants_off
    from bauklank_tpu_torch.engine.config import preset_default
    from bauklank_tpu_torch.engine.offline import frame_ends_for
    from bauklank_tpu_torch.engine.params import StretchParams

    cfg = formants_off(preset_default(2, SR))
    rates, tones = _voices(s_n)
    params = StretchParams.stack([StretchParams.make(rate=r, semitones=s, device=device)
                                  for r, s in zip(rates, tones)])
    ends = [torch.from_numpy(np.stack([frame_ends_for(cfg, k * h * cfg.interval, h, r)
                                       for r in rates]).astype(np.int32)).to(device)
            for k in range(steps)]
    n = int(steps * h * cfg.interval * rates.max()) + 2 * cfg.block
    return cfg, _tracks(s_n, n, seed, device), ends, params


def _fidelity_inputs(s_n: int, h: int, steps: int, seed: int, device, formants: bool = False):
    """The fidelity preset (block 5292, fft 6144, 3072 bands): controls as
    the pool computes them; with ``formants`` the three formant controls
    too (a shift on auto f0, compensation on odd voices)."""
    import torch

    from bauklank_tpu_torch.engine import fidelity as fid

    cfg = fid.SpectralConfig(2, 5292, 1323, formants=formants)
    rates, tones = _voices(s_n)
    ends = np.stack([fid.hop_frame_ends(cfg, steps * h, r, SR) for r in rates])
    mult = np.exp2(tones / 12).astype(np.float32)
    ctl = [np.minimum(1.0 / rates, cfg.interval).astype(np.float32), mult,
           ((8000.0 / SR) / np.sqrt(mult)).astype(np.float32), np.ones(s_n, np.float32)]
    if formants:
        ctl += [np.exp2(np.linspace(-5.0, 5.0, s_n) / 12).astype(np.float32),
                (np.arange(s_n) % 2).astype(np.float32), np.zeros(s_n, np.float32)]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = int(steps * h * cfg.interval * rates.max()) + 2 * cfg.block
    return (cfg, _tracks(s_n, n, seed, device),
            [to(ends[:, k * h:(k + 1) * h]) for k in range(steps)], [to(c) for c in ctl])


def _seqpar_inputs(s_n: int, seconds: float, seed: int, device):
    """The fast preset with formants; audio long enough for the fastest rate."""
    from bauklank_tpu_torch.engine.config import preset_default
    from bauklank_tpu_torch.engine.params import StretchParams

    cfg = preset_default(2, SR)
    rates, tones = _voices(s_n)
    params = StretchParams.stack([StretchParams.make(rate=r, semitones=s, device=device)
                                  for r, s in zip(rates, tones)])
    n_out = int(round(seconds * SR))
    audio = _tracks(s_n, int(n_out * rates.max()) + 2 * cfg.block, seed, device)
    return cfg, audio, rates, params, n_out


def _leaves(tree) -> list:
    from bauklank_tpu_torch.utils.tree import keyed_leaves

    return [x for _, x in keyed_leaves(tree)]


def _run_counted(fn, steps: list, device="cuda"):
    """Run ``fn(state, *args)`` over ``steps`` from the first step's state,
    with the launch counts set to 0 before and read after.  Returns
    (final state, outputs, ms a step, counts)."""
    from bauklank_tpu_torch import kernels

    state, outs, ms = steps[0][0], [], []
    kernels.reset_launches()
    for _, *args in steps:
        _sync(device)
        t0 = time.perf_counter()
        state, out = fn(state, *args)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return state, outs, ms, dict(kernels.LAUNCHES)


def _check_counts(what: str, counts: dict, per_step: dict, steps: int, launches: dict) -> None:
    want = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, not {steps} x {per_step}")
    for k, v in counts.items():
        launches[k] += v


def _in_turns(fn_a, fn_b, state_a, state_b, args_a, args_b, pairs: int, device) -> tuple:
    """ms a step of ``fn_a`` and ``fn_b``, stepped in turns (a b, b a, ...)
    from their own states on the same arguments."""
    ms = ([], [])
    for r in range(pairs):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            _sync(device)
            t0 = time.perf_counter()
            if which == 0:
                state_a, _ = fn_a(state_a, *args_a)
            else:
                state_b, _ = fn_b(state_b, *args_b)
            _sync(device)
            ms[which].append((time.perf_counter() - t0) * 1e3)
    return ms


def _local(tree):
    return [x.to_local() for x in _leaves(tree)]


def _same(what: str, sharded_outs, sharded_state, outs, state) -> None:
    import torch

    for k, (a, b) in enumerate(zip(sharded_outs, outs)):
        if not torch.equal(a.to_local(), b):
            raise AssertionError(f"{what}: step {k} differs from the unsharded step by "
                                 f"{float((a.to_local() - b).abs().max())}")
    for a, b in zip(_local(sharded_state), _leaves(state)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: the carried state differs from the unsharded step's")


def stream_dp_one_rank(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """World size 1 on NCCL in this process: each sharded step of
    ``parallel.mesh`` at full width, held bit-equal to the unsharded
    batched function on the same inputs, both timed."""
    import torch

    from bauklank_tpu_torch.engine import fidelity as fid
    from bauklank_tpu_torch.engine.batched import batched_process_chunk, init_batched_state
    from bauklank_tpu_torch.parallel import shard_streams, sharded_step, stream_mesh
    from bauklank_tpu_torch.parallel.mesh import (
        sharded_fidelity_step, sharded_live_fidelity_step)

    mesh = stream_mesh(device_type=torch.device(device).type)
    kinds = {}

    s_n, h = P10["fast"]
    cfg, audio, ends, params = _fast_inputs(s_n, h, 2, seed, device)
    sh = shard_streams(mesh, (init_batched_state(cfg, s_n, device), audio, *ends, params))
    step = sharded_step(cfg, mesh)
    kinds[f"sharded_step (fast, S={s_n} H={h})"] = (
        lambda st, e: step(st, sh[1], e, sh[-1]),
        [(sh[0], sh[2]), (None, sh[3])],
        lambda st, e: batched_process_chunk(cfg, st, audio, e, params),
        [(init_batched_state(cfg, s_n, device), ends[0]), (None, ends[1])],
        {"frames_windowed": 1, "banded_interp": 1})

    s_n, h = P10["fidelity"]
    for formants in (False, True):
        cfg_f, audio_f, ends_f, ctl = _fidelity_inputs(s_n, h, 2, seed + 1, device, formants)
        sh_f = shard_streams(mesh, (fid.init_batched_fidelity_state(cfg_f, s_n, device),
                                    audio_f, *ends_f, *ctl))
        step_f = sharded_fidelity_step(cfg_f, mesh, formants=formants)
        kinds[f"sharded_fidelity_step (preset, S={s_n} H={h}"
              f"{', formants' if formants else ''})"] = (
            lambda st, e, step_f=step_f, sh_f=sh_f: step_f(st, sh_f[1], e, *sh_f[4:]),
            [(sh_f[0], sh_f[2]), (None, sh_f[3])],
            lambda st, e, cfg_f=cfg_f, audio_f=audio_f, ctl=ctl: fid.batched_fidelity_chunk(
                cfg_f, st, audio_f, e, *ctl),
            [(fid.init_batched_fidelity_state(cfg_f, s_n, device), ends_f[0]), (None, ends_f[1])],
            {"frames_windowed": 1, "smooth_pair": 2 if formants else 1, "comp_cumsum": 1,
             "frac_gather": 3 if formants else 2, "band_chain": h})

    s_n, h = P10["live"]
    cfg_l, chunks, _, ctl_l = _fidelity_inputs(s_n, h, 2, seed + 2, device)
    n = h * cfg_l.interval
    chunks = [chunks[..., k * n:(k + 1) * n].contiguous() for k in range(2)]
    sh_l = shard_streams(mesh, (fid.init_batched_live_fidelity_state(cfg_l, h, s_n, device),
                                *chunks, *ctl_l[1:]))
    step_l = sharded_live_fidelity_step(cfg_l, h, mesh)
    kinds[f"sharded_live_fidelity_step (preset, S={s_n} H={h})"] = (
        lambda st, c: step_l(st, c, *sh_l[3:]),
        [(sh_l[0], sh_l[1]), (None, sh_l[2])],
        lambda st, c: fid.batched_live_fidelity_chunk(cfg_l, st, c, *ctl_l[1:]),
        [(fid.init_batched_live_fidelity_state(cfg_l, h, s_n, device), chunks[0]),
         (None, chunks[1])],
        {"frames_windowed": 1, "smooth_pair": 1, "comp_cumsum": 1, "frac_gather": 2,
         "band_chain": h})

    for what, (sharded, sh_steps, plain, steps, per_step) in kinds.items():
        plain(*steps[0])                    # first use of the geometry, untimed
        st_sh, outs_sh, ms_sh, counts = _run_counted(sharded, sh_steps, device)
        _check_counts(what, counts, per_step, len(sh_steps), launches)
        st, outs, ms, _ = _run_counted(plain, steps, device)
        _same(what, outs_sh, st_sh, outs, st)
        t_sh, t_pl = _in_turns(sharded, plain, st_sh, st, sh_steps[-1][1:], steps[-1][1:],
                               TIMED_PAIRS, device)
        log(f"[parallel] {what}, world size 1 ({torch.distributed.get_backend()}): bit-equal to "
            f"the unsharded step over {len(steps)} steps (ms a step sharded "
            f"{', '.join(f'{m:.2f}' for m in ms_sh)}, unsharded "
            f"{', '.join(f'{m:.2f}' for m in ms)}); then {TIMED_PAIRS} pairs in turns, median "
            f"(min-max) ms a step: sharded {np.median(t_sh):.2f} ({min(t_sh):.2f}-"
            f"{max(t_sh):.2f}), unsharded {np.median(t_pl):.2f} ({min(t_pl):.2f}-"
            f"{max(t_pl):.2f}); launches {counts} | {card}")
        torch.cuda.empty_cache()


def _seqpar_snr(cfg, audio, rates, params, got, n_out: int, device="cuda") -> list:
    """Each stream of a hop-sharded render against ``stretch_offline`` on
    the card, after the first block."""
    from bauklank_tpu_torch.engine.offline import stretch_offline
    from bauklank_tpu_torch.engine.params import StretchParams

    out = []
    for i in range(audio.shape[0]):
        want = stretch_offline(audio[i].cpu().numpy(), float(rates[i]), cfg,
                               params=StretchParams(*[f[i] for f in params]), n_out=n_out,
                               device=device)
        ref, g = want[:, cfg.block:], got[i][:, cfg.block:n_out]
        out.append(float(10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - g) ** 2), 1e-30))))
    return out


def seqpar_one_rank(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """``stretch_offline_sharded`` on a (1, 1) mesh on NCCL: 8 streams,
    60 s out each (2,000 hops), against ``stretch_offline`` on the card."""
    import torch

    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

    s_n, seconds = P10["seqpar"]
    cfg, audio, rates, params, n_out = _seqpar_inputs(s_n, seconds, seed + 3, device)
    mesh = stream_seq_mesh(1, 1, device_type=torch.device(device).type)
    ops, renders = {}, 0

    def render(_, a):
        # the first render records each kernel's operands at the seqpar grid
        nonlocal renders
        renders += 1
        with (capture_operands(ops, "fast") if renders == 1 else contextlib.nullcontext()):
            return None, stretch_offline_sharded(a, rates, cfg, params, n_out, mesh)

    _, outs, ms, counts = _run_counted(render, [(None, audio), (None, audio)], device)
    _check_counts("stretch_offline_sharded (1, 1), twice", counts,
                  {"frames_windowed": 1, "banded_interp": 3}, 2, launches)
    held = hold_to_plain(ops, "stretch_offline_sharded (1, 1)")
    ops.clear()
    if set(held) != SEQPAR_KERNELS:
        raise AssertionError(f"the render held {sorted(held)} to their plain versions, not "
                             f"{sorted(SEQPAR_KERNELS)}")
    log(f"[parallel] stretch_offline_sharded (1, 1): each kernel call of the first render "
        f"against its plain version on the same operands: "
        + "; ".join(f"{k} at {', '.join(sh)} max_abs_err={e!r}" for k, (e, sh) in held.items())
        + f" (bound {TOLERANCE}) | {card}")
    if not torch.equal(outs[0].to_local(), outs[1].to_local()):
        raise AssertionError("two hop-sharded renders of the same input differ")
    got = outs[1].to_local()[..., :n_out].cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("non-finite hop-sharded render")
    snr = _seqpar_snr(cfg, audio, rates, params, got, n_out, device)
    log(f"[parallel] stretch_offline_sharded, (1, 1) mesh ({torch.distributed.get_backend()}), "
        f"{s_n} streams x {n_out / SR:.0f} s ({-(-n_out // cfg.interval)} hops, formants), "
        f"rendered twice: {ms[0] / 1e3:.3f} s wall the first time (first use of its shapes, "
        f"kernel operands copied aside), "
        f"{ms[1] / 1e3:.3f} s the second, aggregate RTF "
        f"{s_n * n_out / SR / (ms[0] / 1e3):.1f}x; {s_n * n_out / SR / (ms[1] / 1e3):.1f}x; "
        f"against stretch_offline on the card after the first block "
        f"{', '.join(f'{s:.2f}' for s in snr)} dB (bound > {SEQPAR_DB}); launches {counts} "
        f"| {card}")
    if not min(snr) > SEQPAR_DB:
        raise AssertionError(f"hop-sharded render under {SEQPAR_DB} dB: {snr}")


def _phase10_rank(rank: int, store: str, out_dir: str, seed: int, device: str,
                  shapes: dict) -> None:
    """One of four ranks sharing the card (gloo; compute on ``cuda:0``):
    the hop-sharded render on a 2 x 2 mesh, then the fidelity step over a
    four-rank stream mesh.  Writes its pieces, launch counts and times
    under ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from bauklank_tpu_torch.engine import fidelity as fid
    from bauklank_tpu_torch.parallel import shard_streams, stream_mesh
    from bauklank_tpu_torch.parallel.mesh import sharded_fidelity_step
    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        report = {"backend": dist.get_backend()}
        kind = torch.device(device).type
        cfg, audio, rates, params, n_out = _seqpar_inputs(*shapes["seqpar4"], seed + 4, device)
        mesh = stream_seq_mesh(2, 2, device_type=kind)
        ops = {}
        with capture_operands(ops, "fast"):
            _, outs, ms, report["seqpar_counts"] = _run_counted(
                lambda _, a: (None, stretch_offline_sharded(a, rates, cfg, params, n_out, mesh)),
                [(None, audio)], device)
        report["seqpar_ms"] = ms[0]
        report["seqpar_held"] = hold_to_plain(ops, f"stretch_offline_sharded (2, 2), rank {rank}")
        ops.clear()
        np.save(os.path.join(out_dir, f"seqpar{rank}.npy"), outs[0].to_local().cpu().numpy())
        s_n, h = shapes["fidelity"]
        cfg_f, audio_f, ends_f, ctl = _fidelity_inputs(s_n, h, 2, seed + 5, device)
        smesh = stream_mesh(device_type=kind)
        step = sharded_fidelity_step(cfg_f, smesh)
        sh = shard_streams(smesh, (fid.init_batched_fidelity_state(cfg_f, s_n, device),
                                   audio_f, *ends_f, *ctl))
        _, outs, report["dp_ms"], report["dp_counts"] = _run_counted(
            lambda st, e: step(st, sh[1], e, *sh[4:]), [(sh[0], sh[2]), (None, sh[3])], device)
        for k, out in enumerate(outs):
            np.save(os.path.join(out_dir, f"dp{rank}_{k}.npy"), out.to_local().cpu().numpy())
        with open(os.path.join(out_dir, f"report{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def four_ranks_one_card(seed: int, card: str, launches: dict, tmp: str,
                        device: str = "cuda") -> None:
    """Four spawned ranks on the one card (gloo): the hop-sharded render
    on a 2 x 2 mesh against ``stretch_offline``, and the fidelity step over
    a four-rank stream mesh (32 streams a rank) against the unsharded
    step: bit-equal, or, if cuFFT's batch width rounds otherwise, the
    card's stage gate (>= 80 dB a voice)."""
    import torch
    import torch.multiprocessing as mp

    from bauklank_tpu_torch.engine import fidelity as fid

    t0 = time.perf_counter()
    ctx = mp.start_processes(_phase10_rank,
                             args=(os.path.join(tmp, "store4"), tmp, seed, device, dict(P10)),
                             nprocs=4, join=False, start_method="spawn")
    end = time.monotonic() + PARALLEL_DEADLINE_SEC
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise AssertionError(f"the four ranks did not finish within "
                                     f"{PARALLEL_DEADLINE_SEC} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
    wall = time.perf_counter() - t0
    reports = []
    for r in range(4):
        with open(os.path.join(tmp, f"report{r}.json")) as f:
            reports.append(json.load(f))
    backends = sorted({r["backend"] for r in reports})
    for r in reports:
        _check_counts("a rank's stretch_offline_sharded (2, 2)", r["seqpar_counts"],
                      {"frames_windowed": 1, "banded_interp": 3}, 1, launches)
        _check_counts("a rank's sharded_fidelity_step", r["dp_counts"],
                      {"frames_windowed": 1, "smooth_pair": 1, "comp_cumsum": 1,
                       "frac_gather": 2, "band_chain": P10["fidelity"][1]}, 2, launches)

    # the 2 x 2 render: rank r holds the streams of stream rank r // 2 and
    # the hops of seq rank r % 2
    cfg, audio, rates, params, n_out = _seqpar_inputs(*P10["seqpar4"], seed + 4, device)
    pieces = [np.load(os.path.join(tmp, f"seqpar{r}.npy")) for r in range(4)]
    got = np.concatenate([np.concatenate(pieces[2 * s:2 * s + 2], axis=-1) for s in range(2)])
    snr = _seqpar_snr(cfg, audio, rates, params, got, n_out, device)
    log(f"[parallel] stretch_offline_sharded, 2 x 2 mesh of four ranks on one card "
        f"({'/'.join(backends)}), {audio.shape[0]} streams x {n_out / SR:.0f} s: a rank's wall "
        f"{max(r['seqpar_ms'] for r in reports) / 1e3:.3f} s (kernel operands copied aside); "
        f"each rank's kernel calls against their plain versions on the same operands: "
        + "; ".join(f"rank {r} " + ", ".join(f"{k} at {' | '.join(sh)} max_abs_err={e!r}"
                                             for k, (e, sh) in rep["seqpar_held"].items())
                    for r, rep in enumerate(reports))
        + f" (bound {TOLERANCE}); against stretch_offline on the "
        f"card {', '.join(f'{s:.2f}' for s in snr)} dB (bound > {SEQPAR_DB}) | {card}")
    for rep in reports:
        if set(rep["seqpar_held"]) != SEQPAR_KERNELS:
            raise AssertionError(f"a rank held {sorted(rep['seqpar_held'])} to their plain "
                                 f"versions, not {sorted(SEQPAR_KERNELS)}")
    if not min(snr) > SEQPAR_DB:
        raise AssertionError(f"the four-rank hop-sharded render under {SEQPAR_DB} dB: {snr}")

    s_n, h = P10["fidelity"]
    cfg_f, audio_f, ends_f, ctl = _fidelity_inputs(s_n, h, 2, seed + 5, device)
    state = fid.init_batched_fidelity_state(cfg_f, s_n, device)
    worst, equal = float("inf"), True
    for k, e in enumerate(ends_f):
        state, out = fid.batched_fidelity_chunk(cfg_f, state, audio_f, e, *ctl)
        want = out.cpu()
        got = torch.from_numpy(np.concatenate(
            [np.load(os.path.join(tmp, f"dp{r}_{k}.npy")) for r in range(4)]))
        equal = equal and torch.equal(got, want)
        for i in range(s_n):
            worst = min(worst, _snr(want[i], got[i]))
    log(f"[parallel] sharded_fidelity_step over four ranks on one card ({'/'.join(backends)}), "
        f"S={s_n} ({s_n // 4} a rank), 2 steps: "
        f"{'bit-equal to' if equal else 'not bit-equal to'} the "
        f"unsharded step; worst voice {worst:.2f} dB (gate {PARITY_DB} dB); a rank's ms a "
        f"step {', '.join(f'{m:.2f}' for m in reports[0]['dp_ms'])} (four ranks sharing the "
        f"card); phase 10's four ranks took {wall:.1f} s | {card}")
    if not (equal or worst >= PARITY_DB):
        raise AssertionError(f"the four-rank fidelity step disagrees: worst voice {worst} dB")


def hop_forms(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """The per-hop form (``batched_fidelity_chunk_scan``) against the
    serving step at the preset, chunk by chunk from the same state, with
    JAX's bars, and the launches of each; then the one-stream hop scan
    against the plain band chain."""
    import torch

    from bauklank_tpu_torch.engine import fidelity as fid
    from bauklank_tpu_torch.engine import spectral
    from bauklank_tpu_torch.utils.tree import tree_map

    s_n, h = P10["fidelity"]
    cfg, audio, ends, ctl = _fidelity_inputs(s_n, h, 2, seed + 6, device)
    state = fid.init_batched_fidelity_state(cfg, s_n, device)
    for k, e in enumerate(ends):
        sa, outs_a, ms_a, counts_a = _run_counted(
            lambda st, e: fid.batched_fidelity_chunk(cfg, st, audio, e, *ctl), [(state, e)],
            device)
        _check_counts("batched_fidelity_chunk", counts_a, {"frames_windowed": 1,
                      "smooth_pair": 1, "comp_cumsum": 1, "frac_gather": 2, "band_chain": h},
                      1, launches)
        sb, outs_b, ms_b, counts_b = _run_counted(
            lambda st, e: fid.batched_fidelity_chunk_scan(cfg, st, audio, e, *ctl), [(state, e)],
            device)
        _check_counts("batched_fidelity_chunk_scan", counts_b, {"frames_windowed": 1,
                      "smooth_pair": h, "comp_cumsum": h, "frac_gather": 2 * h,
                      "band_chain": h}, 1, launches)
        emit = float((outs_a[0] - outs_b[0]).abs().max())
        leaf = max(float(((a - b).abs() - 2e-4 * b.abs()).max())
                   for a, b in zip(_leaves(sa), _leaves(sb)) if a.is_floating_point()
                   or a.is_complex())
        rng = bool(torch.equal(sa[0].rng, sb[0].rng))
        log(f"[parallel] batched_fidelity_chunk_scan against batched_fidelity_chunk (preset, "
            f"S={s_n} H={h}), chunk {k}: emit max |diff| {emit!r} (bound {SCAN_ATOL}), state "
            f"leaves max |diff| - 2e-4 |b| {leaf!r} (bound {SCAN_ATOL}), rng equal {rng}; "
            f"ms {ms_a[0]:.2f} hoisted, {ms_b[0]:.2f} per hop; launches {counts_a} and "
            f"{counts_b} | {card}")
        if not (emit <= SCAN_ATOL and leaf <= SCAN_ATOL and rng):
            raise AssertionError(f"the per-hop form disagrees: {emit}, {leaf}, {rng}")
        state = sb

    # the one-stream hop scan (spectral_hop a hop, the body of _render_jit):
    # kernel 4 at one stream, held bit-equal to the plain chain
    cur, prev = fid._analyse_cur_prev(cfg, audio[:1], ends[0][:1])
    one = [c[0] for c in ctl[:3]]
    st0 = spectral.init_spectral_state(cfg, device)
    st_k, outs_k, ms_k, counts_k = _run_counted(
        lambda st, c, p: fid._scan_hops(cfg, st, c, p, *one), [(st0, cur[:, 0], prev[:, 0])],
        device)
    _check_counts("_scan_hops", counts_k, {"smooth_pair": h, "comp_cumsum": h,
                  "frac_gather": 2 * h, "band_chain": h}, 1, launches)
    st_p, outs_p = tree_map(lambda x: x[None], st0), []
    for i in range(h):
        st_p, out = spectral.spectral_hop_batched(cfg, st_p, cur[i, :1], prev[i, :1],
                                                  *(c[:1] for c in ctl[:3]), use_kernel=False)
        outs_p.append(out[0])
    equal = torch.equal(outs_k[0], torch.stack(outs_p)) and all(
        torch.equal(a, b[0]) for a, b in zip(st_k, st_p))
    log(f"[parallel] _scan_hops (one stream of the preset, H={h}) against the plain band chain "
        f"a hop: {'bit-equal' if equal else 'differs'}; {ms_k[0]:.2f} ms; launches {counts_k} "
        f"| {card}")
    if not equal:
        raise AssertionError("the one-stream hop scan differs from the plain band chain")


def parallel_paths(seed: int, card: str, launches: dict, device: str = "cuda") -> None:
    """Phase 10 minus the per-hop forms: world size 1 on NCCL in this
    process (a ``file://`` store in a temporary directory), then four
    spawned ranks sharing the card."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store1", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            stream_dp_one_rank(seed, card, launches, device)
            seqpar_one_rank(seed, card, launches, device)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        four_ranks_one_card(seed, card, launches, tmp, device)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="smoke run of bauklank_tpu_torch on one GPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 9's inputs (tones and noise)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    sys.path.insert(0, ROOT)
    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.kernels import build

    # 1. device
    t_start = time.perf_counter()
    global CARD
    card = CARD = card_line()
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
    from bauklank_tpu_torch.kernels.bandchain import band_step_cycles, root_ratio_mismatches

    cyc = band_step_cycles()
    STEP_CYCLES.update(cyc)
    log(f"[bound] one warp alone, cycles: a dependent float add {cyc['fadd_dependent']:.2f}; "
        f"band_chain's step from registers "
        f"{cyc['step_2ch']:.1f} (2 channels), {cyc['step_2ch_long_step_1']:.1f} (2 channels, "
        f"long_step 1), {cyc['step_1ch']:.1f} (1 channel), against the bound's "
        f"{CHAIN_DEPTH['band_chain'] * DEP_CYCLES}: at {mhz:.0f} MHz "
        f"{3072 * cyc['step_2ch'] / (mhz * 1e3):.4f} ms for 3072 bands, "
        f"{5120 * cyc['step_2ch_long_step_1'] / (mhz * 1e3):.4f} ms for 5120 at long_step 1 "
        f"| {card}")
    wrong = root_ratio_mismatches(1 << 30)
    log(f"[kernel] band_chain's branch-free sqrt(a / b) against __fsqrt_rn(__fdiv_rn()) on 2^30 "
        f"random pairs of its range: {wrong} differ")
    if wrong:
        raise AssertionError(f"root_ratio_fast rounds otherwise on {wrong} pairs")
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
        if pool.engine == "fidelity":
            # kernel 8 at the one-hop cell's rows (S = 64, H = 1: the
            # preset's first 64) and at 512 kiosk rows (two copies)
            e, coef = ops["smooth_pair"][0]
            rows = e[:64] if kind == "preset" else torch.cat([e, e])[:512]
            compare_kernels({"smooth_pair": [(rows.contiguous(), coef)]}, f"{kind}-rows",
                            results, mhz)
        if kind == "preset":
            gather_args = ops["frac_gather"][0]
            # kernel 7: the next step of the same pool with the fused fetch
            ops = {}
            with chainfetch_switch(True), capture_operands(ops, "fidelity"):
                pool.step(fetch=True)
            if set(ops) != {"frames_windowed", "smooth_pair", "comp_cumsum", "chainfetch",
                            "band_chain"}:
                raise AssertionError(f"the fused step called {sorted(ops)}")
            compare_kernels({"chainfetch": ops["chainfetch"]}, "preset-fused", results, mhz)
            # the formant chain's envelope lookup, a third, one-plane gather:
            # a step with one formant voice
            ops = {}
            if not pool.apply_set("s05", "formantSemitones", 4.0, lookahead=0.0):
                raise RuntimeError("formant control refused")
            with capture_operands(ops, "fidelity"):
                pool.step(fetch=True)
            lookup = [a for a in ops["frac_gather"] if a[0].shape[2] == 1]
            if len(ops["frac_gather"]) != 3 or len(lookup) != 1:
                raise AssertionError("the formant step made no one-plane gather")
            per_row = [a for a in ops["smooth_pair"] if hasattr(a[1], "shape")]
            if len(ops["smooth_pair"]) != 2 or len(per_row) != 1:
                raise AssertionError("the formant step smoothed no envelope")
            compare_kernels({"frac_gather": lookup, "smooth_pair": per_row}, "preset-formant",
                            results, mhz)
        if kind == "fast":
            # the envelope gathers: a step with one formant voice
            ops = {}
            if not pool.apply_set("s05", "formantSemitones", 4.0, lookahead=0.0):
                raise RuntimeError("formant control refused")
            with capture_operands(ops, "fast"):
                pool.step(fetch=True)
            if len(ops["banded_interp"]) != 2 or len(ops["banded_interp_complex"]) != 1:
                raise AssertionError(f"formant step gathered {len(ops['banded_interp'])} "
                                     "envelopes")
            compare_kernels({"banded_interp": ops["banded_interp"]}, "fast-formant",
                            results, mhz)
        del pool, ops
        torch.cuda.empty_cache()
    front_bucket_frames(results, mhz)
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
    # the fidelity pools again with the analysis as it ran before kernel 1
    # wrote padded rows (the plain rows, padded by PyTorch): the same master
    for kind in ("preset", "kiosk"):
        with plain_frame_rows():
            _, master = step_pool(make_pool(kind, "cuda"), 2, timed[kind])
        if not np.array_equal(master, served[kind][1]):
            diff = float(np.abs(master - served[kind][1]).max())
            raise AssertionError(f"{kind}: the master on the padded rows differs from the "
                                 f"plain rows' by {diff}")
        log(f"[serve] {kind} master on the padded frame rows equals the plain rows padded by "
            f"PyTorch bit for bit over {master.shape[-1]} samples")
    torch.cuda.empty_cache()
    # the fidelity preset pool with a formant voice: the envelope lookup is a
    # third frac_gather launch a step and its smoothing a second smooth_pair;
    # the fast pool: three gathers a step
    for kind, per_step in (("preset", {**PER_STEP["preset"], "frac_gather": 3,
                                       "smooth_pair": 2}),
                           ("fast", {**PER_STEP["fast"], "banded_interp": 3})):
        pool = pools[kind]
        if not pool.apply_set("s05", "formantSemitones", 4.0, lookahead=0.0):
            raise RuntimeError("formant control refused")
        kernels.reset_launches()
        before = pool.metrics()
        t0 = time.perf_counter()
        masters = [pool.step(fetch=True)[0] for _ in range(5)]
        dt = (time.perf_counter() - t0) / 5
        counts = dict(kernels.LAUNCHES)
        issued = issued_steps(pool, before)
        if not np.isfinite(np.concatenate(masters, axis=-1)).all():
            raise AssertionError(f"non-finite {kind} master with a formant voice")
        if counts != {k: issued * per_step.get(k, 0) for k in counts}:
            raise AssertionError(f"{kind} formant steps launched {counts}, not {issued} x "
                                 f"{per_step}")
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

    # 7. where the time goes: the step graphs against the eager step, then a profile
    for kind in ("preset", "preset-fused", "kiosk", "fast"):
        graphs_against_eager(kind, pools[kind], served[kind], 2, timed[kind], card)
    for kind, pool in pools.items():
        where_time_goes(kind, pool, 5, step_ms[kind], card)
    del pools, pool
    torch.cuda.empty_cache()

    # 8. the serving front door: UnifiedPool (both engines), StretchNode,
    # the band chain past long_step 16, the sequential kernels at S = 4, 8
    t8 = time.perf_counter()
    for engine in ("fidelity", "fast"):
        front_door_pool(engine, "cuda", card, launches)
        torch.cuda.empty_cache()
    front_door_nodes("cuda", card, launches)
    long_step_chains(mhz, results)
    log(f"[front] phase 8 took {time.perf_counter() - t8:.1f} s")

    # 9. the server and the CLI as a user starts them
    t9 = time.perf_counter()
    cli_stretch(opts.seed, card, launches)
    serve_setups(opts.seed, card, launches)
    log(f"[server] phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. the parallel paths and the per-hop forms
    t10 = time.perf_counter()
    parallel_paths(opts.seed, card, launches)
    hop_forms(opts.seed, card, launches)
    log(f"[parallel] phase 10 took {time.perf_counter() - t10:.1f} s")

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
