#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bauklank_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero without the result line):

1. device: the card's name and power limit, TF32 off;
2. build the four CUDA kernels from ``bauklank_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, on operands
   captured from one step of the preset serving pool (S=128, H=8,
   120/30 ms) and of the kiosk pool (S=64, H=4, 200/200 ms, rate 0.001),
   with both times;
4. each stage of the step on the card against the same stage on the host
   CPU, fed the same inputs (the CPU path is the one the tests hold
   against the JAX package): the MDFT within a relative bound, every
   stage's output >= 80 dB SNR;
5. three golden cases rendered on the card through the serving form,
   each > 40 dB against the blob renders in tests/golden/golden_v1.npz;
6. serving: the 128-voice preset pool and the 64-voice kiosk pool driven
   through ``StreamPool`` (tracks, starts, ``set`` messages through
   ``protocol.parse_line`` and ``apply_set``), 2 warm-up and 10 timed
   steps each, with every kernel launch counted;
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
# the step's record_function ranges, with the kernels each launches (the
# profiler does not link a kernel launched through ctypes to its range)
STAGES = {"fidelity.analyse": ("frames_windowed",),
          "fidelity.chain_inputs": ("comp_cumsum", "frac_gather"),
          "fidelity.hop_loop": ("band_chain",),
          "fidelity.synthesis": ()}
KERNELS = {
    # name: (source, the TPU kernel's pl.pallas_call it replaces)
    "frames_windowed": ("bauklank_tpu_torch/csrc/frames.cu",
                        "bauklank_tpu/ops/pallas/frames.py:122"),
    "comp_cumsum": ("bauklank_tpu_torch/csrc/compsum.cu",
                    "bauklank_tpu/ops/pallas/compsum.py:103"),
    "frac_gather": ("bauklank_tpu_torch/csrc/frac_gather.cu",
                    "bauklank_tpu/ops/pallas/wintaps.py:129"),
    "band_chain": ("bauklank_tpu_torch/csrc/bandchain.cu",
                   "bauklank_tpu/ops/pallas/bandchain.py:149"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
def capture_operands(store: dict):
    """Record the first operands each kernel wrapper gets on the main path
    (the engine modules hold the wrappers by name; frac_gather keeps its
    first two call shapes: the five-family and the prev|energy gather)."""
    from bauklank_tpu_torch.engine import fidelity, spectral

    sites = [(fidelity, "frames_windowed"), (spectral, "comp_cumsum"),
             (spectral, "frac_gather"), (spectral, "band_chain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def recorder(name, fn):
        def call(*args):
            calls = store.setdefault(name, [])
            if len(calls) < (2 if name == "frac_gather" else 1):
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


def make_pool(kind: str, device: str):
    """The preset serving pool (S=128, H=8, 120/30 ms) or the kiosk pool
    (S=64, H=4, StretchConfig(8820, 8820) as the unified pool builds it),
    with tonal tracks loaded, voices started and a few ``set`` messages
    applied."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from golden_wasm import material

    from bauklank_tpu_torch.engine.config import StretchConfig
    from bauklank_tpu_torch.serve import protocol
    from bauklank_tpu_torch.serve.pool import StreamPool

    if kind == "preset":
        pool = StreamPool(capacity=128, hops_per_step=8, engine="fidelity", device=device)
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


def compare_kernels(ops: dict, tag: str, results: dict) -> None:
    """Each captured kernel call against its plain version on the card."""
    import torch

    from bauklank_tpu_torch.kernels.bandchain import band_chain, band_chain_ref
    from bauklank_tpu_torch.kernels.compsum import comp_cumsum, comp_cumsum_ref
    from bauklank_tpu_torch.kernels.frames import frames_windowed, frames_windowed_ref
    from bauklank_tpu_torch.kernels.gather import frac_gather, frac_gather_ref

    pairs = {
        "frames_windowed": (frames_windowed, frames_windowed_ref),
        "comp_cumsum": (comp_cumsum, comp_cumsum_ref),
        "frac_gather": (frac_gather, frac_gather_ref),
        "band_chain": (band_chain, band_chain_ref),
    }
    for name, (kern, ref) in pairs.items():
        for j, args in enumerate(ops[name]):
            got, want = kern(*args), ref(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ms = cuda_ms(lambda: kern(*args), reps=20, warm=2)
            plain_reps = 2 if name in ("band_chain", "comp_cumsum") else 10
            plain_ms = cuda_ms(lambda: ref(*args), reps=plain_reps, warm=1)
            shapes = " ".join(str(tuple(a.shape)) for a in args if hasattr(a, "shape"))
            log(f"[kernel] {tag} {name}#{j} {shapes}: max_abs_err={err!r} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not finite or err > TOLERANCE:
                raise AssertionError(f"{name} ({tag}) disagrees with its plain version: {err}")
            if tag == "preset" and j == 0:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _snr(ref, got) -> float:
    """10 log10(sum |ref|^2 / sum |ref - got|^2) over a whole tensor."""
    import torch

    wide = torch.complex128 if ref.is_complex() else torch.float64
    ref, got = ref.detach().cpu().to(wide), got.detach().cpu().to(wide)
    err = float((ref - got).abs().square().sum())
    return float("inf") if err == 0 else float(10 * np.log10(float(ref.abs().square().sum()) / err))


def device_parity() -> None:
    """Each stage of the step on the card against the same stage on the
    host CPU, both fed the CPU's inputs to that stage: four streams (rates
    0.5, 1.3, 0.25, 0.001; the last inactive) from a mid-stream state, in
    the small test geometries and the preset one.  Fed its own inputs the
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
    cuda = lambda tree: (tree.cuda() if isinstance(tree, torch.Tensor)
                         else type(tree)(*map(cuda, tree)) if hasattr(tree, "_fields")
                         else {k: cuda(v) for k, v in tree.items()} if isinstance(tree, dict)
                         else type(tree)(map(cuda, tree)))
    for tag, block, interval, split, h in (
            ("small", 1024, 256, True, 4), ("small split-off", 1024, 256, False, 4),
            ("small L=1", 1024, 1024, True, 4), ("preset", 5292, 1323, True, 8)):
        cfg = fid.SpectralConfig(2, block, interval, split=split)
        src = material.case_input(2.0, 2, seconds=2.0)
        audios = t(np.stack([np.roll(src, 977 * i, axis=-1) for i in range(len(rates))]))
        ends = t(np.stack([fid.hop_frame_ends(cfg, 2 * h, r, SR, split=split) for r in rates]))
        mult = np.exp2(np.asarray(tones) / 12).astype(np.float32)
        tf, mult, limit, act = (t(v) for v in (
            np.asarray([min(1 / r, interval) for r in rates], np.float32), mult,
            ((8000 / SR) / np.sqrt(mult)).astype(np.float32), active))
        # a mid-stream state: one chunk on the CPU
        (spec, tails), _ = fid.batched_fidelity_chunk(
            cfg, fid.init_batched_fidelity_state(cfg, len(rates), "cpu"), audios,
            ends[:, :h], tf, mult, limit, act)
        e = ends[:, h:]

        snr = {}
        cur, prev = fid._analyse_cur_prev(cfg, audios, e)
        g = fid._analyse_cur_prev(cfg, audios.cuda(), e.cuda())
        snr["1 analyses cur"], snr["1 analyses prev"] = _snr(cur, g[0]), _snr(prev, g[1])
        xs, carried = spectral.chain_inputs_hops(cfg, spec, cur, prev, tf, mult, limit)
        g_xs, g_carried = spectral.chain_inputs_hops(
            cfg, cuda(spec), cur.cuda(), prev.cuda(), tf.cuda(), mult.cuda(), limit.cuda())
        for k in xs:
            if k != "mc":
                snr[f"2 chain inputs {k}"] = _snr(xs[k], g_xs[k])
        mc_same = float((xs["mc"] == g_xs["mc"].cpu()).double().mean())
        rng_same = bool(torch.equal(carried[0], g_carried[0].cpu()))
        outs = fid._hop_loop(cfg, spec.prev_output, xs)
        snr["3 hop loop"] = _snr(outs, fid._hop_loop(cfg, spec.prev_output.cuda(), cuda(xs)))
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
            + f"; mc equal {mc_same:.6f}, rng equal {rng_same} "
            f"(bounds {PARITY_DB} dB, mc {PARITY_MC})")
        bad = {k: v for k, v in snr.items() if not v >= PARITY_DB}
        if bad or mc_same < PARITY_MC or not rng_same:
            raise AssertionError(f"{tag}: the card's stages disagree with the CPU's: "
                                 f"{bad}, mc {mc_same}, rng {rng_same}")


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
    return dt, float(np.abs(master).max())


def where_time_goes(pool, steps: int, step_ms: float, card: str) -> None:
    """Profile ``steps`` pool steps: the card's busy share, each stage's
    host and device time (the engine's ``record_function`` ranges), and
    the kernels that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    kind = "preset" if pool.capacity == 128 else "kiosk"
    log(f"[profile] {kind}: device busy {busy:.3f} ms/step; profiled wall {wall:.3f} ms/step "
        f"({busy / wall:.1%} busy); unprofiled step {step_ms:.3f} ms "
        f"({busy / step_ms:.1%} busy) | {card}")
    per_kernel: dict = {}
    for e in dev_events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.self_device_time_total
    for name, own in STAGES.items():
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    sys.path.insert(0, ROOT)
    from bauklank_tpu_torch import kernels
    from bauklank_tpu_torch.kernels import build

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

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
    for kind in ("preset", "kiosk"):
        ops: dict = {}
        pool = make_pool(kind, "cuda")
        with capture_operands(ops):
            pool.step(fetch=True)
        compare_kernels(ops, kind, results)
        del pool, ops
        torch.cuda.empty_cache()

    # 4. each stage of the step on the card against the host CPU's
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    device_parity()

    # 5. golden cases on the card
    from golden_wasm import material

    from bauklank_tpu_torch.engine.fidelity import render_fidelity

    golden = np.load(os.path.join(ROOT, "tests", "golden", "golden_v1.npz"))
    for name in ("r05_stp12", "r025_st0", "kiosk_r0001_st0"):
        _, rate, st, ch, extras = next(c for c in material.CASES if c[0] == name)
        t1 = time.perf_counter()
        got = render_fidelity(
            material.case_input(rate, ch), SR, int(material.SECONDS * SR), rate=rate,
            semitones=st, tonality_hz=material.TONALITY_HZ,
            seed=int(golden[name + "__seed"]) if name + "__seed" in golden.files else 1,
            device="cuda", **material.case_render_kwargs(extras))
        snr = material.snr_db(golden[name], got, material.case_skip(extras))
        log(f"[golden] {name}: {snr:.2f} dB ({time.perf_counter() - t1:.2f} s)")
        if not snr > 40.0:
            raise AssertionError(f"golden {name}: {snr:.2f} dB <= 40 dB")

    # 6. serving: the main path, with the launch counts
    pools = [(make_pool("preset", "cuda"), 2, 10), (make_pool("kiosk", "cuda"), 2, 10)]
    kernels.reset_launches()
    seen = dict(kernels.LAUNCHES)
    step_ms = []
    for pool, warm, timed in pools:
        dt, peak = step_pool(pool, warm, timed)
        step_ms.append(dt * 1e3)
        counts = {k: v - seen[k] for k, v in kernels.LAUNCHES.items()}
        seen = dict(kernels.LAUNCHES)
        kind = "preset" if pool.capacity == 128 else "kiosk"
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"{kind} pool never launched {missing}")
        s_n, h, interval = pool.capacity, pool.hops_per_step, pool.scfg.interval
        rtf = s_n * h * interval / SR / dt
        log(f"[serve] {kind}: S={s_n} H={h} block={pool.scfg.block} interval={interval} "
            f"fft={pool.scfg.fft} L={pool.scfg.long_step}: {dt * 1e3:.2f} ms/step, "
            f"aggregate RTF {rtf:.1f}x, master peak {peak:.4f}, launches {counts} | {card}")
        log(f"[serve] {kind} metrics {pool.metrics()}")
    launches = dict(kernels.LAUNCHES)

    # 7. where the time goes
    for (pool, _, _), ms in zip(pools, step_ms):
        where_time_goes(pool, 5, ms, card)
    del pools
    torch.cuda.empty_cache()

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
