"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (``setup_s``, from the start of the process to the first timed
step, less the kernel library's build or load): import the port, build
its pool, make every voice's audio from the seed on the device, load it
through ``load_track``, set each voice's controls and loop through
``apply_set``, and step ``warmup_steps`` times (the constant tables of
the first step, the first copy of the audio to the device).  The kernel
library is built (the first run in a checkout compiles it with ``nvcc``)
or loaded before the pool, and its time is reported apart
(``kernel_build_s``), so that ``setup_s`` is the set-up every run pays.

Window: ``pool.step(fetch=True)`` back to back for ``seconds``, each
call returning the master on the host, with the traffic's knob turns
sent through ``apply_set`` before the step that renders their output
time.  With ``trace`` the profiler records a bounded stretch of steady
steps inside the window.

The program is used only through ``StreamPool``, ``load_track``,
``apply_set`` and ``step``, besides the kernel library's load; its
carried state (``pool.states``) is read at the compared steps, and its
geometry is held to the configuration file's.  ``StreamPool`` gets the
eight arguments the harness sets from the cell (``HARNESS_SETS``) and
the configuration file's ``pool``, if it has one, as keyword arguments
exactly as the file states them.  No switch of the program is set:
``pool`` holds only a deployment's own settings as its public source
states them (the block, the interval, the range of a control), each
named in the file's ``source`` or ``assumed``; an environment variable
or the program's choice of path (``BAUKLANK_CHAINFETCH``) never goes
there.
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from portbench.core import check, spec, synth
from portbench.core.traffic import Traffic
from portbench.reference.drive import FORMANT_KEYS

FORBIDDEN = ("jax", "jaxlib", "flax", "bauklank_tpu")

# the arguments of ``StreamPool`` that the harness sets from the cell
HARNESS_SETS = ("capacity", "sample_rate", "channels", "max_track_sec", "names",
                "hops_per_step", "engine", "device")


def forbidden_modules(names=FORBIDDEN) -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (``bauklank_tpu_torch`` is not ``bauklank_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def _tree(x, fn):
    """Map ``fn`` over the tensors of a state: named tuples become dicts
    by field, other tuples lists."""
    if hasattr(x, "_fields"):
        return {f: _tree(getattr(x, f), fn) for f in x._fields}
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_tree(v, fn) for v in x]
    return fn(x)


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the window, the trace and the cell."""

    cell: spec.Cell
    geo: object
    voices: int
    hops: int
    step_times: list
    window_s: float
    setup_s: float
    trace: object = None
    semitones: np.ndarray = None     # each voice's last set value when the trace began

    @property
    def audio_s_per_step(self) -> float:
        return self.voices * self.hops * self.geo.interval / self.geo.sample_rate

    def roofline(self, kernel: str):
        """(least seconds a call, seconds a call as traced) of ``kernel``
        (``portbench/roofline/<kernel>.py``), or None if the trace holds
        no call of it."""
        if self.trace is None:
            return None
        mod = spec.roofline(self.cell.root, kernel)
        hit = self.trace.kernel(mod.KERNEL)
        if hit is None or hit[1] == 0:
            return None
        return mod.least_seconds(self), hit[0] / hit[1]


def _activities(device: str) -> list:
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if device == "cuda"
            else [ProfilerActivity.CPU])


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def pool_arguments(cfg: dict, stream_pool) -> dict:
    """The configuration file's ``pool``: keyword arguments of
    ``stream_pool`` (the program's ``StreamPool``), passed as the file
    states them.  Refused, before any pool is built: a key the harness
    sets from the cell, a key the program's signature lacks, a value that
    is not a JSON number, string or boolean."""
    given = cfg.get("pool", {})
    if not isinstance(given, dict):
        raise SystemExit(f"error: the configuration file's pool is {given!r}, not an object "
                         "of StreamPool's keyword arguments")
    params = list(inspect.signature(stream_pool).parameters)
    for key, value in given.items():
        if key in HARNESS_SETS:
            raise SystemExit(f"error: the configuration file's pool gives {key!r}, which the "
                             "harness sets from the cell")
        if key not in params:
            raise SystemExit(f"error: the configuration file's pool gives {key!r}, which "
                             f"StreamPool lacks; its parameters are {params}")
        if not isinstance(value, (bool, int, float, str)):
            raise SystemExit(f"error: the configuration file's pool gives {key!r} the value "
                             f"{value!r}, not a number, a string or a boolean")
    return given


def hold_formants(mix: dict, engine: str, ref) -> None:
    """A traffic mix that sets a formant control (at the start or in a
    turn) needs a reference with a formant chain, which it declares as
    ``FORMANTS``; without one the cell is refused here, before the kernel
    library and the pool are built."""
    for key in list(mix["initial"]) + list(mix["turn_keys"]):
        if key in FORMANT_KEYS and not getattr(ref, "FORMANTS", False):
            raise SystemExit(f"error: the traffic sets {key!r}, and the reference of the "
                             f"{engine!r} engine (portbench/reference/{engine}.py) has no "
                             "formant chain to check it against")


def _hold_geometry(pool, cfg: dict, given: dict) -> None:
    """The configuration file's geometry, which the reference is built
    from, has to be the one the program's pool runs."""
    prog = pool.scfg if cfg["engine"] == "fidelity" else pool.config
    alias = {"split_computation": "split"}
    got = {k: getattr(prog, k) if hasattr(prog, k) else getattr(prog, alias[k])
           for k in cfg["geometry"]}
    if got != cfg["geometry"]:
        raise SystemExit(f"error: the pool runs the geometry {got}, the configuration "
                         f"file states {cfg['geometry']} (pool arguments from the "
                         f"configuration file: {given or 'none'})")


class _Pool:
    """The program's pool with the harness's traffic around it: every
    ``set`` sent is logged for the reference, and the compared steps'
    outputs and states are kept."""

    def __init__(self, cell: spec.Cell, seed: int, device: str):
        from bauklank_tpu_torch.serve import StreamPool

        cfg, mix = cell.config, cell.traffic
        self.pool_args = pool_arguments(cfg, StreamPool)
        self.ref = spec.reference(cell.root, cfg["engine"])
        hold_formants(mix, cfg["engine"], self.ref)
        self.marks = [("import", time.perf_counter())]
        if device == "cuda":
            from bauklank_tpu_torch.kernels import build

            build.library()
        self.marks.append(("kernel library", time.perf_counter()))
        self.voices, self.hops = int(mix["voices"]), int(mix["hops_per_step"])
        sr, channels = float(cfg["sample_rate"]), int(cfg["channels"])
        self.geo = self.ref.geometry(cfg)
        self.names = [f"v{i:03d}" for i in range(self.voices)]
        self.pool = StreamPool(capacity=self.voices, sample_rate=sr, channels=channels,
                               max_track_sec=cfg["max_track_sec"], names=self.names,
                               hops_per_step=self.hops, engine=cfg["engine"], device=device,
                               **self.pool_args)
        _hold_geometry(self.pool, cfg, self.pool_args)
        self.marks.append(("pool", time.perf_counter()))
        self.track_sec = float(mix["track_sec"])
        dev_audio = synth.make_audio(self.voices, channels, int(self.track_sec * sr), sr, seed,
                                     device)
        self.audio = dev_audio.cpu().numpy()
        del dev_audio
        self.marks.append(("audio", time.perf_counter()))
        for i, name in enumerate(self.names):
            self.pool.load_track(name, self.audio[i])
        self.marks.append(("load_track", time.perf_counter()))
        self.traffic = Traffic(mix, seed, self.hops * self.geo.interval / sr, self.track_sec)
        self.sets: list = []
        self.semitones = np.zeros(self.voices)
        self.samples: list = []

    def send(self, k: int, v: int, key: str, value, lookahead=None) -> None:
        """One ``set`` before step ``k``; ``lookahead`` None takes the pool's."""
        from torch.profiler import record_function

        with record_function("bench.set"):
            ok = (self.pool.apply_set(self.names[v], key, value) if lookahead is None
                  else self.pool.apply_set(self.names[v], key, value, lookahead=lookahead))
        if not ok:
            raise RuntimeError(f"apply_set({self.names[v]}, {key}, {value}) was refused")
        self.sets.append((k, v, key, value, 0.1 if lookahead is None else lookahead))
        if key == "semitones":
            self.semitones[v] = value

    def turns(self, k: int) -> None:
        for v, key, value in self.traffic.turns(k):
            self.send(k, v, key, value)

    def snapshot(self):
        return _tree(self.pool.states, lambda t: t.clone())

    def keep(self, k: int, before, master, streams) -> None:
        self.samples.append(dict(step=k, before=before, after=self.snapshot(), streams=streams,
                                 master=master))


def _warm_up(p: _Pool, mix: dict, trace: bool, device: str) -> int:
    """The initial ``set``s, the first step (kept: the start is compared)
    and the warm-up steps; returns the first window step's index."""
    from torch.profiler import profile

    for v, key, value in p.traffic.initial:
        p.send(0, v, key, value, lookahead=0.0)
    master, streams = p.pool.step(fetch=True)
    p.keep(0, None, master, streams)
    p.marks.append(("first_step", time.perf_counter()))
    first = int(mix["warmup_steps"])
    for k in range(1, first):
        p.turns(k)
        p.pool.step(fetch=True)
    if trace:
        # the profiler's first start initialises its device tracing, which
        # takes seconds: pay it here, in set-up, on one more step
        p.turns(first)
        with profile(activities=_activities(device)):
            p.pool.step(fetch=True)
        first += 1
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return first


def _host_sample(steps: int) -> tuple:
    """(steps so far, wall seconds, this process's CPU seconds, the
    machine's busy and stolen CPU seconds from ``/proc/stat``)."""
    busy = steal = 0.0
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        tick = os.sysconf("SC_CLK_TCK")
        busy, steal = (v[0] + v[1] + v[2] + v[5] + v[6]) / tick, v[7] / tick
    except (OSError, ValueError, IndexError):
        pass
    return steps, time.perf_counter(), time.process_time(), busy, steal


def _drift(times: list, marks: list) -> str:
    """The window by fifths: the median step, this process's CPU share,
    the other busy cores of the machine, the share of its CPU time stolen
    by its host."""
    cols = []
    for (k0, w0, c0, b0, s0), (k1, w1, c1, b1, s1) in zip(marks, marks[1:]):
        wall = max(w1 - w0, 1e-9)
        cols.append((np.median(times[k0:k1]) * 1e3 if k1 > k0 else float("nan"),
                     100 * (c1 - c0) / wall, max(b1 - b0 - (c1 - c0), 0.0) / wall,
                     100 * (s1 - s0) / (wall * os.cpu_count())))
    return "; ".join(f"{name} " + " ".join(fmt % c[i] for c in cols) for i, (name, fmt) in
                     enumerate([("step ms median", "%.3f"), ("own CPU %", "%.0f"),
                                ("other busy cores", "%.2f"), ("steal %", "%.2f")]))


def _window(p: _Pool, mix: dict, first: int, seed: int, seconds: float, trace: bool,
            device: str) -> dict:
    """Steps back to back for ``seconds``; the compared steps at times
    drawn from the seed; with ``trace`` the profiler over a stretch of
    steady steps.  Returns the step times and what the run saw."""
    from torch.profiler import profile, record_function

    rng = np.random.default_rng([int(seed) % 2**63, 1])
    due = sorted(rng.uniform(0.1, 0.9, int(mix["compared_steps"])) * seconds)
    trace_at = int(mix.get("trace_skip", 2))
    trace_s, trace_min = float(mix["trace_seconds"]), int(mix["trace_min_steps"])
    w = dict(times=[], failed=0, prof=None, semitones=None)
    traced, k = 0, first
    fifths = [seconds * i / 5 for i in range(1, 5)]
    marks = [_host_sample(0)]
    w["t_start"] = t_start = time.perf_counter()
    while True:
        p.turns(k)
        take = bool(due) and time.perf_counter() - t_start >= due[0]
        if take:
            due.pop(0)
            before = p.snapshot()
        if trace and w["prof"] is None and len(w["times"]) == trace_at:
            w["prof"] = profile(activities=_activities(device))
            w["prof"].__enter__()
            t_trace = time.perf_counter()
            w["semitones"] = p.semitones.copy()
        ta = time.perf_counter()
        try:
            with record_function("bench.step"):
                master, streams = p.pool.step(fetch=True)
        except Exception:                        # a step that raises is a failed step
            w["failed"] += 1
            traceback.print_exc(file=sys.stderr)
            take = False
        tb = time.perf_counter()
        w["times"].append(tb - ta)
        if take:
            p.keep(k, before, master, streams)
        k += 1
        if w["prof"] is not None and traced >= 0:
            traced += 1
            if (tb - t_trace >= trace_s and traced >= trace_min) or traced >= 400:
                w["prof"].__exit__(None, None, None)
                traced = -1
        if fifths and tb - t_start >= fifths[0]:
            fifths.pop(0)
            marks.append(_host_sample(len(w["times"])))
        if tb - t_start >= seconds:
            break
    if w["prof"] is not None and traced >= 0:
        w["prof"].__exit__(None, None, None)
    w["window_s"] = tb - t_start
    marks.append(_host_sample(len(w["times"])))
    ms = np.sort(np.array(w["times"])) * 1e3
    print(f"window: {len(ms)} steps in {w['window_s']:.3f} s, step ms median "
          f"{np.median(ms):.3f} p95 {np.percentile(ms, 95):.3f} max {ms[-1]:.3f}, over "
          f"twice the median {int((ms > 2 * np.median(ms)).sum())}; by fifths of the window: "
          + _drift(w["times"], marks), file=sys.stderr)
    return w


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", chips: int = 1, control: bool = False,
        forbidden=FORBIDDEN, detail: list | None = None) -> tuple[dict, dict]:
    """One run.  Returns (the result line's object, the compared numbers);
    with ``control`` the result also holds the control's numbers, the
    reference in bfloat16 put in the program's place at the same steps.
    ``forbidden``: the modules whose presence fails the run (a test
    process that imported JAX for another test passes none).  ``detail``,
    a list, gets the program's per-voice readings at each compared step.
    Raises SystemExit without a card (``device="cuda"``) and when a
    forbidden module is loaded once the window has closed."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"error: the cell needs {chips} CUDA device(s); "
                             f"torch sees {torch.cuda.device_count()}")
        print(f"card: {_card()}", file=sys.stderr)
    mix = cell.traffic
    p = _Pool(cell, seed, device)
    first = _warm_up(p, mix, trace, device)
    setup_end = time.perf_counter()
    p.marks.append(("warmup", setup_end))
    build_s = p.marks[1][1] - p.marks[0][1]
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (name, b), (_, a) in
                                zip(p.marks, [("", t0)] + p.marks))
          + f" (setup_s leaves out the kernel library); pool arguments from the "
          f"configuration file: {p.pool_args or 'none'}", file=sys.stderr)
    w = _window(p, mix, first, seed, seconds, trace, device)

    device_info = dict(platform="gpu" if device == "cuda" else device,
                       kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
                       count=chips, memory_peak_bytes=int(
                           torch.cuda.max_memory_allocated() if device == "cuda" else 0))
    to_np = lambda t: t.detach().cpu().numpy()
    for s in p.samples:
        s["after"] = _tree(s["after"], to_np)
        s["before"] = None if s["before"] is None else _tree(s["before"], to_np)
        s["streams"] = to_np(s["streams"])
    p.pool = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules(forbidden)
    if found:
        raise SystemExit(f"error: modules loaded that the benchmark must not load: {found}")

    from portbench.core import trace as trace_mod

    tr = trace_mod.reduce(w["prof"]) if w["prof"] is not None else None
    run_ = Run(cell, p.geo, p.voices, p.hops, w["times"], w["window_s"],
               w["t_start"] - t0 - build_s, tr, w["semitones"])
    ref_audio = torch.from_numpy(p.audio).to(device)
    compare = lambda ctl, detail=None: check.compare(
        p.ref, p.geo, ref_audio, p.sets, p.voices, p.hops, p.track_sec, p.samples,
        control=ctl, detail=detail)
    t_ref = time.perf_counter()
    try:
        nums = compare(False, detail)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        nums = {}
    print(f"reference: {time.perf_counter() - t_ref:.2f} s for {len(p.samples)} steps",
          file=sys.stderr)
    nums["missing_steps"] = float(1 + int(mix["compared_steps"]) - len(p.samples))
    limits = dict(cell.limits, missing_steps=0.0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(cell.root, m["name"]).read(run_)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = dict(correct=bool(w["failed"] == 0 and check.within(nums, limits)),
                  attempted=len(w["times"]), failed=w["failed"], metrics=metrics,
                  device=device_info)
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops, "idle_gaps": tr.idle_by_range}
    result["kernel_build_s"] = build_s
    if control:
        result["control"] = compare(True)
        result["compared"] = nums
    result["checks"] = {n: {"value": nums.get(n), "limit": lim} for n, lim in limits.items()}
    return result, nums


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
