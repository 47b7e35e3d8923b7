"""Run one cell traced and print what the trace shows beyond the result
line: the pool's counters, the card's idle time split over the host
ranges that held it, and the device operations a step by range.

    python3 portbench/spans.py --workload <cell> --seed <n> [--seconds 15]

runs the cell as ``run.py --trace 1`` does and prints, on standard
error, a ``pool:`` line (``StreamPool.metrics()`` after the warm-up and
after the window), an ``idle split:`` line and a ``launches:`` line
(``core/split.py``), and on standard output one JSON line of the
readings, then the run's own result line.  The readings:
``pool_idle_pct``, the traced stretch's share in which the card ran
nothing while the host's innermost range was a ``pool.*`` range;
``launches_per_step``, the device operations a step launched from the
program's ranges (``pool.*``, ``fidelity.*``, ``fast.*``);
``fetch_ms``, the host ms a step in ``pool.fetch``, waiting for the card
(a split with no better direction: a faster host reaches the fetch
sooner and waits longer); ``bench_step_ops``, the device operations
charged to the harness's ``bench.step`` or to no range at all; ``bench_step_host_ms``,
the host time a step in ``bench.step`` outside ``pool.step``.  It needs
the card, as a run does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _ms(split, name: str) -> float:
    return split.host_s.get(name, 0.0) / split.steps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)

    from portbench.core import cell as cell_mod
    from portbench.core import spec
    from portbench.core import split as split_mod
    from portbench.core import trace as trace_mod

    seen: dict = {}
    warm_up, window, reduce = cell_mod._warm_up, cell_mod._window, trace_mod.reduce

    def warm_up_and_read(p, *a, **kw):
        first = warm_up(p, *a, **kw)
        seen["after warm-up"] = p.pool.metrics()
        return first

    def window_and_read(p, *a, **kw):
        w = window(p, *a, **kw)
        seen["after the window"] = p.pool.metrics()
        return w

    def reduce_and_split(prof, *a, **kw):
        seen["split"] = split_mod.split(prof)
        return reduce(prof, *a, **kw)

    cell_mod._warm_up, cell_mod._window = warm_up_and_read, window_and_read
    trace_mod.reduce = reduce_and_split
    try:
        c = spec.load_cell(ROOT, args.workload)
        result, _ = cell_mod.run(c, args.seed, args.seconds, True, T0, chips=int(c.chips))
    finally:
        cell_mod._warm_up, cell_mod._window, trace_mod.reduce = warm_up, window, reduce
    sp = seen["split"]
    print("pool: " + "; ".join(f"{k} {seen[k]}" for k in ("after warm-up", "after the window")),
          file=sys.stderr)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])
    print(f"idle split: {sp.steps} steps, window {sp.window_s:.6f} s, busy {sp.busy_s:.6f} s; "
          + ", ".join(f"{n} {s:.6f}" for n, s in rank(sp.idle_split)), file=sys.stderr)
    print("launches: " + ", ".join(f"{n} {c / sp.steps:.2f}" for n, c in rank(sp.device_n))
          + " a step", file=sys.stderr)
    stray = sum(c for n, c in sp.device_n.items() if n in ("bench.step", "(no range)"))
    print(json.dumps(dict(
        workload=c.name, seed=args.seed, pool=seen["after the window"],
        table_builds_after_warm_up=seen["after warm-up"]["table_builds"],
        pool_idle_pct=sp.pool_idle_pct(), launches_per_step=sp.launches_per_step(),
        fetch_ms=_ms(sp, "pool.fetch"),
        bench_step_ops=stray,
        bench_step_host_ms=_ms(sp, "bench.step") - _ms(sp, "pool.step"),
        idle_split=rank(sp.idle_split))), flush=True)
    cell_mod.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
