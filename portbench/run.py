"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found through ``BENCHMARK.json``.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the trace's breakdown.  Without
as many CUDA devices as the cell asks for it prints an error and exits
non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / ".portbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.core import cell as cell_mod
    from portbench.core import spec

    c = spec.load_cell(ROOT, args.workload)
    result, _ = cell_mod.run(c, args.seed, args.seconds, bool(args.trace), T0,
                             chips=int(c.chips))
    cell_mod.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
