"""Read the numbers that the limits are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3
        [--fault <name>] [--witness] [--detail]

runs the cell once a seed in one process (set-up, a short window at the
cell's own load, the comparison) and prints, a line a seed, the
program's compared numbers and the control's: the plain reference
computed in bfloat16 and put in the program's place, from the same
states at the same steps.  A limit lies above the largest reading of the
program over a dozen seeds or more and below the smallest of the
control's (PERF.md gives the readings).  It needs the card, as a run does.

``--fault`` plants one of ``core/faults.py``'s faults under the timed
path (``formants_dropped`` too, which only a cell with formant voices can
have).  ``--witness`` runs each seed a second time with the program on
the CPU (the same audio, made by the card's generator) and compares the
first step, which both sides render from a fresh state, voice by voice:
the program on the card and on the CPU against each other and each
against the reference.  ``--detail`` prints the worst voices of each
compared step.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _worst(detail: list, n: int = 4) -> list:
    """The ``n`` worst voices of each compared step, by ``voice_err``."""
    out = []
    for d in detail:
        order = d["voice_err"].argsort()[::-1][:n]
        out.append(dict(step=d["step"], median_voice_err=float(sorted(d["voice_err"])[
            len(d["voice_err"]) // 2]), max_voice_level=float(d["voice_level"].max()), worst=[
            dict(voice=int(v), **{k: float(d[k][v]) for k in
                                  ("voice_err", "stream_err", "voice_level", "size")})
            for v in order]))
    return out


def _witness(cell_mod, synth, c, seed: int, devices=("cuda", "cpu")) -> dict:
    """The first step of the program on the card and on the CPU, from the
    same audio (made on the first device), each against the reference,
    and against each other."""
    import torch

    kept, per = [], []
    keep = cell_mod._Pool.keep

    def keep_start(self, k, before, master, streams):
        if before is None:
            kept.append(streams.detach().cpu().to(torch.float64))
        keep(self, k, before, master, streams)

    make = synth.make_audio
    cell_mod._Pool.keep = keep_start
    synth.make_audio = lambda *a: make(*a[:-1], devices[0]).to(a[-1])
    c.traffic["warmup_steps"] = 1
    try:
        for dev in devices:
            detail = []
            cell_mod.run(c, seed, 0.01, False, time.perf_counter(), device=dev,
                         chips=c.chips, detail=detail)
            per.append(_worst(detail[:1])[0])
    finally:
        cell_mod._Pool.keep = keep
        synth.make_audio = make
    a, b = kept
    gap = torch.linalg.vector_norm((a - b).flatten(1), dim=1)
    norm = torch.linalg.vector_norm(b.flatten(1), dim=1)
    between = gap / torch.clamp_min(norm, 0.01 * float(norm.median()))
    order = between.argsort(descending=True)[:4]
    return dict(first=per[0], second=per[1], devices=list(devices),
                between=dict(max=float(between.max()), median=float(between.median()),
                             worst=[[int(v), float(between[v])] for v in order]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--detail", action="store_true")
    args = ap.parse_args(argv)

    from portbench.core import cell as cell_mod
    from portbench.core import faults, spec, synth

    c = spec.load_cell(ROOT, args.workload)
    undo = faults.plant(args.fault, c.config["engine"]) if args.fault else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            if args.witness:
                line = _witness(cell_mod, synth, c, seed)
            else:
                detail = [] if args.detail else None
                result, nums = cell_mod.run(c, seed, args.seconds, False, t0,
                                            device=args.device, chips=c.chips,
                                            control=args.fault is None, detail=detail)
                line = dict(correct=result["correct"], program=nums,
                            control=result.get("control"),
                            setup_s=result["metrics"].get("setup_s", {}).get("value"))
                if detail is not None:
                    line["worst"] = _worst(detail)
            print(json.dumps(dict(workload=c.name, seed=seed, fault=args.fault, **line,
                                  wall_s=time.perf_counter() - t0)), flush=True)
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
