"""Formant voices through the harness, at a tiny size on the CPU: a
fidelity cell whose traffic puts voices on the formant controls (drawn
with ``choice``) comes out ``correct`` against the float64 reference,
whose formant chain and trackers it is held to; with the formant
controls dropped under the timed path it does not.  Neutral formant
controls change none of the reference's bits (its formant chain is held
to the blob's own renders in ``test_portbench_golden.py``); its replay packs the formant controls as the
program does; a cell of an engine whose reference has no formant chain is
refused before its pool is built."""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, SECONDS, TINY_LIMITS, run_tiny
from portbench.core.faults import plant

# the formant controls of the tiny cell's voices, as the would-be
# fidelity-preset.s128h8-formant mix draws them: about a quarter neutral,
# a quarter on compensation alone, the base detected or the kiosk's 200 Hz
FORMANT_MIX = {
    "formantCompensation": {"dist": "choice", "values": [0, 1]},
    "formantSemitones": {"dist": "choice", "values": [0, 0, -6, 6]},
    "formantBaseHz": {"dist": "choice", "values": [0, 200]},
}
# the tiny formant cell's limits: TINY_LIMITS's, and the formant trackers,
# from ten seeds on the CPU: the program read state_formant at most 1.9e-7,
# the bfloat16 control at least 1.0e-3; dropping the formant controls
# reads 1 (the program's trackers never move)
FORMANT_LIMITS = dict(TINY_LIMITS["fidelity"], state_formant=1e-4)
# seeds whose draws put voices on every branch (neutral, compensation alone,
# the base detected, the base given)
SEED, SEED2 = 2**36 + 22, 2**36 + 27


def _formant_root(tiny_root, voices: int = 8):
    """The tiny fidelity cell with the formant controls in its mix and
    ``state_formant`` among its limits."""
    root = tiny_root("fidelity", voices=voices)
    path = root / "portbench" / "traffic" / "tiny-mix.json"
    mix = json.loads(path.read_text())
    mix["initial"].update(FORMANT_MIX)
    path.write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "tiny.fidelity.json").write_text(
        json.dumps(FORMANT_LIMITS))
    return root


def _recording_pools(monkeypatch) -> list:
    """Every ``StreamPool`` built from here on."""
    from bauklank_tpu_torch.serve import StreamPool

    built, init = [], StreamPool.__init__

    @functools.wraps(init)       # the harness reads the signature through it
    def recording(self, *args, **kwargs):
        built.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(StreamPool, "__init__", recording)
    return built


def test_formant_mix_covers_every_branch_of_the_chain():
    """The seed's initial draws put voices on each branch: neutral,
    compensation alone, a formant shift with the base detected and with
    the base given."""
    from portbench.core.traffic import Traffic

    mix = json.loads((REPO / "portbench" / "traffic" / "s64h1.json").read_text())
    mix.update(voices=8, initial=dict(mix["initial"], **FORMANT_MIX))
    for seed in (SEED, SEED2):
        sets = Traffic(mix, seed, 0.06, 4.0).initial
        voice = [{k: v for u, k, v in sets if u == i} for i in range(8)]
        kinds = {("neutral" if not v["formantCompensation"] and not v["formantSemitones"] else
                  "compensation" if not v["formantSemitones"] else
                  "detected" if not v["formantBaseHz"] else "given") for v in voice}
        assert kinds == {"neutral", "compensation", "detected", "given"}, voice


def test_formant_cell_runs_correct_and_is_held_to_the_trackers(tiny_root, monkeypatch):
    built = _recording_pools(monkeypatch)
    root = _formant_root(tiny_root)
    result, nums = run_tiny(root, "fidelity", SEED, SECONDS["fidelity"])
    assert result["failed"] == 0 and result["attempted"] > 3
    assert result["correct"], result["checks"]
    assert nums["missing_steps"] == 0
    assert "state_formant" in result["checks"]
    assert 0.0 <= nums["state_formant"] <= FORMANT_LIMITS["state_formant"]
    pool, = built
    m = pool.metrics()
    assert m["steps"] > 3 and m["formant_steps"] == m["steps"]


def test_formant_cell_control_comes_out_not_correct(tiny_root):
    from portbench.core import check

    root = _formant_root(tiny_root)
    result, nums = run_tiny(root, "fidelity", SEED2, SECONDS["fidelity"], control=True)
    assert check.within(nums, FORMANT_LIMITS), nums
    assert result["control"]["state_formant"] > FORMANT_LIMITS["state_formant"]
    assert not check.within(result["control"], FORMANT_LIMITS), result["control"]


def test_formant_cell_with_formants_dropped_is_not_correct(tiny_root):
    """The program's trackers never move, so ``state_formant`` reads 1;
    the voices rendered without their formant gain fail the streams."""
    undo = plant("formants_dropped", "fidelity")
    try:
        root = _formant_root(tiny_root)
        result, nums = run_tiny(root, "fidelity", SEED, SECONDS["fidelity"])
    finally:
        undo()
    assert not result["correct"], nums
    assert nums["state_formant"] == pytest.approx(1.0)
    assert nums["stream_err"] > FORMANT_LIMITS["stream_err"], nums


def _reference_step(ctl_extra: dict, n: int = 4, hops: int = 3):
    """One reference step of ``n`` streams from a fresh state, on tonal
    audio, with ``ctl_extra`` added to the controls."""
    from portbench.core import spec

    ref = spec.reference(REPO, "fidelity")
    geo = ref.Geometry(2, 960, 240, 8000.0)
    t = torch.arange(8000, dtype=torch.float64) / 8000.0
    audio = torch.stack([torch.stack([torch.sin(2 * np.pi * (110.0 + 40 * i) * k * t)
                                      for k in (1.0, 1.5)]) for i in range(n)]) * 0.3
    ends = torch.arange(hops, dtype=torch.int64)[None] * geo.interval + 3000 + 17 * torch.arange(
        n)[:, None]
    f = lambda *v: torch.tensor(v, dtype=torch.float64)
    ctl = dict(rate=f(0.7, 1.0, 1.3, 0.9), semitones=f(3.0, 0.0, -5.0, 7.0),
               tonality_hz=f(3000.0, 3000.0, 3500.0, 3000.0), active=f(1.0, 1.0, 1.0, 1.0))
    ctl.update(ctl_extra)
    state = ref.init_state(geo, n, "cpu")
    return ref.step(geo, state, audio, ends, ctl)


def _same_bits(a, b, rows=slice(None)):
    (sa, oa), (sb, ob) = a, b
    assert torch.equal(oa[rows], ob[rows])
    for k in sa:
        assert torch.equal(sa[k][rows], sb[k][rows]), k


def test_neutral_formant_controls_change_no_bit_of_the_reference():
    """Every stream neutral gives the bits of no formant control; streams
    left neutral beside formant-active ones keep their bits, their
    trackers at 0."""
    f = lambda *v: torch.tensor(v, dtype=torch.float64)
    plain = _reference_step({})
    neutral = dict(formant_factor=f(1.0, 1.0, 1.0, 1.0),
                   formant_compensation=f(0.0, 1.0, 0.0, 0.0),
                   formant_base=f(0.0, 0.025, 0.025, 0.0))
    _same_bits(plain, _reference_step(neutral))
    mixed = dict(formant_factor=f(1.0, 2.0 ** 0.5, 1.0, 1.0),
                 formant_compensation=f(0.0, 0.0, 1.0, 0.0),
                 formant_base=f(0.0, 0.0, 0.025, 0.0))
    got = _reference_step(mixed)
    _same_bits(plain, got, [0, 3])
    state, out = got
    assert not torch.equal(out[1:3], plain[1][1:3])
    assert float(state["f_value_ema"][1]) > 0.0 and float(state["f_weighted_ema"][1]) > 0.0
    assert float(state["f_value_ema"][2]) == 0.0     # the base given: no tracking


def test_replay_packs_the_formant_controls_as_the_program_does():
    """A sequence of ``set``s (clamps, inheritance, compensation on and
    off) through the program's pool and its ``Drive.fill``, and through
    the reference's replay: the same formant fields and frame ends each
    step."""
    from bauklank_tpu_torch.engine.drive import unpack
    from bauklank_tpu_torch.serve import StreamPool
    from portbench.reference import drive

    sr, hops, interval = 8000.0, 2, 240
    pool = StreamPool(capacity=2, sample_rate=sr, channels=1, max_track_sec=2.0,
                      names=["a", "b"], hops_per_step=hops, engine="fidelity", device="cpu",
                      block=960, interval=interval)
    plan = {0: [(0, "active", True), (0, "rate", 0.8), (1, "active", True),
                (0, "formantSemitones", 60.0), (1, "formantCompensation", 1.0),
                (1, "formantBaseHz", 5000.0)],
            2: [(0, "semitones", 5.0), (1, "formantSemitones", -70.0)],
            3: [(0, "formantBaseHz", -3.0), (1, "formantCompensation", 0.0)],
            5: [(0, "formantSemitones", -4.5), (0, "formantCompensation", True),
                (1, "formantBaseHz", 210.0)],
            6: [(1, "rate", 1.5)]}
    steps = 8
    sets, packed = [], []
    for k in range(steps):
        for v, key, value in plan.get(k, []):
            la = 0.0 if k == 0 else 0.03 * (v + 1)
            assert pool.apply_set("ab"[v], key, value, lookahead=la)
            sets.append((k, v, key, value, la))
        packed.append(pool._packed())
        pool.out_pos += hops * interval
    geo = type("Geo", (), dict(sample_rate=sr, interval=interval, block=960, centre=0,
                               out_lat=pool.drive.output_latency))
    host = drive.replay(geo, 2, hops, 2.0, sets, list(range(steps)))
    for k in range(steps):
        ends, fields, _, _ = unpack(packed[k])
        assert np.array_equal(ends, host[k]["ends"].astype(np.float32)), k
        for name in ("formant_factor", "formant_compensation", "formant_base"):
            assert np.array_equal(getattr(fields, name),
                                  host[k][name].astype(np.float32)), (k, name)
    last = host[steps - 1]
    assert list(last["formant_factor"]) == [2.0 ** (-4.5 / 12), 2.0 ** (-48 / 12)]
    assert list(last["formant_compensation"]) == [1.0, 0.0]
    assert list(last["formant_base"]) == [0.0, 210.0 / sr]
    code = ("import sys, pathlib; sys.path.insert(0, '.')\n"
            "from portbench.core import spec\n"
            "for name in ('drive', 'fidelity'):\n"
            "    spec.load_module(pathlib.Path(f'portbench/reference/{name}.py'), 'reference')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "bauklank_tpu_torch" not in out.stdout and "'jax'" not in out.stdout


@pytest.mark.parametrize("where", ["initial", "turn_keys"])
@pytest.mark.parametrize("key", ["formantSemitones", "formantCompensation", "formantBaseHz"])
def test_fast_cell_with_a_formant_control_is_refused_before_the_pool(
        tiny_root, monkeypatch, capsys, key, where):
    built = _recording_pools(monkeypatch)
    root = tiny_root("fast")
    path = root / "portbench" / "traffic" / "tiny-mix.json"
    mix = json.loads(path.read_text())
    mix["initial"][key] = {"dist": "choice", "values": [0, 1]}
    if where == "turn_keys":
        mix["turn_keys"].append(key)
        del mix["initial"][key]
    path.write_text(json.dumps(mix))
    with pytest.raises(SystemExit) as refused:
        run_tiny(root, "fast", 17, SECONDS["fast"])
    assert f"sets {key!r}" in str(refused.value) and "'fast' engine" in str(refused.value)
    assert built == []
    assert capsys.readouterr().out == ""


def test_choice_draws_only_its_values_at_the_start_and_in_turns():
    from portbench.core.traffic import Traffic

    mix = json.loads((REPO / "portbench" / "traffic" / "s64h1.json").read_text())
    mix["initial"]["formantSemitones"] = {"dist": "choice", "values": [0, 0, -6, 6]}
    mix["turn_keys"] = ["formantSemitones"]
    a, b = (Traffic(mix, 2**41 + 7, 0.03, 30.0) for _ in range(2))
    assert a.initial == b.initial
    turns = [v for k in range(1, 2000) for _, _, v in a.turns(k)]
    assert turns == [v for k in range(1, 2000) for _, _, v in b.turns(k)]
    start = [v for _, key, v in a.initial if key == "formantSemitones"]
    for drawn in (start, turns):
        assert set(drawn) == {0.0, -6.0, 6.0}
    # 0 is listed twice: about half the draws
    assert 0.35 < turns.count(0.0) / len(turns) < 0.65
