"""Whether what the timed path produced is right: the comparison with
the engine's plain reference (``portbench/reference/<engine>.py``).

The engines carry state from step to step, and a float32 program and a
float64 reference drift apart over many steps by rounding alone (the
fidelity engine's phase chain amplifies it).  So each compared step of
the window is rendered by the reference from the program's own state
before that step, and the state the program carries out of it is held to
the reference's; the start is held apart: the first step, from the
reference's own fresh state.  Frame ends, controls and mix ramps come
from the reference's own replay of the ``set``s sent (``drive.py``), the
audio from the benchmark, the same for both sides.

The numbers, each the worst over the compared steps, compared with the
cell's limits:

- ``stream_err``: the worst voice's rendered stream, ||program -
  reference|| over the larger of the reference's norm and the median
  voice's;
- ``voice_level``: the worst voice's | ||program|| - ||reference|| | over
  the larger of the reference's norm and a hundredth of the median
  voice's: a voice silenced, doubled or swapped, whatever its size;
- ``stream_all``: all voices' streams together, relative;
- ``master_err``: the master against the reference's mixdown of its own
  streams, relative;
- ``state_spectrum``, ``state_tail``: the carried state of all voices,
  relative (and ``state_rng``, the MINSTD states that differ, and
  ``state_formant``, the two formant f0 trackers of all voices, relative,
  where the engine has them).

Each step's controls are the seven of ``drive.CONTROLS``, the formant
controls among them; a reference without a formant chain reads only the
first four, and a cell whose traffic sets a formant control is refused
for it at set-up (``core/cell.py``).

The control (``control=True``) puts the reference computed in bfloat16 in
the program's place, from the same states.
"""

from __future__ import annotations

import numpy as np
import torch


def bf16(x):
    """Round to bfloat16 (8 bits of mantissa, round to nearest even);
    float64 or complex128 out."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    if not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(torch.float64)


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def _stream_errors(got, want):
    """Per stream: ||got - want|| over the larger of its ||want|| and the
    median stream's; the same over the larger of its ||want|| and a
    hundredth of the median's; | ||got|| - ||want|| | over the latter; and
    ||want|| over the median's."""
    dims = tuple(range(1, want.dim()))
    err = torch.sqrt(((got - want).abs() ** 2).sum(dims))
    norm = torch.sqrt((want.abs() ** 2).sum(dims))
    med = max(float(norm.median()), 1e-30)
    own = torch.clamp_min(norm, 0.01 * med)
    level = (torch.sqrt((got.abs() ** 2).sum(dims)) - norm).abs()
    return err / torch.clamp_min(norm, med), err / own, level / own, norm / med


def _state_errors(want: dict, got: dict) -> dict:
    """Each part of the carried state over all streams: relative error,
    or for integer parts the count of entries that differ."""
    return {k: float((got[k] != w).sum()) if not (w.is_floating_point() or w.is_complex())
            else _rel(got[k], w) for k, w in want.items()}


def _cat(states):
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


def _split(state, n):
    count = next(iter(state.values())).shape[0] // n
    return [{k: v[i * n:(i + 1) * n] for k, v in state.items()} for i in range(count)]


def compare(ref, geo, audio, sets, voices: int, hops: int, track_sec: float, samples: list,
            control: bool = False, detail: list | None = None) -> dict:
    """The compared numbers.  ``audio`` [V, C, T] on the device the
    reference runs on; ``samples``: dicts with the step index, the
    program's state before it (None for the start), its state after it,
    its streams [S, C, n] and master [2, n], all NumPy.  ``detail``, a
    list, gets each compared step's per-voice readings."""
    from portbench.reference import drive

    dev = audio.device
    wanted = [s["step"] for s in samples]
    host = drive.replay(geo, voices, hops, track_sec, sets, wanted)
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    starts = [ref.init_state(geo, voices, dev) if s["before"] is None
              else ref.state_from_program(geo, s["before"], dev) for s in samples]
    ends = t(np.concatenate([host[k]["ends"] for k in wanted]))
    ctl = {key: t(np.concatenate([host[k][key] for k in wanted])) for key in drive.CONTROLS}
    rows = t(np.tile(np.arange(voices), len(samples)))
    ramps = [(t(host[k]["gains"]), t(host[k]["pans"])) for k in wanted]
    state, out = ref.step(geo, _cat(starts), audio, ends, ctl, voices=rows)
    if control:
        got_state, got = ref.step(geo, _cat(starts), audio, ends, ctl, voices=rows, rnd=bf16)
        got_states = _split(got_state, voices)
        got_masters = [bf16(drive.mixdown(got[i * voices:(i + 1) * voices], *ramps[i]))
                       for i in range(len(wanted))]
    else:
        got = t(np.concatenate([s["streams"] for s in samples])).to(torch.float64)
        got_states = [ref.state_from_program(geo, s["after"], dev) for s in samples]
        got_masters = [t(s["master"]).to(torch.float64) for s in samples]
    want_states = _split(state, voices)
    nums: dict = {}
    for i in range(len(wanted)):
        sl = slice(i * voices, (i + 1) * voices)
        per, own, level, size = _stream_errors(got[sl], out[sl])
        if detail is not None:
            detail.append(dict(step=wanted[i], stream_err=per.cpu().numpy(),
                               voice_err=own.cpu().numpy(), voice_level=level.cpu().numpy(),
                               size=size.cpu().numpy()))
        row = dict(stream_err=float(per.max()), voice_level=float(level.max()),
                   stream_all=_rel(got[sl], out[sl]),
                   master_err=_rel(got_masters[i], drive.mixdown(out[sl], *ramps[i])),
                   **_state_errors(ref.state_parts(want_states[i]),
                                   ref.state_parts(got_states[i])))
        for name, v in row.items():
            nums[name] = max(nums.get(name, v), v)
    return nums


def within(nums: dict, limits: dict) -> bool:
    """Every limited number present, finite and at most its limit."""
    return all(name in nums and np.isfinite(nums[name]) and nums[name] <= lim
               for name, lim in limits.items())
