"""Faults planted under the timed path, each of which a run has to come
out not correct for: the program's pool step wrapped so that it

- ``stale_state``: returns its state unchanged;
- ``half_batch``: leaves half of the voices out, the master the mean over
  the rest scaled back to the whole pool;
- ``altered_answer``: replaces one voice's stream by another's;
- ``silent_voice``: silences the quietest voice whose stream is above a
  hundredth of the median voice's (below the median, where a comparison
  scaled by the median voice would not see it).

Apart from those, since only a cell with formant voices can have it:

- ``formants_dropped``: hands the step every voice's formant controls as
  neutral (factor 1, no compensation), the base and the step's program
  as they were.

``plant(name, engine)`` wraps the engine's step in
``bauklank_tpu_torch.serve.pool`` and returns the function that undoes it.
The wrapped step is the one the pool calls on both of its paths: on the
card its CUDA graphs copy the packed rows they are handed before every
replay, so a fault reaches the replayed steps as well as the eager ones.
"""

from __future__ import annotations

import torch


def stale_state(step):
    def wrapped(*args, **kw):
        _, master, streams = step(*args, **kw)
        return args[1], master, streams
    return wrapped


def half_batch(step):
    def wrapped(*args, **kw):
        states, master, streams = step(*args, **kw)
        half = streams.shape[0] // 2
        streams = streams.clone()
        streams[half:] = 0.0
        return states, master * 2.0, streams
    return wrapped


def altered_answer(step):
    def wrapped(*args, **kw):
        states, master, streams = step(*args, **kw)
        streams = streams.clone()
        streams[0] = streams[1]
        return states, master, streams
    return wrapped


def silent_voice(step):
    def wrapped(*args, **kw):
        states, master, streams = step(*args, **kw)
        norm = torch.linalg.vector_norm(streams.flatten(1), dim=1)
        quiet = torch.where(norm > 0.01 * norm.median(), norm, torch.inf)
        streams = streams.clone()
        streams[int(torch.argmin(quiet))] = 0.0
        return states, master, streams
    return wrapped


def formants_dropped(step):
    from bauklank_tpu_torch.engine.drive import unpack

    def wrapped(*args, **kw):
        packed = args[3].clone()
        fields = unpack(packed)[1]
        fields.formant_factor.fill_(1.0)
        fields.formant_compensation.fill_(0.0)
        return step(*args[:3], packed, *args[4:], **kw)
    return wrapped


FAULTS = {f.__name__: f for f in (stale_state, half_batch, altered_answer, silent_voice)}
# faults that only a cell with formant voices can have
FORMANT_FAULTS = {f.__name__: f for f in (formants_dropped,)}


def plant(name: str, engine: str):
    from bauklank_tpu_torch.serve import pool

    attr = "_pool_step_fidelity" if engine == "fidelity" else "_pool_step"
    orig = getattr(pool, attr)
    setattr(pool, attr, {**FAULTS, **FORMANT_FAULTS}[name](orig))
    return lambda: setattr(pool, attr, orig)
