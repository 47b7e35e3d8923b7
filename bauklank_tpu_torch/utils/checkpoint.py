"""Checkpoint / resume: engine state and schedules as plain files.

Port of ``bauklank_tpu/utils/checkpoint.py``, in the same file format: an
``.npz`` of the state leaves and a ``.meta.json`` of the schedules, slots,
voices and buckets.  Each leaf's npz key is ``jax.tree_util.keystr`` of its
path in the JAX package's state tree (``utils/tree.py`` computes it without
JAX), and pool states go through the numpy converters of their engines
(``fidelity_state_to_numpy``, ``stretch_state_to_numpy``,
``live_state_to_numpy``), so they are stored in the JAX layout and dtypes.
A checkpoint written by either package loads into the other's pools.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from bauklank_tpu_torch.engine.core import (StretchState, stretch_state_from_numpy,
                                            stretch_state_to_numpy)
from bauklank_tpu_torch.engine.fidelity import fidelity_state_from_numpy, fidelity_state_to_numpy
from bauklank_tpu_torch.engine.live import LiveState, live_state_from_numpy, live_state_to_numpy
from bauklank_tpu_torch.schedule.timemap import Segment
from bauklank_tpu_torch.utils.tree import keyed_leaves, tree_from_keyed

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_pool",
    "load_pool",
    "save_unified",
    "load_unified",
]


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _numpy(leaf) for key, leaf in keyed_leaves(tree)}


def save_pytree(path: str | pathlib.Path, tree) -> None:
    """Save a tree of arrays or tensors to an .npz (complex leaves stored
    as they are)."""
    np.savez(path, **_flatten(tree))


def load_pytree(path: str | pathlib.Path, template):
    """Load into the structure of ``template`` (same tree as saved); each
    leaf takes the template leaf's dtype and, for a tensor, its device."""
    data = np.load(path, allow_pickle=False)

    def leaf(key, like):
        arr = np.asarray(data[key], dtype=_numpy(like).dtype)
        return torch.from_numpy(arr).to(like.device) if isinstance(like, torch.Tensor) else arr

    return tree_from_keyed(template, leaf)


def _state_to_numpy(states):
    """A pool's device states -> numpy leaves in the JAX layout."""
    if isinstance(states, LiveState):
        return live_state_to_numpy(states)
    if isinstance(states, StretchState):
        return stretch_state_to_numpy(states)
    return fidelity_state_to_numpy(states)


def _state_from_numpy(states, tree, device):
    """Inverse of :func:`_state_to_numpy` for a pool whose states are
    ``states``."""
    if isinstance(states, LiveState):
        return live_state_from_numpy(tree, device)
    if isinstance(states, StretchState):
        return stretch_state_from_numpy(tree, device)
    return fidelity_state_from_numpy(tree, device)


def _load_states(pool, data, prefix: str = ""):
    """``pool.states`` read from ``data`` under ``prefix`` + keystr."""
    template = _state_to_numpy(pool.states)
    tree = tree_from_keyed(
        template, lambda key, like: np.asarray(data[prefix + key], dtype=like.dtype))
    return _state_from_numpy(pool.states, tree, pool.device)


def save_pool(path: str | pathlib.Path, pool) -> None:
    """Checkpoint a StreamPool: device states + schedules + mix controls.
    Tracks are not stored; reload them before resuming.  UnifiedPool
    instances dispatch to :func:`save_unified`."""
    if hasattr(pool, "buckets"):
        return save_unified(path, pool)
    path = pathlib.Path(path)
    save_pytree(path.with_suffix(".state.npz"), _state_to_numpy(pool.states))
    meta = {
        "out_pos": pool.out_pos,
        "capacity": pool.capacity,
        "sample_rate": pool.sample_rate,
        "slots": [
            {
                "name": s.name,
                "volume": s.volume,
                "pan": s.pan,
                "track_len": s.track_len,
                "loaded": s.loaded,
                "segments": [dataclasses.asdict(seg) for seg in s.timemap.segments],
            }
            for s in pool.slots
        ],
    }
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def load_pool(path: str | pathlib.Path, pool) -> None:
    """Restore a checkpoint into a compatibly configured StreamPool, on
    the pool's device.  UnifiedPool instances dispatch to
    :func:`load_unified`."""
    if hasattr(pool, "buckets"):
        return load_unified(path, pool)
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".meta.json").read_text())
    if meta["capacity"] != pool.capacity:
        raise ValueError(f"capacity mismatch: {meta['capacity']} vs {pool.capacity}")
    pool.states = _load_states(pool, np.load(path.with_suffix(".state.npz"), allow_pickle=False))
    pool.out_pos = int(meta["out_pos"])
    for s, m in zip(pool.slots, meta["slots"]):
        s.name = m["name"]
        s.volume = s._prev_volume = float(m["volume"])
        s.pan = s._prev_pan = float(m["pan"])
        s.track_len = int(m["track_len"])
        s.loaded = bool(m["loaded"])
        s.timemap.segments = [Segment(**seg) for seg in m["segments"]]
    pool._by_name = {s.name: i for i, s in enumerate(pool.slots)}


# --------------------------------------------------------------- UnifiedPool
def _bucket_ids(pool) -> list[tuple]:
    """Stable ordering of bucket keys for npz namespacing."""
    return sorted(pool.buckets, key=repr)


def _file_slot(pool, v):
    b = pool.buckets[v.bucket_key]
    return b.pool.slots[b.pool._by_name[v.inner]]


def save_unified(path: str | pathlib.Path, pool) -> None:
    """Checkpoint a UnifiedPool: every config bucket's device states, the
    bucket FIFOs, live-input FIFOs, voice configs and schedules.
    Pipelined fetches are drained into the bucket FIFOs first (in dispatch
    order), so the emitted sample stream is continuous across save and
    resume.  Tracks are not stored; reload them before resuming."""
    path = pathlib.Path(path)
    arrays: dict[str, np.ndarray] = {}
    buckets_meta = {}
    for bi, key in enumerate(_bucket_ids(pool)):
        b = pool.buckets[key]
        if key[0] == "file" and pool.pipeline_fetch:
            drained = b.pool.drain()
            if drained:
                b.fifo = np.concatenate([b.fifo, *drained], axis=1)
        for k, leaf in _flatten(_state_to_numpy(b.pool.states)).items():
            arrays[f"b{bi}/state{k}"] = leaf
        arrays[f"b{bi}/fifo"] = b.fifo
        if key[0] == "live":
            for inner, arr in zip(b.pool.names, b.pool._in_fifo):
                arrays[f"b{bi}/infifo/{inner}"] = arr
        buckets_meta[str(bi)] = {
            "key": list(key),
            "capacity": b.pool.capacity,
            "members": dict(b.members),
            "out_pos": b.pool.out_pos,
        }
    placed_file = lambda v: v.mode == "file" and v.bucket_key is not None
    meta = {
        "kind": "unified",
        "out_pos": pool.out_pos,
        "sample_rate": pool.sample_rate,
        "channels": pool.channels,
        "engine": pool.engine,
        "quantum": pool.quantum,
        "voices": [
            {
                "name": v.name,
                "mode": v.mode,
                "block_ms": v.block_ms,
                "overlap": v.overlap,
                "split": v.split,
                "volume": v.volume,
                "pan": v.pan,
                "segments": [dataclasses.asdict(s) for s in v.timemap.segments],
                "track_len": _file_slot(pool, v).track_len if placed_file(v) else 0,
                "loaded": _file_slot(pool, v).loaded if placed_file(v) else False,
            }
            for v in pool.voices.values()
        ],
        "buckets": buckets_meta,
    }
    np.savez(path.with_suffix(".state.npz"), **arrays)
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def load_unified(path: str | pathlib.Path, pool) -> None:
    """Restore a :func:`save_unified` checkpoint into a fresh UnifiedPool
    built with the same (sample_rate, channels, engine, quantum), on the
    pool's device.  Existing voices are removed; saved voices are re-added
    in insertion order (bucket slot assignment is deterministic), then each
    bucket's device states, FIFOs and schedules are restored bit for bit.
    Reload tracks (``load_track``) after this returns."""
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".meta.json").read_text())
    if meta.get("kind") != "unified":
        raise ValueError("not a unified-pool checkpoint")
    for want, have in (
        ("sample_rate", pool.sample_rate),
        ("channels", pool.channels),
        ("engine", pool.engine),
        ("quantum", pool.quantum),
    ):
        if meta[want] != have:
            raise ValueError(f"{want} mismatch: {meta[want]} vs {have}")
    data = np.load(path.with_suffix(".state.npz"), allow_pickle=False)
    for name in list(pool.voices):
        pool.remove_voice(name)
    pool.out_pos = int(meta["out_pos"])
    for vm in meta["voices"]:
        pool.add_voice(vm["name"], mode=vm["mode"], block_ms=vm["block_ms"],
                       overlap=vm["overlap"], split=vm["split"], volume=vm["volume"],
                       pan=vm["pan"])
    ids = _bucket_ids(pool)
    if len(ids) != len(meta["buckets"]):
        raise ValueError("bucket set mismatch after re-adding voices")
    for bi, key in enumerate(ids):
        bm = meta["buckets"][str(bi)]
        if list(key) != bm["key"]:
            raise ValueError(f"bucket key mismatch: {key} vs {bm['key']}")
        b = pool.buckets[key]
        if b.members != bm["members"]:
            raise ValueError(f"member mapping diverged: {b.members} vs {bm['members']}")
        if int(bm["capacity"]) < b.pool.capacity:
            # grow() cannot shrink: restored leaves of the saved width would
            # disagree with the fresh pool's slots
            raise ValueError(
                f"bucket {key} capacity mismatch: checkpoint has {bm['capacity']}, fresh "
                f"pool already {b.pool.capacity} (construct the pool with bucket_capacity "
                "<= the saved one)")
        b.pool.grow(int(bm["capacity"]))
        b.pool.states = _load_states(b.pool, data, f"b{bi}/state")
        b.pool.out_pos = int(bm["out_pos"])
        b.fifo = data[f"b{bi}/fifo"]
        if key[0] == "live":
            for j, inner in enumerate(b.pool.names):
                k = f"b{bi}/infifo/{inner}"
                if k in data:
                    b.pool._in_fifo[j] = data[k]
    for vm in meta["voices"]:
        v = pool.voices[vm["name"]]
        v.timemap.segments = [Segment(**s) for s in vm["segments"]]
        if v.mode == "file":
            s = _file_slot(pool, v)
            s.volume = s._prev_volume = float(vm["volume"])
            s.pan = s._prev_pan = float(vm["pan"])
            s.track_len = int(vm["track_len"])
            s.loaded = bool(vm["loaded"])
