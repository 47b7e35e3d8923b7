"""Process-group meshes and stream sharding.

Port of ``bauklank_tpu/parallel/mesh.py`` on ``torch.distributed``.  A JAX
``Mesh`` names the devices of one process; here a
``torch.distributed.device_mesh.DeviceMesh`` names the ranks of the
process group the caller started (``torchrun --nproc-per-node=<cards>``,
or ``torch.distributed.init_process_group``), one rank per card:

- ``stream``: data parallelism over independent voices.  Each rank owns a
  contiguous block of the streams and steps it with the port's batched
  functions on its own card; no collective runs and nothing moves between
  ranks, so the step is the same step on every width of mesh.
- ``seq``: the hop axis of one long offline render spread over ranks
  (:mod:`bauklank_tpu_torch.parallel.seqpar`).

Arrays cross the boundary as ``DTensor``s sharded ``Shard(0)`` on the
stream axis (``DTensor.from_local``: no communication); inside a step every
rank works on its local tensors.  Rank ``r`` computes on
``cuda:{LOCAL_RANK}`` (the rank where ``LOCAL_RANK`` is unset), modulo
the visible cards, so several ranks may share one card; the CPU serves a
mesh built with ``device_type="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from bauklank_tpu_torch.engine.batched import batched_process_chunk
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = [
    "stream_mesh", "shard_streams", "sharded_step", "sharded_fidelity_step",
    "sharded_live_fidelity_step",
]


def require_group(what: str) -> None:
    """Raise unless a default process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs a process group: start one rank per card with torchrun "
            "(torchrun --nproc-per-node=<cards> script.py) or call "
            "torch.distributed.init_process_group first")


def rank_device(device_type: str) -> torch.device:
    """The device this rank computes on, made the current CUDA device:
    ``cuda:{LOCAL_RANK}`` modulo the visible cards, or the CPU.  Raises
    for ``"cuda"`` without a visible card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def stream_mesh(n_devices: int | None = None, device_type: str = DEFAULT_DEVICE) -> DeviceMesh:
    """1-D mesh named ``("stream",)`` over every rank of the process group.
    ``n_devices``, where given, must be the group's size: a stream mesh
    spans the group (start as many ranks as cards)."""
    require_group("stream_mesh")
    rank_device(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a stream mesh spans the process group's {world} ranks; "
                         f"asked for {n} (start one rank per card)")
    return DeviceMesh(device_type, torch.arange(world), mesh_dim_names=("stream",))


def _stream_axis(mesh: DeviceMesh) -> tuple[int, int]:
    """(stream ranks, this rank's stream coordinate) of ``mesh``."""
    names = mesh.mesh_dim_names or ()
    if "stream" not in names:
        raise ValueError(f"the mesh has no 'stream' axis (axes {names})")
    dim = names.index("stream")
    return mesh.size(dim), mesh.get_local_rank(dim)


def _placements(mesh: DeviceMesh) -> list:
    return [Shard(0) if name == "stream" else Replicate() for name in mesh.mesh_dim_names]


def shard_streams(mesh: DeviceMesh, tree):
    """Place a tree (tuples, named tuples) whose leaves (tensors or numpy
    arrays) have a leading stream axis onto ``mesh``: each rank keeps its
    contiguous block of rows, copied to its device, as a ``DTensor``
    sharded ``Shard(0)`` on the stream axis.  Every rank passes the whole
    tree.  A stream count the mesh's stream ranks do not divide raises, as
    JAX's ``NamedSharding`` does."""
    n, r = _stream_axis(mesh)
    dev = mesh_device(mesh)

    def put(x):
        if not torch.is_tensor(x):
            x = np.asarray(x)
            x = torch.from_numpy(np.ascontiguousarray(x) if x.ndim else x)
        if x.dim() == 0:
            raise ValueError("a leaf without a leading stream axis cannot be stream-sharded")
        s = x.shape[0]
        if s % n:
            raise ValueError(f"{s} streams do not divide over the mesh's {n} stream ranks")
        rows = x[r * (s // n):(r + 1) * (s // n)].to(dev, copy=True).contiguous()
        return DTensor.from_local(rows, mesh, _placements(mesh), run_check=False)

    return tree_map(put, tree)


def _local(mesh: DeviceMesh, x) -> torch.Tensor:
    if not isinstance(x, DTensor):
        raise TypeError(f"a sharded step takes DTensors from shard_streams, got {type(x).__name__}")
    if x.device_mesh != mesh or tuple(x.placements) != tuple(_placements(mesh)):
        raise ValueError(f"a DTensor placed {x.placements} on {x.device_mesh}, not "
                         f"stream-sharded on {mesh}")
    return x.to_local()


def _local_shards(mesh: DeviceMesh, tree):
    """This rank's local tensors of a stream-sharded tree."""
    return tree_map(lambda x: _local(mesh, x), tree)


def _stream_sharded(mesh: DeviceMesh, tree):
    """Wrap this rank's local tensors as the stream-sharded ``DTensor``s."""
    return tree_map(lambda x: DTensor.from_local(x, mesh, _placements(mesh), run_check=False),
                    tree)


def sharded_step(config, mesh: DeviceMesh):
    """The batched serving step of the fast engine
    (:func:`engine.batched.batched_process_chunk`) with stream sharding
    over ``mesh``.

    Returns ``step(states, audios, frame_ends, params) -> (states, out)``
    whose arguments and results are stream-sharded ``DTensor``s.  JAX
    donates the states; here the step returns new ones: do not reuse the
    states passed in."""
    _stream_axis(mesh)

    def step(states, audios, frame_ends, params):
        args = _local_shards(mesh, (states, audios, frame_ends, params))
        return _stream_sharded(mesh, batched_process_chunk(config, *args))

    return step


def _formant_count(fmt: tuple, formants: bool) -> None:
    want = 3 if formants else 0
    if len(fmt) != want:
        raise TypeError(f"the step takes {want} formant controls, got {len(fmt)}")


def sharded_fidelity_step(scfg, mesh: DeviceMesh, formants: bool = False):
    """The blob-exact pool step
    (:func:`engine.fidelity.batched_fidelity_chunk`) with stream sharding
    over ``mesh``.  Every stage of a hop is independent per stream (the
    sequential band chain runs over bands, within a stream), so hops of
    one stream stay on one rank and the mesh spreads streams; no
    collective runs.

    Returns ``step(states, audios, ends, tf, mult, limit, active, *fmt)``
    (``fmt``: the three formant controls where ``formants``) whose
    arguments and results are stream-sharded ``DTensor``s.  Each rank's
    regime (time factor <= 2) is its own shard's: the step gives the
    chunk no word on it, so the MINSTD draws are computed on every shard
    and the fused fetch (``BAUKLANK_CHAINFETCH``) reads its shard's time
    factors.  The states passed in are not to be reused (JAX donates
    them)."""
    from bauklank_tpu_torch.engine.fidelity import batched_fidelity_chunk

    _stream_axis(mesh)

    def step(states, audios, ends, tf, mult, limit, active, *fmt):
        _formant_count(fmt, formants)
        args = _local_shards(mesh, (states, audios, ends, tf, mult, limit, active, *fmt))
        return _stream_sharded(mesh, batched_fidelity_chunk(scfg, *args))

    return step


def sharded_live_fidelity_step(scfg, hops: int, mesh: DeviceMesh, formants: bool = False):
    """The blob-exact coupled (live-input) step
    (:func:`engine.fidelity.batched_live_fidelity_chunk`) with stream
    sharding over ``mesh``: each voice carries its own input ring, so the
    mesh spreads voices and no collective runs.

    Returns ``step(states, chunks, mult, limit, active, *fmt)`` whose
    arguments and results are stream-sharded ``DTensor``s; ``chunks`` is
    ``[S, C, hops * scfg.interval]`` of live input (another width raises).
    The states passed in are not to be reused (JAX donates them)."""
    from bauklank_tpu_torch.engine.fidelity import batched_live_fidelity_chunk

    _stream_axis(mesh)

    def step(states, chunks, mult, limit, active, *fmt):
        _formant_count(fmt, formants)
        args = _local_shards(mesh, (states, chunks, mult, limit, active, *fmt))
        if args[1].shape[-1] != hops * scfg.interval:
            raise ValueError(f"chunks of {args[1].shape[-1]} samples; the step was built for "
                             f"{hops} hops of {scfg.interval}")
        return _stream_sharded(mesh, batched_live_fidelity_chunk(scfg, *args))

    return step
