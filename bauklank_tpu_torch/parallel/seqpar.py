"""Sequence (hop-axis) parallelism: one offline render spread over ranks.

Port of ``bauklank_tpu/parallel/seqpar.py`` on ``torch.distributed``.  For
a long render the hop axis is sharded over the ``seq`` axis of a 2-D
``(stream, seq)`` mesh; streams stay data parallel.  Three things cross
ranks:

1. the carried band-rotation prefix: each rank scans its own hops
   (``ops.scan.associative_scan``, the fast engine's "last reset wins"
   combine), then folds the totals of the ranks before it, gathered over
   ``seq``, in rank order (rotations are unit complex, so the composition
   is exact);
2. the previous hop's mapped spectrum that a rank's first factor needs:
   not sent; every rank analyses one overlap hop in front of its own
   (analysis is a function of the input audio, which every rank holds);
3. the overlap-add boundary: a rank's synthesis tail (one block) belongs
   to the first samples of the rank after it.  The tails are gathered
   over ``seq`` and each rank adds its left neighbour's (JAX sends it with
   ``ppermute``; the gather is exact and costs one block a rank).

Collective operands live where the group's backend takes them: on the
card for ``nccl``, on the host for ``gloo`` (whose all-gather takes CPU
tensors).  The flags and the complex totals travel as one float32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.core import _combine, hop_factors, synthesis
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.ops import mdft, pitchmap
from bauklank_tpu_torch.ops.scan import associative_scan
from bauklank_tpu_torch.parallel.mesh import mesh_device, rank_device, require_group
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE
from bauklank_tpu_torch.utils.tree import tree_map

__all__ = ["stream_seq_mesh", "stretch_offline_sharded"]


def stream_seq_mesh(n_stream: int, n_seq: int, device_type: str = DEFAULT_DEVICE) -> DeviceMesh:
    """2-D mesh named ``("stream", "seq")`` over the process group's
    ``n_stream * n_seq`` ranks, rank ``r`` at ``(r // n_seq, r % n_seq)``
    (JAX's ``reshape(n_stream, n_seq)`` of its devices)."""
    require_group("stream_seq_mesh")
    rank_device(device_type)
    world = dist.get_world_size()
    if n_stream < 1 or n_seq < 1 or n_stream * n_seq != world:
        raise ValueError(f"a {n_stream} x {n_seq} mesh needs {n_stream * n_seq} ranks; the "
                         f"process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_stream, n_seq),
                      mesh_dim_names=("stream", "seq"))


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` in ``group``, in rank order, on ``t``'s device;
    through the host where the group's backend is gloo."""
    host = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def _frame_ends(rates: np.ndarray, config: StretchConfig, n_seq: int, h_local: int) -> np.ndarray:
    """[S, n_seq, h_local + 1] exclusive frame ends of every rank's hops,
    one overlap hop in front; seq rank 0's overlap frame is parked out of
    range, so its first hop restarts its phase from the input as the
    one-card engine does after a reset."""
    i, b = config.interval, config.block
    g = np.arange(-1, n_seq * h_local, dtype=np.float64)   # global hop index, -1 = overlap
    centers = (g * i + b / 2.0)[None] * np.asarray(rates, np.float64)[:, None]
    e = np.round(centers).astype(np.int64) + b // 2        # [S, H + 1]
    ends = np.stack([e[:, d * h_local:(d + 1) * h_local + 1] for d in range(n_seq)], axis=1)
    ends[:, 0, 0] = -10 * b
    return ends


def stretch_offline_sharded(audio, rates, config: StretchConfig, params: StretchParams,
                            n_out: int, mesh: DeviceMesh):
    """Render every stream's first ``n_out`` samples with its hops sharded
    over ``mesh``'s ``seq`` axis and its streams over ``stream``.

    audio [S, C, T] and rates [S] (numpy or tensors), params a
    :class:`StretchParams` with [S] fields; every rank passes all of them.
    The hops are padded to a multiple of the seq ranks and each rank's
    share must cover a block (``h_local * interval >= block``: the halo
    reaches one neighbour), else it raises.  Returns a ``DTensor`` placed
    ``[Shard(0), Shard(2)]`` of the whole hop span, [S, C, H * interval]:
    ``out.full_tensor()[..., :n_out]`` is JAX's result."""
    i, b = config.interval, config.block
    names = mesh.mesh_dim_names or ()
    if names != ("stream", "seq"):
        raise ValueError(f"a ('stream', 'seq') mesh is needed, got axes {names}")
    n_stream, n_seq = mesh.size(0), mesh.size(1)
    si, qi = mesh.get_local_rank("stream"), mesh.get_local_rank("seq")
    h_total = -(-n_out // i)
    h_local = -(-h_total // n_seq)
    if h_local * i < b:
        raise ValueError(f"{h_local} hops a rank cover {h_local * i} samples; the overlap-add "
                         f"halo needs >= {-(-b // i)} local hops a rank (one block)")
    audio = torch.as_tensor(audio)
    s = audio.shape[0]
    if s % n_stream:
        raise ValueError(f"{s} streams do not divide over the mesh's {n_stream} stream ranks")
    rows = slice(si * (s // n_stream), (si + 1) * (s // n_stream))
    rates = np.asarray(rates.cpu() if torch.is_tensor(rates) else rates, np.float64)
    dev = mesh_device(mesh)
    ends = _frame_ends(rates[rows], config, n_seq, h_local)[:, qi]
    audio_l = audio[rows].to(dev, torch.float32).contiguous()
    params_l = tree_map(lambda x: torch.as_tensor(x)[rows].to(dev, torch.float32), params)
    zeros_prev = torch.zeros((audio_l.shape[0], config.channels, config.bins),
                             dtype=torch.complex64, device=dev)

    v, cur_m, gain, reset = hop_factors(
        config, audio_l, torch.from_numpy(ends.astype(np.int32)).to(dev), params_l, zeros_prev)
    # drop the overlap hop: its factor restarts the rotation, its spectrum
    # seeded the previous-hop chain inside hop_factors
    v, cur_m, gain, reset = v[:, 1:], cur_m[:, :, 1:], gain[:, :, 1:], reset[:, 1:]

    one = torch.ones((), dtype=v.dtype, device=dev)
    flags_l, z_l = associative_scan(_combine, [reset, torch.where(reset, one, v)], dim=1)
    seq_group = mesh.get_group("seq")
    tot = torch.stack([flags_l[:, -1].to(torch.float32), z_l[:, -1].real, z_l[:, -1].imag], -1)
    totals = _all_gather(tot, seq_group)
    pf = torch.zeros_like(flags_l[:, -1])
    pz = torch.ones_like(z_l[:, -1])
    for k in range(qi):          # the ranks before this one, in rank order
        pf, pz = _combine([pf, pz], [totals[k][..., 0] > 0.5,
                                     torch.complex(totals[k][..., 1], totals[k][..., 2])])
    rot_seq = torch.where(flags_l, z_l, mdft.cmul(pitchmap.unit(pz)[:, None, :], z_l))

    tail0 = torch.zeros((audio_l.shape[0], config.channels, b), dtype=torch.float32, device=dev)
    emit, tail = synthesis(config, rot_seq, cur_m, gain, tail0, params_l.active)
    tails = _all_gather(tail, seq_group)
    if qi > 0:
        emit[..., :b] += tails[qi - 1] * params_l.active[:, None, None]
    return DTensor.from_local(emit.contiguous(), mesh, [Shard(0), Shard(2)], run_check=False)
