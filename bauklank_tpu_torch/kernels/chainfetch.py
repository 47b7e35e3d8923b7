"""Kernel 7: the fused six-family fetch (``csrc/chainfetch.cu``).

Replaces ``bauklank_tpu/ops/pallas/chainfetch.py:chainfetch``.  In the
deterministic regime (every stream at time factor <= 2) the vertical
time step is the scalar ``c = clamp(time factor, 0.5, 2)``, so the six
gather families of the chain inputs are functions of three position
tables and ``c``: ``spec`` at ``input_bin``, ``input_bin - c``,
``input_bin - L c``, ``us_pos``, ``ul_pos`` and ``prev | energy`` at
``input_bin``.  One launch serves them all, in the layouts of the two
:func:`~bauklank_tpu_torch.kernels.gather.frac_gather` calls it replaces
and equal to them bit for bit.  The TPU kernel's block size ``t1`` and the
band grids it cannot host do not exist here: every shape is served.
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library
from bauklank_tpu_torch.kernels.gather import frac_gather_ref

__all__ = ["chainfetch", "chainfetch_ref"]


def chainfetch_ref(spec_planes, prev_planes, energy, input_bin, us_pos, ul_pos, step,
                   long_step: int):
    """Plain version: the two fractional gathers on the concatenated
    positions and planes (the differences rounded in float32)."""
    c = step[:, None]
    pos5 = torch.cat([input_bin, input_bin - c, input_bin - float(long_step) * c,
                      us_pos, ul_pos], dim=1)
    five = frac_gather_ref(spec_planes, pos5)
    comb = frac_gather_ref(torch.cat([prev_planes, energy], dim=2), input_bin)
    return five, comb


def chainfetch(spec_planes: torch.Tensor, prev_planes: torch.Tensor, energy: torch.Tensor,
               input_bin: torch.Tensor, us_pos: torch.Tensor, ul_pos: torch.Tensor,
               step: torch.Tensor, long_step: int):
    """spec_planes, prev_planes [N, B, 2C], energy [N, B, C], input_bin,
    us_pos, ul_pos [N, B], step [N], all float32 -> (five [N, 5B, 2C] in
    the table order pred | down_s | down_l | us | ul, comb [N, B, 3C])."""
    name = "chainfetch"
    operands = (spec_planes, prev_planes, energy, input_bin, us_pos, ul_pos, step)
    require(spec_planes.dim() == 3 and energy.dim() == 3 and input_bin.dim() == 2
            and step.dim() == 1, name,
            "expects planes [N, B, 2C], energy [N, B, C], positions [N, B] and step [N]")
    require(all(t.dtype == torch.float32 for t in operands), name,
            "operands must be float32")
    n_n, b_n, c_n = energy.shape
    require(spec_planes.shape == prev_planes.shape == (n_n, b_n, 2 * c_n)
            and input_bin.shape == us_pos.shape == ul_pos.shape == (n_n, b_n)
            and step.shape == (n_n,), name, "operands disagree on N, B or C")
    require(int(long_step) >= 1, name, f"long_step {long_step} must be >= 1")
    if not on_cuda(name, *operands):
        return chainfetch_ref(*operands, long_step)
    require(all(t.is_contiguous() for t in operands), name, "operands must be contiguous")
    # a row of planes moves as one float4 or float2
    require(all(t.data_ptr() % 16 == 0 for t in operands), name,
            "operands must be 16-byte aligned")
    dev = spec_planes.device
    five = torch.empty((n_n, 5 * b_n, 2 * c_n), dtype=torch.float32, device=dev)
    comb = torch.empty((n_n, b_n, 3 * c_n), dtype=torch.float32, device=dev)
    err = library().bk_chainfetch(
        *(t.data_ptr() for t in operands), five.data_ptr(), comb.data_ptr(),
        n_n, b_n, c_n, int(long_step), stream_of(spec_planes))
    check(err, name)
    LAUNCHES[name] += 1
    return five, comb
