"""Kernel 4: the sequential band chain (``csrc/bandchain.cu``).

Replaces ``bauklank_tpu/ops/pallas/bandchain.py:band_chain``, with the
same operand layouts (streams minor, no lane padding):

    lead [9, B, S]    d1.re, d1.im, d2.re, d2.im, u.re, u.im, pi.re, pi.im, pe
    chan [C, 6, B, S] onehot(mc), lock.re, lock.im, pec, pic.re, pic.im
    out  [C, 2, B, S] out.re, out.im
"""

from __future__ import annotations

import torch

from bauklank_tpu_torch.kernels import LAUNCHES, on_cuda, require, stream_of
from bauklank_tpu_torch.kernels.build import check, library

__all__ = ["band_chain", "band_chain_ref", "root_ratio_mismatches", "band_step_cycles", "EPS",
           "MAX_CHANNELS"]

EPS = 1e-15          # engine.spectral.EPS
MAX_CHANNELS = 8     # the card kernel's widest form (csrc/bandchain.cu)


def band_chain_ref(lead: torch.Tensor, chan: torch.Tensor, long_step: int) -> torch.Tensor:
    """Plain version: a Python loop over B, in the Pallas kernel's
    real-valued operation order (bauklank_tpu/ops/pallas/bandchain.py)."""
    _, b_n, s_n = lead.shape
    c_n = chan.shape[0]
    out = torch.empty((c_n, 2, b_n, s_n), dtype=torch.float32, device=lead.device)
    # ring of the last long_step outputs: band j in slot j % long_step
    ring_r = torch.zeros((long_step, c_n, s_n), dtype=torch.float32, device=lead.device)
    ring_i = torch.zeros_like(ring_r)
    lead_b = lead.transpose(0, 1)      # [B, 9, S]
    chan_b = chan.permute(2, 0, 1, 3)  # [B, C, 6, S]
    for b in range(b_n):
        d1r, d1i, d2r, d2i, ur, ui, pir, pii, pe = lead_b[b]
        oh, lr, li, pec, pcr, pci = chan_b[b].unbind(1)        # each [C, S]
        m1, ml = (b - 1) % long_step, b % long_step
        # the leader's previous outputs (bands b-1 and b-L) through the
        # onehot: a single nonzero term, so the channel sum is exact
        o1r = (ring_r[m1] * oh).sum(0)
        o1i = (ring_i[m1] * oh).sum(0)
        olr = (ring_r[ml] * oh).sum(0)
        oli = (ring_i[ml] * oh).sum(0)
        hs = 1.0 if b >= 1 else 0.0
        hl = 1.0 if b >= long_step else 0.0
        phr = ur + hs * (o1r * d1r - o1i * d1i) + hl * (olr * d2r - oli * d2i)
        phi = ui + hs * (o1r * d1i + o1i * d1r) + hl * (olr * d2i + oli * d2r)
        p2 = phr * phr + phi * phi
        tiny = p2 <= EPS
        phr = torch.where(tiny, pir, phr)
        phi = torch.where(tiny, pii, phi)
        p2 = torch.where(tiny, pir * pir + pii * pii + EPS, p2)
        sc = torch.sqrt(pe / p2)
        omr = sc * phr
        omi = sc * phi
        cr = omr * lr - omi * li
        ci = omr * li + omi * lr
        c2 = cr * cr + ci * ci
        tc = c2 <= EPS
        cr = torch.where(tc, pcr, cr)
        ci = torch.where(tc, pci, ci)
        c2 = torch.where(tc, pcr * pcr + pci * pci + EPS, c2)
        scc = torch.sqrt(pec / c2)
        lead_c = oh > 0.5
        ocr = torch.where(lead_c, omr, scc * cr)
        oci = torch.where(lead_c, omi, scc * ci)
        out[:, 0, b] = ocr
        out[:, 1, b] = oci
        ring_r[ml] = ocr
        ring_i[ml] = oci
    return out


def band_chain(lead: torch.Tensor, chan: torch.Tensor, long_step: int) -> torch.Tensor:
    """Any ``long_step`` >= 1 and any channel count, as the Pallas kernel;
    the card kernel takes at most :data:`MAX_CHANNELS` channels."""
    name = "band_chain"
    require(lead.dim() == 3 and lead.shape[0] == 9, name, "expects lead [9, B, S]")
    require(chan.dim() == 4 and chan.shape[0] >= 1 and chan.shape[1] == 6
            and chan.shape[2:] == lead.shape[1:], name, "expects chan [C, 6, B, S] matching lead")
    require(lead.dtype == torch.float32 and chan.dtype == torch.float32, name,
            "lead and chan must be float32")
    require(long_step >= 1, name, f"long_step must be at least 1, got {long_step}")
    if not on_cuda(name, lead, chan):
        return band_chain_ref(lead, chan, long_step)
    require(chan.shape[0] <= MAX_CHANNELS, name,
            f"the card kernel takes at most {MAX_CHANNELS} channels, got {chan.shape[0]}")
    require(lead.is_contiguous() and chan.is_contiguous(), name,
            "operands must be contiguous")
    # the operand planes are staged in 16-byte copies (where S is a multiple of 4)
    require(lead.data_ptr() % 16 == 0 and chan.data_ptr() % 16 == 0, name,
            "operands must be 16-byte aligned")
    _, b_n, s_n = lead.shape
    c_n = chan.shape[0]
    out = torch.empty((c_n, 2, b_n, s_n), dtype=torch.float32, device=lead.device)
    err = library().bk_band_chain(
        lead.data_ptr(), chan.data_ptr(), out.data_ptr(), c_n, b_n, s_n, long_step,
        stream_of(lead))
    check(err, name)
    LAUNCHES[name] += 1
    return out


def root_ratio_mismatches(samples: int, seed: int = 0) -> int:
    """On the card: among about ``samples`` random operand pairs of its
    range, how many the kernel's branch-free ``sqrt(a / b)`` rounds
    otherwise than ``__fsqrt_rn(__fdiv_rn(a, b))`` (csrc/bandchain.cu).
    The kernel's bit-equality rests on this being 0."""
    per_thread = 1024
    blocks = max(1, samples // (256 * per_thread))
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = library().bk_root_ratio_check(seed, blocks, per_thread, bad.data_ptr(), stream_of(bad))
    check(err, "root_ratio_check")
    return int(bad.item())


def band_step_cycles() -> dict:
    """On the card: the cycles one warp alone takes for a dependent float
    add and for one band's step from registers (two channels with and
    without the long step, one channel): the least the kernel's loop could
    take a band (csrc/bandchain.cu)."""
    out = torch.zeros(8, dtype=torch.float32, device="cuda")
    for _ in range(2):    # the second pass finds its instructions cached
        check(library().bk_band_step_cycles(out.data_ptr(), stream_of(out)), "band_step_cycles")
    c = out.tolist()
    if c[5] != 1.0:
        raise RuntimeError("band_step_cycles: the timed steps left the shortcuts' range")
    return {"fadd_dependent": c[0], "step_2ch": c[2], "step_2ch_long_step_1": c[3],
            "step_1ch": c[4]}
