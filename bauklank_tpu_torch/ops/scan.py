"""Parallel prefix in JAX's ``lax.associative_scan`` order.

The port's two scans (the fidelity smoother's affine recursion and the
fast engine's rotation prefix) must round as the JAX package rounds, so
they combine elements in the same tree as ``lax.associative_scan``: pair
neighbours, scan the pairs recursively, then fold each even element onto
the scanned pair before it.
"""

from __future__ import annotations

import torch

__all__ = ["associative_scan"]


def _take(e: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    return e[(slice(None),) * (dim % e.dim()) + (sl,)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """out[0::2] = even, out[1::2] = odd along ``dim`` (len(even) -
    len(odd) in {0, 1})."""
    d = dim % even.dim()
    k = odd.shape[d]
    pairs = torch.stack([even.narrow(d, 0, k), odd], dim=d + 1).flatten(d, d + 1)
    if even.shape[d] > k:
        pairs = torch.cat([pairs, even.narrow(d, k, 1)], dim=d)
    return pairs


def associative_scan(fn, elems: list, dim: int) -> list:
    """Inclusive scan of the associative ``fn(a, b) -> c`` (each a list of
    tensors, combined element-wise) along ``dim`` of every tensor in
    ``elems``."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn([_take(e, dim, slice(0, -1, 2)) for e in elems],
                                  [_take(e, dim, slice(1, None, 2)) for e in elems]), dim)
    head = [_take(e, dim, slice(0, -1)) for e in odd] if n % 2 == 0 else odd
    even = fn(head, [_take(e, dim, slice(2, None, 2)) for e in elems])
    even = [torch.cat([_take(e, dim, slice(0, 1)), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]
