"""Serialization of a sparse voxel set for Point Transformer V3 (Wu et al.,
CVPR 2024, arXiv:2312.10035; Pointcept ``pointcept/models/utils/
serialization``): space-filling-curve codes on the device, the orders they
give, the stride-2 parent cells, and the patch padding of serialized
attention.

* A code is ``batch << 3 * depth | enc(grid)`` in int64.  ``enc`` is the
  z-order (bit interleave, x the most significant bit of each triple) or the
  Hilbert index (Skilling's transpose algorithm, read out in the same
  interleave); the ``-trans`` orders swap x and y first.  ``depth`` is the
  bit length of the largest grid coordinate at full resolution and falls by
  one a pooling; a parent cell's code is its children's code ``>> 3``, which
  equals the code of ``grid >> 1`` at ``depth - 1`` for both curves, so each
  stage encodes its own grid afresh.
* :func:`orders` gives, per order, the argsort of the codes and its inverse
  (codes of distinct voxels are distinct, so the sort is unique).
* :func:`patch_layout` pads each batch element's serialized rows up to a
  multiple of the patch size K: the pad rows of an element's last patch
  repeat the rows K earlier (its previous patch's tail), so every patch has
  exactly K real keys.  ``pad_src`` takes the padded rows from the
  serialized rows, ``unpad`` takes each serialized row back from them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
MAX_DEPTH = 16      # 48 bits of position, as Pointcept caps them

# bit spreading of a 21-bit integer into every third bit of 63
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
           (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
           (2, 0x1249249249249249))


def _spread3(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x1FFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def interleave(x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Bits of x, y, z interleaved, x the most significant of each triple."""
    return (_spread3(x) << 2) | (_spread3(y) << 1) | _spread3(z)


def z_order_code(grid: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 grid -> (N,) z-order codes."""
    g = grid.long()
    return interleave(g[:, 0], g[:, 1], g[:, 2])


def hilbert_code(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 grid of coordinates below ``2 ** depth`` -> (N,) Hilbert
    indices: Skilling's axes-to-transpose (inverse undo, then Gray code),
    the transpose read out most significant bit first, x before y before
    z."""
    x = [grid[:, a].long().clone() for a in range(3)]
    q = 1 << (depth - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            on = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(on, x[0] ^ p, x[0])
                continue
            t = (x[0] ^ x[i]) & p
            x[0] = torch.where(on, x[0] ^ p, x[0] ^ t)
            x[i] = torch.where(on, x[i], x[i] ^ t)
        q >>= 1
    for i in range(1, 3):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = 1 << (depth - 1)
    while q > 1:
        t = t ^ torch.where((x[2] & q) != 0, q - 1, 0)
        q >>= 1
    return interleave(x[0] ^ t, x[1] ^ t, x[2] ^ t)


def encode(grid: torch.Tensor, batch: torch.Tensor, depth: int,
           order: str) -> torch.Tensor:
    """``batch << 3 * depth | enc(grid)`` of one order of :data:`ORDERS`."""
    if order not in ORDERS:
        raise ValueError(f"unknown serialization order {order!r}")
    g = grid.long()
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
    code = z_order_code(g) if order.startswith("z") else hilbert_code(g, depth)
    return (batch.long() << (3 * depth)) | code


def depth_of(grid: torch.Tensor) -> int:
    """Bit length of the largest grid coordinate (one host read), at least
    1."""
    top = int(grid.max()) if grid.numel() else 0
    depth = max(int(top).bit_length(), 1)
    if depth > MAX_DEPTH:
        raise ValueError(f"grid coordinate {top} needs {depth} bits; "
                         f"serialization takes {MAX_DEPTH}")
    return depth


def orders(grid: torch.Tensor, batch: torch.Tensor, depth: int,
           names: Sequence[str], perm: torch.Tensor = None):
    """(codes, order, inverse), each (len(names), N) int64: per order the
    codes, their argsort and its inverse permutation; with ``perm`` (a
    device tensor) the orders ``names[perm]``.  Each curve encodes its
    plain and its ``-trans`` grid in one pass."""
    g = grid.long()
    n = g.shape[0]
    both = torch.cat([g, g[:, [1, 0, 2]]])
    enc = {}
    for curve in {o.split("-")[0] for o in names}:
        code = z_order_code(both) if curve == "z" else hilbert_code(both,
                                                                    depth)
        enc[curve], enc[curve + "-trans"] = code[:n], code[n:]
    codes = torch.stack([enc[o] for o in names]) | (
        batch.long() << (3 * depth))
    if perm is not None:
        codes = codes[perm]
    order = torch.argsort(codes, dim=1)
    inverse = torch.empty_like(order)
    ar = torch.arange(order.shape[1], device=order.device)
    inverse.scatter_(1, order, ar.expand_as(order).contiguous())
    return codes, order, inverse


class PatchLayout(NamedTuple):
    """Padding of serialized rows into patches of ``k`` rows."""

    k: int                 # patch size
    n_pad: int             # padded rows (a multiple of k)
    pad_src: torch.Tensor  # (n_pad,) int64: padded row -> serialized row
    unpad: torch.Tensor    # (N,) int64: serialized row -> padded row
    pad_rows: int          # n_pad - N


def patch_layout(counts: Sequence[int], patch_size: int,
                 device) -> PatchLayout:
    """The padding of :func:`patch_layout`'s docstring for batch elements of
    ``counts`` rows each (host ints; their rows consecutive in serialized
    order): K = min(patch_size, fewest rows of a non-empty element); each
    element padded up to a multiple of K, the pad rows repeating the rows K
    before them."""
    counts = [int(c) for c in counts]
    live = [c for c in counts if c > 0]
    k = min(int(patch_size), min(live)) if live else int(patch_size)
    padded = [-(-c // k) * k for c in counts]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pstarts = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    n_pad = int(sum(padded))
    # per padded row: its element's start, padded start and count
    elem = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.tensor(padded, device=device), output_size=n_pad)
    cnt = torch.tensor(counts, dtype=torch.int64, device=device)[elem]
    st = torch.tensor(starts, device=device)[elem]
    pst = torch.tensor(pstarts, device=device)[elem]
    j = torch.arange(n_pad, device=device) - pst
    pad_src = st + torch.where(j < cnt, j, j - k)
    n = int(sum(counts))
    eid = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.tensor(counts, device=device), output_size=n)
    shift = torch.tensor(pstarts - starts, device=device)
    unpad = torch.arange(n, device=device) + shift[eid]
    return PatchLayout(k, n_pad, pad_src, unpad, n_pad - n)
