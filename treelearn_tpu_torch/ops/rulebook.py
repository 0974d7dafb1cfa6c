"""Submanifold rulebook from sorted voxel keys — kernel 1 of the port.

Replaces the Pallas kernel ``_rd_kernel`` / ``build_spans_banded``
(treelearn_tpu/ops/pallas_rd.py:68,145).  That kernel emits the banded-window
reduction ``BandSpans`` of the rule, because the TPU conv consumes windows
and never the rule itself.  A GPU gathers cheaply, so the CUDA kernel
(csrc/rulebook.cu) emits the (27, V) int32 gather rule directly: one thread
per (offset, voxel) decodes the voxel, applies the x/y/z range guards of
pallas_rd.py:185-198 (so a probe never wraps into the next row or batch
element), and binary-searches ``key + delta`` in the sorted keys.

Bound on the card: memory — the keys are read (4 B per voxel, the binary
searches hit L2) and 108 B of rule are written per voxel; the writes are
coalesced along the voxel axis.
"""

from __future__ import annotations

import torch

from . import _cuda
from .sparse import SparseGrid, build_subm_rulebook


def subm_rulebook(grid: SparseGrid) -> torch.Tensor:
    """(27, V) int32 rule of a k=3 submanifold conv over ``grid``.

    CPU tensors take the plain version (ops/sparse.py:build_subm_rulebook);
    CUDA tensors launch the kernel.
    """
    keys = grid.keys
    if not keys.is_cuda:
        return build_subm_rulebook(grid, 3)
    _cuda.require(keys, "rulebook keys", torch.int32, 1)
    v = keys.shape[0]
    rule = torch.empty((27, v), dtype=torch.int32, device=keys.device)
    if v == 0:
        return rule
    sx, sy, sz = grid.spatial_shape
    _cuda.record("rulebook", grid=grid)
    lib = _cuda.library()
    code = lib.tl_rulebook(keys.data_ptr(), v, sx, sy, sz, rule.data_ptr(),
                           _cuda.stream_ptr(keys))
    _cuda.check(code, "tl_rulebook")
    _cuda.LAUNCHES["rulebook"] += 1
    return rule
