"""Submanifold rulebook from sorted voxel keys — kernel 1 of the port.

Replaces the Pallas kernel ``_rd_kernel`` / ``build_spans_banded``
(treelearn_tpu/ops/pallas_rd.py:68,145).  That kernel emits the banded-window
reduction ``BandSpans`` of the rule, because the TPU conv consumes windows
and never the rule itself.  A GPU gathers cheaply, so the CUDA kernel
(csrc/rulebook.cu) emits the (27, V) int32 gather rule directly, in band
form: one thread per ((dx, dy) band, voxel) decodes the voxel, applies the
x/y/z range guards of pallas_rd.py:185-198 (so a probe never wraps into the
next row or batch element), binary-searches the band's dz = -1 key once and
matches the three consecutive slots from there against the three dz targets
by key; the centre band looks at slots i-1, i, i+1 without a search.
ops/sparse.py:build_subm_rulebook_banded is the same algorithm in plain
PyTorch, build_subm_rulebook the 27-probe form both are held to.

Bound on the card: memory -- the keys are read (4 B per voxel, the binary
searches hit L2) and 108 B of rule are written per voxel; the writes are
coalesced along the voxel axis.
"""

from __future__ import annotations

import torch

from . import _cuda
from .sparse import SparseGrid, build_subm_rulebook


def _rulebook_cuda(grid: SparseGrid, probes: bool) -> torch.Tensor:
    keys = grid.keys
    _cuda.require(keys, "rulebook keys", torch.int32, 1)
    v = keys.shape[0]
    rule = torch.empty((27, v), dtype=torch.int32, device=keys.device)
    if v == 0:
        return rule
    sx, sy, sz = grid.spatial_shape
    if not probes:
        _cuda.record("rulebook", grid=grid)
    lib = _cuda.library()
    fn = lib.tl_rulebook_probes if probes else lib.tl_rulebook
    code = fn(keys.data_ptr(), v, sx, sy, sz, rule.data_ptr(),
              _cuda.stream_ptr(keys))
    _cuda.check(code, "tl_rulebook")
    if not probes:
        _cuda.LAUNCHES["rulebook"] += 1
    return rule


def subm_rulebook(grid: SparseGrid) -> torch.Tensor:
    """(27, V) int32 rule of a k=3 submanifold conv over ``grid``.

    CPU tensors take the plain version (ops/sparse.py:build_subm_rulebook);
    CUDA tensors launch the kernel.
    """
    if not grid.keys.is_cuda:
        return build_subm_rulebook(grid, 3)
    return _rulebook_cuda(grid, probes=False)


def subm_rulebook_probes(grid: SparseGrid) -> torch.Tensor:
    """The same rule through the 27-probe kernel the band form replaced: the
    yardstick it is timed against on the card (chip_smoke.py, the card
    tests).  Nothing in the package calls it, and it is not counted."""
    return _rulebook_cuda(grid, probes=True)
