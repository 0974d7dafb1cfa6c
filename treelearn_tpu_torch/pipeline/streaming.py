"""Streaming tile pipeline: sort-once bucketing + in-memory tile iteration.

The reference materializes every overlapping tile to disk as npz (~100 GB host
RAM / 700 GB disk at L1W scale, docs/segmentation_pipeline.md:54) and applies
one O(V) mask per tile on the GPU (data_preparation.py:393-439).  Here the
voxelized plot is sorted once by tile-grid cell; every tile's outer square is
then a small set of *contiguous* row ranges (one per cell row), so cutting a
tile is pure slicing — O(V log V) total instead of O(tiles * V) — and tiles
stream straight into the padded device batches without touching disk.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..data.dataset import collate_padded, semantic_from_instance, get_offset_labels
from .tiles import compute_tile_grid


class TileStream:
    """In-memory tile source over a voxelized plot."""

    def __init__(self, points: np.ndarray, labels: np.ndarray,
                 feats: np.ndarray, inner_edge: float, outer_edge: float,
                 stride: float):
        self.inner_edge = inner_edge
        self.outer_edge = outer_edge

        x_range = (points[:, 0].min(), points[:, 0].max())
        y_range = (points[:, 1].min(), points[:, 1].max())
        self.inner, self.outer = compute_tile_grid(
            x_range, y_range, inner_edge, outer_edge, stride)

        # grid cells: one sort of the plot, then tiles = unions of cell ranges
        cell = max(inner_edge * stride, 1e-3)
        self.cell = cell
        self.x0 = points[:, 0].min()
        self.y0 = points[:, 1].min()
        cx = np.floor((points[:, 0] - self.x0) / cell).astype(np.int64)
        cy = np.floor((points[:, 1] - self.y0) / cell).astype(np.int64)
        self.nx = int(cx.max()) + 1
        self.ny = int(cy.max()) + 1
        keys = cx * self.ny + cy
        self.order = np.argsort(keys, kind="stable")
        sorted_keys = keys[self.order]
        # starts[c] = first sorted row of cell c (searchsorted-ready)
        self.starts = np.searchsorted(sorted_keys, np.arange(self.nx * self.ny + 1))

        data = np.hstack([points, labels[:, None], feats])
        self.sorted_data = data[self.order]

    def __len__(self):
        return len(self.inner)

    def _cells_rows(self, xmin, xmax, ymin, ymax):
        """Concatenate the sorted-row ranges of all cells intersecting the box.

        Returns (data, sorted_row_indices): the latter feeds the integer
        point-id plumbing (``self.order[rows]`` = rows of the ORIGINAL input
        cloud), which downstream replaces every quantized-coordinate re-join
        with an O(N) gather/scatter.
        """
        cx0 = max(int((xmin - self.x0) // self.cell), 0)
        cx1 = min(int((xmax - self.x0) // self.cell), self.nx - 1)
        cy0 = max(int((ymin - self.y0) // self.cell), 0)
        cy1 = min(int((ymax - self.y0) // self.cell), self.ny - 1)
        empty = (np.empty((0, self.sorted_data.shape[1])),
                 np.empty(0, np.int64))
        if cx1 < cx0 or cy1 < cy0:
            return empty
        parts, rows = [], []
        for ix in range(cx0, cx1 + 1):
            base = ix * self.ny
            lo = self.starts[base + cy0]
            hi = self.starts[base + cy1 + 1]
            if hi > lo:
                parts.append(self.sorted_data[lo:hi])
                rows.append(np.arange(lo, hi, dtype=np.int64))
        if not parts:
            return empty
        return np.concatenate(parts, axis=0), np.concatenate(rows)

    def tile(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        """Cut tile i: outer-box points, centered on the inner square.

        Returns None for empty tiles (parity: reference skips tiles whose
        inner square holds no points, data_preparation.py:413-429).
        """
        xi0, xi1, yi0, yi1 = self.inner[i]
        xo0, xo1, yo0, yo1 = self.outer[i]
        box, box_rows = self._cells_rows(xo0, xo1, yo0, yo1)
        if len(box) == 0:
            return None
        m = ((box[:, 0] >= xo0) & (box[:, 0] <= xo1)
             & (box[:, 1] >= yo0) & (box[:, 1] <= yo1))
        chunk = box[m]
        chunk_rows = box_rows[m]
        if len(chunk) == 0:
            return None
        mi = ((chunk[:, 0] >= xi0) & (chunk[:, 0] < xi1)
              & (chunk[:, 1] > yi0) & (chunk[:, 1] <= yi1))
        if not mi.any():
            return None

        cx = np.round((xi0 + xi1) / 2, 6)
        cy = np.round((yi0 + yi1) / 2, 6)
        xyz = chunk[:, :3].copy()
        xyz[:, 0] -= cx
        xyz[:, 1] -= cy
        return {
            "points": xyz.astype(np.float32),
            "instance_label": chunk[:, 3].astype(np.int64),
            "feat": chunk[:, 4:].astype(np.float32),
            "center": np.array([cx, cy, 0.0]),
            # rows of the ORIGINAL (pre-sort) input cloud for each point
            "point_ids": self.order[chunk_rows],
        }

    def whole_plot_batches(self, min_bucket: int = 1 << 14
                           ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield ONE padded batch holding the entire plot.

        TPU-native alternative to the overlapping-tile decomposition: the
        U-Net is fully convolutional (submanifold convs are translation
        equivariant), so the reference's 35 m windows exist only because of
        GPU memory — on a chip that fits the whole plot, a single pass
        removes the ~(outer_edge / (inner_edge * stride))^2 (≈77x at default
        geometry) recompute of every voxel through overlapping context
        windows, and gives every point full receptive-field context instead
        of a truncated window.  Downstream stages are unchanged: every point
        is inner, centers are zero (the plot is pre-centered by the
        pipeline).
        """
        data = self.sorted_data
        xyz = data[:, :3].astype(np.float64)
        instance_label = data[:, 3].astype(np.int64)
        semantic_label = semantic_from_instance(instance_label)
        offset_label, mask_valid = get_offset_labels(xyz, instance_label,
                                                     semantic_label)
        mask_not_ignore = instance_label != -1
        ones = np.ones(len(xyz), bool)
        yield collate_padded([{
            "coords": xyz.astype(np.float32),
            "input_feats": data[:, 4:].astype(np.float32),
            "instance_labels": instance_label,
            "semantic_labels": semantic_label.astype(np.int64),
            "offset_labels": offset_label,
            "centers": np.zeros_like(xyz, dtype=np.float32),
            "masks_inner": ones,
            "masks_off": (mask_not_ignore & (semantic_label != 1) & mask_valid),
            "masks_sem": mask_not_ignore,
            # original-cloud row of each (sorted) point: downstream stages
            # propagate by this integer id instead of re-joining float coords
            "point_ids": self.order.astype(np.int64),
        }], min_bucket=min_bucket)

    def batches(self, batch_size: int = 1, inner_square_edge_length: float = None,
                min_bucket: int = 1 << 14) -> Iterator[Dict[str, np.ndarray]]:
        """Yield padded batches in the TreeDataset sample format (no disk)."""
        edge = inner_square_edge_length or self.inner_edge
        samples = []
        for i in range(len(self)):
            t = self.tile(i)
            if t is None:
                continue
            xyz = t["points"].astype(np.float64)
            instance_label = t["instance_label"]
            semantic_label = semantic_from_instance(instance_label)
            offset_label, mask_valid = get_offset_labels(xyz, instance_label,
                                                         semantic_label)
            inf_norm = np.linalg.norm(xyz[:, :-1], ord=np.inf, axis=1)
            mask_inner = inf_norm <= (edge / 2)
            mask_not_ignore = instance_label != -1
            samples.append({
                "coords": xyz.astype(np.float32),
                "input_feats": t["feat"],
                "instance_labels": instance_label,
                "semantic_labels": semantic_label.astype(np.int64),
                "offset_labels": offset_label,
                "centers": np.broadcast_to(t["center"], xyz.shape).astype(np.float32),
                "masks_inner": mask_inner,
                "masks_off": (mask_inner & mask_not_ignore
                              & (semantic_label != 1) & mask_valid),
                "masks_sem": mask_inner & mask_not_ignore,
                "point_ids": t["point_ids"],
            })
            if len(samples) == batch_size:
                yield collate_padded(samples, min_bucket=min_bucket)
                samples = []
        if samples:
            yield collate_padded(samples, min_bucket=min_bucket)
