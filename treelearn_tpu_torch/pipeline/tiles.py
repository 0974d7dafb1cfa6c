"""Tile and crop generation: cutting a plot into processable chunks.

Parity targets: SampleGenerator (reference tree_learn/util/data_preparation.py:
109-494) and generate_tiles (reference util/pipeline.py:24-75).  Inference
tiles are an inner prediction square (inner_edge) plus a context ring out to
outer_edge, laid on a regular grid with ``stride`` < 1 producing overlap; each
tile is centered on its inner square and saved as npz + json metadata.
Training crops are rotated random squares filtered by an occupancy grid.

All array math is numpy; the per-tile subsetting is a vectorized mask (the
reference round-trips through CUDA for this, data_preparation.py:393-439 —
unnecessary here since tiling is I/O-bound).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Optional

import numpy as np

from ..io.pointcloud import load_data
from ..ops.voxelize import voxel_downsample_trace_np
from ..utils.trace import span


def fill_occupancy_holes(occ: np.ndarray, how_far_fill: int,
                         min_percent_occupied_fill: float) -> np.ndarray:
    """Occupancy hole fill: a cell becomes occupied if >= threshold of its
    (2k+1)^2 edge-clipped neighborhood is occupied (parity: reference
    data_preparation.py:571-586 ``fill_holes``), computed for all cells at
    once via an integral image — O(cells), no per-cell Python loop."""
    x_dim, y_dim = occ.shape
    k = how_far_fill
    s = np.zeros((x_dim + 1, y_dim + 1))
    s[1:, 1:] = occ.cumsum(0).cumsum(1)
    i = np.arange(x_dim)
    j = np.arange(y_dim)
    li, ui = np.maximum(i - k, 0), np.minimum(i + k + 1, x_dim)
    lj, uj = np.maximum(j - k, 0), np.minimum(j + k + 1, y_dim)
    wsum = (s[ui[:, None], uj[None, :]] - s[li[:, None], uj[None, :]]
            - s[ui[:, None], lj[None, :]] + s[li[:, None], lj[None, :]])
    wsize = (ui - li)[:, None] * (uj - lj)[None, :]
    return ((occ > 0) | (wsum / wsize >= min_percent_occupied_fill)
            ).astype(occ.dtype)


def compute_tile_grid(x_range, y_range, inner_edge: float, outer_edge: float,
                      stride: float):
    """Inner/outer square extents of the tile grid
    (parity: data_preparation.py:359-386)."""
    xmin = np.round(x_range[0] - 1.5 * outer_edge, 2)
    xmax = np.round(x_range[1] + 1.5 * outer_edge, 2)
    ymin = np.round(y_range[0] - 1.5 * outer_edge, 2)
    ymax = np.round(y_range[1] + 1.5 * outer_edge, 2)

    ncols = int(np.round((xmax - xmin - 2 * outer_edge) / inner_edge))
    inner_edge_x = np.round((xmax - xmin - 2 * outer_edge) / ncols, 5)
    ncols = int((ncols - 1) / stride + 1)

    nrows = int(np.round((ymax - ymin - 2 * outer_edge) / inner_edge))
    inner_edge_y = np.round((ymax - ymin - 2 * outer_edge) / nrows, 5)
    nrows = int((nrows - 1) / stride + 1)

    inner = np.empty((nrows * ncols, 4))
    for i in range(nrows):
        for j in range(ncols):
            inner[i * ncols + j] = [
                xmin + outer_edge + stride * j * inner_edge_x,
                xmin + outer_edge + (stride * j + 1) * inner_edge_x,
                ymax - outer_edge - (stride * i + 1) * inner_edge_y,
                ymax - outer_edge - stride * i * inner_edge_y,
            ]
    inner = np.round(inner, 5)
    outer = inner + np.array([-outer_edge, outer_edge, -outer_edge, outer_edge])
    return inner, outer


class SampleGenerator:
    """Crop/tile factory over a voxelized plot npz + features npz."""

    def __init__(self, plot_path: str, features_path: str, save_dir: str,
                 n_neigh_sor=None, multiplier_sor=None, rad=None, npoints_rad=None):
        data = np.load(plot_path)
        data = np.hstack((data["points"], data["labels"][:, np.newaxis]))
        feats = np.load(features_path)
        self.feats = feats["features"]
        self.plot_name = os.path.basename(plot_path)[:-4]
        self.points = data[:, :3]
        self.label = data[:, 3]
        self.x_range = (self.points[:, 0].min(), self.points[:, 0].max())
        self.y_range = (self.points[:, 1].min(), self.points[:, 1].max())
        self.save_dir_data = os.path.join(save_dir, "npz")
        self.save_dir_meta = os.path.join(save_dir, "json")
        os.makedirs(self.save_dir_data, exist_ok=True)
        os.makedirs(self.save_dir_meta, exist_ok=True)
        # crop denoising (reference data_preparation.py:280-287, 589-615);
        # applied in save() when enabled — off by default
        self.n_neigh_sor = n_neigh_sor
        self.multiplier_sor = multiplier_sor
        self.rad = rad
        self.npoints_rad = npoints_rad

    # ------------------------------------------------------------------ tiles

    def tile_generate_and_save(self, inner_edge: float, outer_edge: float,
                               stride: float, compressed: bool = False,
                               logger=None):
        inner, outer = compute_tile_grid(self.x_range, self.y_range,
                                         inner_edge, outer_edge, stride)
        pts = np.hstack([self.points, self.label[:, None], self.feats])
        x, y = pts[:, 0], pts[:, 1]

        count = 0
        for tile_idx in range(len(inner)):
            xmin_o, xmax_o, ymin_o, ymax_o = outer[tile_idx]
            mask_outer = (x >= xmin_o) & (x <= xmax_o) & (y >= ymin_o) & (y <= ymax_o)
            if not mask_outer.any():
                continue
            chunk = pts[mask_outer]
            xi0, xi1, yi0, yi1 = inner[tile_idx]
            mask_inner = ((chunk[:, 0] >= xi0) & (chunk[:, 0] < xi1)
                          & (chunk[:, 1] > yi0) & (chunk[:, 1] <= yi1))
            if not mask_inner.any():
                continue

            cx = np.round((xi0 + xi1) / 2, 6)
            cy = np.round((yi0 + yi1) / 2, 6)
            chunk = chunk.copy()
            chunk[:, 0] -= cx
            chunk[:, 1] -= cy
            chunk = chunk.astype(np.float32)

            data = {
                "points": chunk[:, :3],
                "feat": chunk[:, 4:],
                "instance_label": chunk[:, 3].astype(np.int32),
                "center": np.array([cx, cy, 0.0]),
            }
            meta = {
                "plot_name": self.plot_name,
                "inner_edge": inner_edge,
                "outer_edge": outer_edge,
                "n_neigh_sor": self.n_neigh_sor,
                "multiplier_sor": self.multiplier_sor,
                "rad": self.rad,
                "npoints_rad": self.npoints_rad,
            }
            name = f"{self.plot_name}_{count}"
            saver = np.savez_compressed if compressed else np.savez
            saver(osp.join(self.save_dir_data, name + ".npz"), **data)
            with open(osp.join(self.save_dir_meta, name + ".json"), "w") as f:
                json.dump(meta, f)
            count += 1
        if logger:
            logger.info(f"saved {count} tiles")
        return count

    # ------------------------------------------------------------ random crops

    def get_occupancy_grid(self, occupancy_path: str, occupancy_res: float,
                           n_points: int, how_far_fill: int,
                           min_percent_occupied_fill: float,
                           ignore_for_occupancy: int = -1, rng=None):
        """xy occupancy raster of the plot (parity data_preparation.py:136-172),
        vectorized with histogram2d + a box-filter hole fill."""
        self.occupancy_res = occupancy_res
        self.how_far_fill = how_far_fill
        self.min_percent_occupied_fill = min_percent_occupied_fill
        if occupancy_path and os.path.exists(occupancy_path):
            self.occupancy_grid = np.load(occupancy_path)["occupancy_grid"]
            return

        rng = rng or np.random.default_rng(0)
        mask = self.label != ignore_for_occupancy
        points = self.points[mask]
        idx = rng.integers(0, len(points), size=min(n_points, len(points)))
        points = points[idx]

        def adjust(rng_, res):
            diff = abs(rng_[0] - rng_[1])
            times = int(np.floor(diff / res))
            return diff / times, times

        (x_res, x_dim) = adjust(self.x_range, occupancy_res)
        (y_res, y_dim) = adjust(self.y_range, occupancy_res)
        x_steps = np.arange(self.x_range[0], self.x_range[1] + 1e-3, x_res)
        y_steps = np.arange(self.y_range[0], self.y_range[1] + 1e-3, y_res)

        hist, _, _ = np.histogram2d(points[:, 0], points[:, 1],
                                    bins=[x_steps[: x_dim + 1], y_steps[: y_dim + 1]])
        occ = (hist > 0).astype(float)

        grid = np.empty((x_dim, y_dim, 3))
        grid[..., 0] = ((x_steps[:x_dim] + x_steps[1:x_dim + 1]) / 2)[:, None]
        grid[..., 1] = ((y_steps[:y_dim] + y_steps[1:y_dim + 1]) / 2)[None, :]
        grid[..., 2] = occ

        grid[..., 2] = fill_occupancy_holes(occ, how_far_fill,
                                            min_percent_occupied_fill)
        self.occupancy_grid = grid
        if occupancy_path:
            np.savez_compressed(occupancy_path, occupancy_grid=grid)

    def generate_candidates(self, n_samples_total: int, n_samples_plot: int,
                            chunk_size: float, rng=None):
        """Rotated-square crop candidates on a regular center grid
        (parity data_preparation.py:176-205)."""
        rng = rng or np.random.default_rng(0)
        self.chunk_size = chunk_size
        self.n_samples_plot = n_samples_plot
        n_candidates = max(n_samples_total, 5 * n_samples_plot)
        n_sqrt = int(np.sqrt(n_candidates))

        x_centers = np.round(np.repeat(np.linspace(*self.x_range, n_sqrt), n_sqrt), 2)
        y_centers = np.round(np.tile(np.linspace(*self.y_range, n_sqrt), n_sqrt), 2)
        self.centers = np.stack([x_centers, y_centers], axis=1)
        self.rotation_angles = np.round(rng.uniform(0, 2 * np.pi, n_sqrt * n_sqrt), 2)

    def check_occupancy(self, min_percent_occupied_choose: float):
        """Keep candidates whose rotated square overlaps enough occupied raster
        (parity data_preparation.py:209-230)."""
        self.min_percent_occupied_choose = min_percent_occupied_choose
        grid = self.occupancy_grid.reshape(-1, 3)
        gxy = grid[:, :2]
        occ = grid[:, 2]
        half = self.chunk_size / 2
        denom = (self.chunk_size / self.occupancy_res) ** 2

        keep = np.zeros(len(self.centers), bool)
        for i, (center, angle) in enumerate(zip(self.centers, self.rotation_angles)):
            rel = gxy - center
            c, s = np.cos(angle), np.sin(angle)
            rot = rel @ np.array([[c, s], [-s, c]]).T  # inverse rotation
            inside = np.max(np.abs(rot), axis=1) <= half
            keep[i] = occ[inside].sum() / denom > min_percent_occupied_choose
        self.filter = keep

    def save(self, compressed: bool = False, rng=None):
        """Cut, un-rotate, center and save the selected crops
        (parity data_preparation.py:234-329)."""
        rng = rng or np.random.default_rng(0)
        pts = np.hstack([self.points, self.label[:, None], self.feats])

        centers = self.centers[self.filter]
        angles = self.rotation_angles[self.filter]
        n_take = min(self.n_samples_plot, len(centers))
        if n_take == 0:
            return 0
        inds = rng.choice(len(centers), n_take, replace=False)
        centers, angles = centers[inds], angles[inds]

        half = self.chunk_size / 2
        count = 0
        for center, angle in zip(centers, angles):
            rel = pts[:, :2] - center
            box = np.max(np.abs(rel), axis=1) <= half * 1.5 + 3  # generous pre-cut
            view = pts[box]
            rel = view[:, :2] - center
            c, s = np.cos(angle), np.sin(angle)
            rot = rel @ np.array([[c, s], [-s, c]]).T
            inside = np.max(np.abs(rot), axis=1) <= half
            crop = np.hstack([rot[inside], view[inside, 2:]]).astype(np.float32)
            if len(crop) == 0:
                continue

            # denoise (reference data_preparation.py:280-287)
            if self.n_neigh_sor is not None and self.multiplier_sor is not None:
                from ..ops.filters import sor_filter

                crop = crop[sor_filter(crop, self.n_neigh_sor, self.multiplier_sor)]
            if self.rad is not None and self.npoints_rad is not None and len(crop):
                from ..ops.filters import rad_filter

                crop = crop[rad_filter(crop, self.rad, self.npoints_rad)]
            if len(crop) == 0:
                continue

            data = {
                "points": crop[:, :3],
                "feat": crop[:, 4:],
                "instance_label": crop[:, 3].astype(np.int32),
                "center": np.array([center[0], center[1], 0.0]),
            }
            name = f"{self.plot_name}_{count}"
            saver = np.savez_compressed if compressed else np.savez
            saver(osp.join(self.save_dir_data, name + ".npz"), **data)
            with open(osp.join(self.save_dir_meta, name + ".json"), "w") as f:
                json.dump({"plot_name": self.plot_name, "chunk_size": self.chunk_size,
                           "rotation_angle": float(angle)}, f)
            count += 1
        return count


def prepare_voxelized_features(cfg, forest_path: str, logger,
                               return_type: str = "voxelized",
                               features_fn=None, skip_features: bool = False,
                               device=None):
    """Voxelize the plot (cached) and compute verticality features (cached).

    Returns (voxelized_path, features_path).  The voxel->original trace is
    stored as a plain int64 inverse-index npz instead of the reference's
    python hash dict pickle (util/pipeline.py:48-57).

    ``skip_features=True`` (pipelines whose model ignores input features)
    skips the whole-plot verticality stage and returns features_path=None —
    the grouping stage then computes verticality lazily for its candidate
    points only (pipeline/instances.py).  ``device`` is where the default
    feature function (ops/features.py:compute_verticality) runs."""
    plot_name = os.path.basename(forest_path)[:-4]
    base_dir = os.path.dirname(os.path.dirname(forest_path))

    voxelized_dir = osp.join(base_dir, f"forest_voxelized{cfg.voxel_size}")
    features_dir = osp.join(base_dir, "features")
    for d in (voxelized_dir, features_dir):
        os.makedirs(d, exist_ok=True)

    logger.info("voxelizing forest...")
    save_path_vox = osp.join(voxelized_dir, f"{plot_name}.npz")
    save_path_trace = osp.join(voxelized_dir, f"{plot_name}_trace.npz")
    vox_arrays = None
    if (not osp.exists(save_path_vox)) or (
            return_type == "original" and not osp.exists(save_path_trace)):
        with span("voxelize_features.read"):
            data = load_data(forest_path)
        with span("voxelize_features.voxelize"):
            down, first_idx, inverse = voxel_downsample_trace_np(
                data[:, :3], cfg.voxel_size)
            labels = data[first_idx, 3]
            down = np.round(down.astype(np.float32), 2)
        with span("voxelize_features.write"):
            np.savez(save_path_vox, points=down, labels=labels)
            if return_type == "original":
                np.savez(save_path_trace, inverse=inverse.astype(np.int64))
        # hand the arrays back in memory: the streaming pipeline otherwise
        # reloads the npz it just wrote (~1 s per 437k voxels on this host)
        vox_arrays = (down, labels)

    if skip_features:
        return save_path_vox, None, vox_arrays
    logger.info("calculating features...")
    save_path_features = osp.join(features_dir, f"{plot_name}.npz")
    if not osp.exists(save_path_features):
        from ..ops.features import compute_verticality

        with span("voxelize_features.features"):
            data = load_data(save_path_vox)
            fn = features_fn or compute_verticality
            kwargs = {} if features_fn else {"device": device}
            features = fn(data[:, :3].astype(np.float32),
                          search_radius=cfg.search_radius_features, **kwargs)
            np.savez(save_path_features, features=features)
    return save_path_vox, save_path_features, vox_arrays


def generate_tiles(cfg, forest_path: str, logger, return_type: str = "voxelized",
                   features_fn=None, device=None,
                   stage_seconds: Optional[dict] = None):
    """Voxelize plot (cached), compute features (cached), cut tiles to npz
    (parity: reference util/pipeline.py:24-75).  ``stage_seconds`` (a
    dict) receives the seconds of the voxelize + features stage and of the
    tile cutting."""
    plot_name = os.path.basename(forest_path)[:-4]
    base_dir = os.path.dirname(os.path.dirname(forest_path))
    save_dir = osp.join(base_dir, "tiles")
    os.makedirs(save_dir, exist_ok=True)

    t0 = time.time()
    save_path_vox, save_path_features, _ = prepare_voxelized_features(
        cfg, forest_path, logger, return_type, features_fn, device=device)
    t1 = time.time()

    logger.info("getting tiles...")
    gen = SampleGenerator(
        plot_path=save_path_vox,
        features_path=save_path_features,
        save_dir=save_dir,
        **{k: cfg.sample_generator.get(k) for k in
           ("n_neigh_sor", "multiplier_sor", "rad", "npoints_rad")},
    )
    gen.tile_generate_and_save(cfg.inner_edge, cfg.outer_edge, cfg.stride,
                               logger=logger)
    if stage_seconds is not None:
        stage_seconds.update(voxelize_features=t1 - t0,
                             tiles=time.time() - t1)
    return save_dir
