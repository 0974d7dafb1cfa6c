"""Plot outline (concave hull) and edge-buffer tests as raster morphology.

Replaces the reference's alphashape/GEOS/geopandas stack (reference
util/pipeline.py:211-275): the xy outline of the plot is represented as an
occupancy raster (grid 0.25 m like the reference's hull gridding,
pipeline.py:226-238) closed morphologically with a radius matched to the alpha
parameter (alpha=0.6 -> ~1.7 m closing disk: alphashape's circumradius bound
1/alpha).  "Within hull" and "within buffer of the hull boundary" become raster
lookups — vectorized and dependency-free, at raster resolution instead of exact
polygon geometry.
"""

from __future__ import annotations

import numpy as np


try:  # scipy ships in this image (sklearn dependency); pure-numpy fallback below
    from scipy import ndimage as _ndi
except ImportError:  # pragma: no cover
    _ndi = None


def _binary_dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    if _ndi is not None:
        return _ndi.binary_dilation(
            mask, structure=np.ones((3, 3), bool), iterations=iterations)
    out = mask.copy()
    for _ in range(iterations):
        o = out.copy()
        o[1:, :] |= out[:-1, :]
        o[:-1, :] |= out[1:, :]
        o[:, 1:] |= out[:, :-1]
        o[:, :-1] |= out[:, 1:]
        o[1:, 1:] |= out[:-1, :-1]
        o[:-1, :-1] |= out[1:, 1:]
        o[1:, :-1] |= out[:-1, 1:]
        o[:-1, 1:] |= out[1:, :-1]
        out = o
    return out


def _binary_erode(mask: np.ndarray, iterations: int) -> np.ndarray:
    if _ndi is not None:
        # border_value=0: cells beyond the raster count as empty, so a full
        # raster erodes inward from its edges
        return _ndi.binary_erosion(
            mask, structure=np.ones((3, 3), bool), iterations=iterations,
            border_value=0)
    padded = np.pad(mask, iterations, constant_values=False)
    return ~_binary_dilate(~padded, iterations)[iterations:-iterations,
                                                iterations:-iterations]


def _fill_holes(mask: np.ndarray) -> np.ndarray:
    """Cells not reachable from the raster border are holes; fill them."""
    if _ndi is not None:
        return _ndi.binary_fill_holes(mask)
    outside = np.pad(~mask, 1, constant_values=True)
    seed = np.zeros_like(outside)
    seed[0, :] = seed[-1, :] = True
    seed[:, 0] = seed[:, -1] = True
    while True:
        grown = _binary_dilate(seed, 1) & outside
        new = seed | grown
        if (new == seed).all():
            break
        seed = new
    return ~seed[1:-1, 1:-1]


class HullRaster:
    """Occupancy-raster hull of a set of xy coordinates."""

    def __init__(self, coords_xy: np.ndarray, grid_size: float = 0.25,
                 alpha: float = 0.6):
        coords_xy = np.asarray(coords_xy, np.float64)
        self.grid = grid_size

        # morphological closing approximates the alpha-shape: alpha bounds the
        # circumradius of kept triangles at 1/alpha.
        extent_cells = int(np.ptp(coords_xy, axis=0).max() / grid_size) + 3
        if alpha > 0:
            close_cells = max(int(np.ceil((1.0 / alpha) / grid_size)), 1)
        else:
            # convex-ish: fill everything between extremes via big closing
            close_cells = extent_cells
        margin = close_cells + 2  # room for the dilation before erosion

        self.mins = coords_xy.min(axis=0) - margin * grid_size
        ij = np.floor((coords_xy - self.mins) / grid_size).astype(np.int64)
        self.dims = ij.max(axis=0) + margin + 1
        occ = np.zeros(tuple(self.dims), bool)
        occ[ij[:, 0], ij[:, 1]] = True

        closed = _binary_erode(_binary_dilate(occ, close_cells), close_cells)
        self.inside = _fill_holes(closed | occ)
        boundary = self.inside & ~_binary_erode(self.inside, 1)
        self.boundary = boundary

    def _cells(self, coords_xy: np.ndarray) -> np.ndarray:
        ij = np.floor((np.asarray(coords_xy, np.float64) - self.mins)
                      / self.grid).astype(np.int64)
        ij = np.clip(ij, 0, np.asarray(self.dims) - 1)
        return ij

    def contains(self, coords_xy: np.ndarray) -> np.ndarray:
        ij = self._cells(coords_xy)
        return self.inside[ij[:, 0], ij[:, 1]]

    def within_boundary_buffer(self, coords_xy: np.ndarray,
                               buffer_size: float) -> np.ndarray:
        """True where a point lies within buffer_size of the hull boundary
        (parity: hull_line.buffer(buffersize) + sjoin-within,
        reference pipeline.py:242-254, 211-222)."""
        it = max(int(np.ceil(buffer_size / self.grid)), 1)
        buffered = _binary_dilate(self.boundary, it)
        ij = self._cells(coords_xy)
        return buffered[ij[:, 0], ij[:, 1]]


def get_hull(coords_xy: np.ndarray, alpha: float) -> HullRaster:
    return HullRaster(coords_xy, alpha=alpha)


def get_coords_within_hull(coords: np.ndarray, hull: HullRaster) -> np.ndarray:
    return hull.contains(np.asarray(coords)[:, :2])


def get_coords_within_hull_buffer(coords: np.ndarray, hull: HullRaster,
                                  buffer_size: float) -> np.ndarray:
    return hull.within_boundary_buffer(np.asarray(coords)[:, :2], buffer_size)
