"""Procedural synthetic forests for tests and benchmarks.

The reference has no test data generator (its QA is the L1W benchmark, which
needs a 9 GB download).  We generate labeled cone-crown trees on undulating
terrain so every stage — training, tiling, inference, clustering, evaluation —
can be exercised hermetically, and the benchmark harness can scale point counts
arbitrarily.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_synthetic_forest(
    n_trees: int = 25,
    extent: float = 40.0,
    points_per_tree: int = 3000,
    ground_points: int = 20000,
    trunk_height_range=(4.0, 12.0),
    crown_radius_range=(0.8, 2.2),
    seed: int = 0,
    min_spacing: float = 2.5,
):
    """Returns (data (N, 4) [x, y, z, instance], tree_positions (n_trees, 2)).

    Labels follow the raw-data convention (reference data_preparation.py:11-12):
    0 = non-tree (ground), 1..n = tree instances.
    """
    rng = np.random.default_rng(seed)

    # poisson-ish tree placement with minimum spacing
    positions = []
    tries = 0
    while len(positions) < n_trees and tries < 10000:
        cand = rng.uniform(min_spacing, extent - min_spacing, 2)
        if all(np.linalg.norm(cand - p) >= min_spacing for p in positions):
            positions.append(cand)
        tries += 1
    positions = np.array(positions)
    n_trees = len(positions)

    def ground_z(xy):
        return 0.3 * np.sin(xy[:, 0] * 0.15) + 0.2 * np.cos(xy[:, 1] * 0.2)

    clouds, labels = [], []

    # ground
    gxy = rng.uniform(0, extent, (ground_points, 2))
    gz = ground_z(gxy) + rng.normal(0, 0.03, ground_points)
    clouds.append(np.column_stack([gxy, gz]))
    labels.append(np.zeros(ground_points, np.int64))

    for t in range(n_trees):
        height = rng.uniform(*trunk_height_range)
        crown_r = rng.uniform(*crown_radius_range)
        base = np.array([*positions[t], ground_z(positions[t][None])[0]])

        n_trunk = points_per_tree // 3
        n_crown = points_per_tree - n_trunk

        z_trunk = rng.uniform(0, height * 0.6, n_trunk)
        r_trunk = rng.uniform(0, 0.12, n_trunk)
        theta = rng.uniform(0, 2 * np.pi, n_trunk)
        trunk = base + np.column_stack(
            [r_trunk * np.cos(theta), r_trunk * np.sin(theta), z_trunk])

        z_crown = rng.uniform(height * 0.3, height, n_crown)
        taper = 1.0 - (z_crown - height * 0.3) / (height * 0.7)
        r_crown = rng.uniform(0, 1, n_crown) ** 0.5 * crown_r * np.maximum(taper, 0.1)
        theta = rng.uniform(0, 2 * np.pi, n_crown)
        crown = base + np.column_stack(
            [r_crown * np.cos(theta), r_crown * np.sin(theta), z_crown])

        clouds.append(np.vstack([trunk, crown]))
        labels.append(np.full(points_per_tree, t + 1, np.int64))

    data = np.column_stack([np.vstack(clouds), np.concatenate(labels)])
    return data.astype(np.float64), positions


def make_synthetic_forest_hard(
    n_trees: int = 48,
    extent: float = 60.0,
    points_per_tree: int = 16000,
    ground_points: int = 200000,
    n_shrubs: Optional[int] = None,
    n_scanners: int = 6,
    seed: int = 0,
):
    """Hard-mode procedural forest (VERDICT r2 item 4): the geometry the easy
    cone-tree generator sidesteps and the reference's L1W reality is made of —

    * **interlocking crowns**: Thomas-cluster tree placement (offspring
      scattered around parent clumps, spacing down to 1.1 m) with wide
      ellipsoidal crowns, so neighboring crowns interpenetrate;
    * **understory clutter**: shrub ellipsoids (labeled non-tree) placed
      1-3 m from random trees, right where offset-shifted trunk points land;
    * **occlusion shadows**: points in the angular shadow wedge behind a
      trunk (w.r.t. the nearest simulated scanner) are mostly dropped, the
      MLS artifact that thins far sides of stems;
    * **density gradients**: keep probability decays with range to the
      nearest scanner on a serpentine path, like a real mobile scan.

    Same return/label convention as :func:`make_synthetic_forest`
    (0 = non-tree, 1.. = instances; reference data_preparation.py:11-12).
    """
    rng = np.random.default_rng(seed)
    if n_shrubs is None:
        n_shrubs = n_trees

    def ground_z(xy):
        return (0.5 * np.sin(xy[:, 0] * 0.11) + 0.35 * np.cos(xy[:, 1] * 0.17)
                + 0.2 * np.sin(xy[:, 0] * 0.31 + xy[:, 1] * 0.23))

    # Thomas-cluster placement: clumped, minimally spaced at 1.1 m so crowns
    # (radius up to ~3 m) must interlock
    n_parents = max(n_trees // 4, 1)
    parents = rng.uniform(4.0, extent - 4.0, (n_parents, 2))
    positions = []
    tries = 0
    while len(positions) < n_trees and tries < 20000:
        p = parents[rng.integers(n_parents)]
        cand = np.clip(p + rng.normal(0, 2.4, 2), 1.5, extent - 1.5)
        if all(np.linalg.norm(cand - q) >= 1.1 for q in positions):
            positions.append(cand)
        tries += 1
    positions = np.array(positions)
    n_trees = len(positions)

    clouds, labels = [], []

    gxy = rng.uniform(0, extent, (ground_points, 2))
    gz = ground_z(gxy) + rng.normal(0, 0.04, ground_points)
    clouds.append(np.column_stack([gxy, gz]))
    labels.append(np.zeros(ground_points, np.int64))

    trunk_xy = positions.copy()
    heights = rng.uniform(6.0, 16.0, n_trees)
    for t in range(n_trees):
        height = heights[t]
        base = np.array([*positions[t], ground_z(positions[t][None])[0]])
        lean = rng.normal(0, 0.02, 2)  # m of xy drift per m of height

        n_trunk = points_per_tree // 4
        n_crown = points_per_tree - n_trunk

        z_trunk = rng.uniform(0, height * 0.55, n_trunk)
        r_trunk = rng.uniform(0, rng.uniform(0.08, 0.2), n_trunk)
        theta = rng.uniform(0, 2 * np.pi, n_trunk)
        trunk = base + np.column_stack(
            [r_trunk * np.cos(theta) + lean[0] * z_trunk,
             r_trunk * np.sin(theta) + lean[1] * z_trunk,
             z_trunk])

        # branch-structured crown inside an interlocking ellipsoid envelope.
        # Real MLS canopies (the L1W benchmark) put points ON branches and
        # foliage clumps contiguous with their trunk — the connectivity cue
        # the offset head actually learns from.  A volume-uniform ellipsoid
        # (the round-3 generator) makes crown membership multi-modal in the
        # overlap zones with NO geometric cue, which collapses any
        # L2-trained offset to the mean of the candidate trunks.  The
        # envelope (and hence the interlocking) is unchanged; only the
        # interior structure is branchy now, plus a diffuse fog fraction
        # that keeps residual ambiguity.
        cz = height * rng.uniform(0.55, 0.75)
        rx = rng.uniform(1.6, 3.2)
        ry = rx * rng.uniform(0.75, 1.3)
        rz = height * rng.uniform(0.25, 0.42)
        n_fog = int(n_crown * 0.15)
        n_br_pts = n_crown - n_fog

        n_branch = int(rng.integers(24, 48))
        v_att = rng.uniform(-0.85, 0.9, n_branch)          # height in envelope
        s_env = np.sqrt(np.maximum(1.0 - v_att ** 2, 0.0))  # radius profile
        psi = rng.uniform(0, 2 * np.pi, n_branch)
        reach = rng.uniform(0.6, 1.0, n_branch)             # fraction of envelope
        z_att = cz + v_att * rz
        att = np.column_stack([lean[0] * z_att, lean[1] * z_att, z_att])
        tip = att + np.column_stack([
            reach * s_env * rx * np.cos(psi),
            reach * s_env * ry * np.sin(psi),
            rng.uniform(-0.08, 0.35, n_branch)
            * np.linalg.norm(np.column_stack(
                [reach * s_env * rx, reach * s_env * ry]), axis=1)])
        blen = np.linalg.norm(tip - att, axis=1) + 1e-6
        # points per branch proportional to its length; along-branch
        # position biased to the tip (foliage), jitter growing tipward
        alloc = rng.multinomial(n_br_pts, blen / blen.sum())
        br_idx = np.repeat(np.arange(n_branch), alloc)
        tpos = rng.uniform(0, 1, n_br_pts) ** 0.7
        sigma = 0.08 + 0.38 * tpos
        bpts = (att[br_idx] + tpos[:, None] * (tip - att)[br_idx]
                + rng.normal(0, 1, (n_br_pts, 3)) * sigma[:, None])

        u = rng.uniform(0, 1, n_fog) ** (1.0 / 3.0)        # residual fog
        phi = rng.uniform(0, 2 * np.pi, n_fog)
        cost = rng.uniform(-1, 1, n_fog)
        sint = np.sqrt(1 - cost ** 2)
        fog = np.column_stack([
            u * rx * sint * np.cos(phi) + lean[0] * cz,
            u * ry * sint * np.sin(phi) + lean[1] * cz,
            u * rz * cost + cz])
        crown = base + np.vstack([bpts, fog])

        clouds.append(np.vstack([trunk, crown]))
        labels.append(np.full(points_per_tree, t + 1, np.int64))

    # understory shrubs: non-tree clutter parked next to trunks
    for _ in range(n_shrubs):
        t = rng.integers(n_trees)
        ang = rng.uniform(0, 2 * np.pi)
        off = rng.uniform(1.0, 3.0)
        cxy = np.clip(positions[t] + off * np.array([np.cos(ang), np.sin(ang)]),
                      0.5, extent - 0.5)
        h = rng.uniform(0.3, 1.4)
        r = rng.uniform(0.3, 0.9)
        n_pts = int(rng.integers(300, 900))
        u = rng.uniform(0, 1, n_pts) ** (1.0 / 3.0)
        phi = rng.uniform(0, 2 * np.pi, n_pts)
        cost = rng.uniform(-1, 1, n_pts)
        sint = np.sqrt(1 - cost ** 2)
        bz = ground_z(cxy[None])[0]
        shrub = np.column_stack([
            cxy[0] + u * r * sint * np.cos(phi),
            cxy[1] + u * r * sint * np.sin(phi),
            bz + h / 2 + u * (h / 2) * cost])
        clouds.append(shrub)
        labels.append(np.zeros(n_pts, np.int64))

    data = np.column_stack([np.vstack(clouds), np.concatenate(labels)])

    # ---- scan simulation: density gradient + trunk occlusion shadows ----
    ty = np.linspace(5.0, extent - 5.0, n_scanners)
    tx = np.where(np.arange(n_scanners) % 2 == 0, extent * 0.25, extent * 0.75)
    scanners = np.column_stack([tx, ty])

    xy = data[:, :2]
    d2 = ((xy[:, None, :] - scanners[None, :, :]) ** 2).sum(-1)
    s_idx = np.argmin(d2, axis=1)
    s_range = np.sqrt(d2[np.arange(len(data)), s_idx])

    # range falloff: full density inside 8 m, (8/r)^1.6 beyond, floor 0.12
    keep_p = np.clip((8.0 / np.maximum(s_range, 8.0)) ** 1.6, 0.12, 1.0)

    # shadow wedges: behind each trunk (w.r.t. the point's scanner), within
    # the angular half-width of a 0.35 m blocker, drop with p=0.75
    shadow = np.zeros(len(data), bool)
    for s in range(n_scanners):
        sel = s_idx == s
        if not sel.any():
            continue
        rel = xy[sel] - scanners[s]
        ang = np.arctan2(rel[:, 1], rel[:, 0])
        rng_pt = s_range[sel]
        t_rel = trunk_xy - scanners[s]
        t_ang = np.arctan2(t_rel[:, 1], t_rel[:, 0])
        t_rng = np.linalg.norm(t_rel, axis=1)
        for t in range(n_trees):
            w = np.arctan(0.35 / max(t_rng[t], 1.0))
            dang = np.abs((ang - t_ang[t] + np.pi) % (2 * np.pi) - np.pi)
            shadow[np.flatnonzero(sel)[(dang < w) & (rng_pt > t_rng[t] + 0.3)]] = True
    keep_p = np.where(shadow, keep_p * 0.25, keep_p)

    keep = rng.uniform(0, 1, len(data)) < keep_p
    # never drop a whole tree: keep at least 200 points of each instance
    for t in range(1, n_trees + 1):
        rows = np.flatnonzero(data[:, 3] == t)
        if keep[rows].sum() < 200:
            keep[rng.choice(rows, size=min(200, len(rows)), replace=False)] = True
    data = data[keep]
    data = data[rng.permutation(len(data))]
    return data.astype(np.float64), positions


def verticality_proxy(data: np.ndarray) -> np.ndarray:
    """Cheap stand-in verticality feature for synthetic fixtures: trunk-like
    points get high verticality, ground low (used where the real geometric
    feature kernel would run)."""
    labels = data[:, 3]
    vert = np.where(labels > 0, 0.85, 0.1)
    return vert.astype(np.float32)[:, None]


def make_crop_npz(path: str, data: np.ndarray, feats: np.ndarray,
                  center=(0.0, 0.0, 0.0)):
    """Write a crop/tile npz in the sample-generator artifact format."""
    np.savez(
        path,
        points=data[:, :3].astype(np.float32),
        feat=feats.astype(np.float32),
        instance_label=data[:, 3].astype(np.int32),
        center=np.asarray(center, np.float64),
    )
