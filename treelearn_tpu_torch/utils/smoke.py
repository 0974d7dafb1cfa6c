"""Kernel smoke checks on the card (counterpart of
treelearn_tpu/utils/smoke.py:run_tpu_smoke).

``run_gpu_smoke`` runs each kernel wrapper (rulebook, subm conv,
verticality, eps-graph found bits, k-NN pass) at the small sizes of the JAX
package's smoke against its plain PyTorch version (and, where the JAX smoke
has one, an exact numpy oracle), then the HDBSCAN eps-ladder at plot scale:
220,000 points of dense knots on clutter with the device limit lifted, which
launches kernel 5 once per ladder level.  Unlike the JAX smoke, a failed
check keeps its message: ``errors`` maps each failed check to the exception
or the reason, so a caller can show why.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device

KNOT_POINTS = 2000  # points a knot in knot_layout


def _sorted_keys_case(ss=(64, 64, 48), n=1500, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(int(np.prod(ss)), n, replace=False)
                     .astype(np.int64)).astype(np.int32)
    return keys, ss


def knot_layout(n_knots: int = 96) -> np.ndarray:
    """Offset-shifted tree bases at plot scale (the JAX smoke's
    hdbscan_device_220k layout, treelearn_tpu/utils/smoke.py:178-184):
    ``n_knots`` knots of 2000 points (sigma 0.25 m) on uniform clutter,
    28,000 clutter points and a 240 m square at 96 knots, both scaled with
    the knot count so the densities stay.  Returns the (N, 2) float32
    points, knots first."""
    scale = n_knots / 96
    extent = 240.0 * np.sqrt(scale)
    rng = np.random.default_rng(3)
    centers = rng.uniform(0, extent, (n_knots, 2)).astype(np.float32)
    knots = (centers[:, None, :]
             + rng.normal(0, 0.25, (n_knots, KNOT_POINTS, 2))).reshape(-1, 2)
    clutter = rng.uniform(0, extent, (int(round(28000 * scale)), 2))
    return np.concatenate([knots, clutter]).astype(np.float32)


def knot_recovery(labels: np.ndarray, n_knots: int):
    """(knots recovered, clusters, ok) for :func:`knot_layout`'s labels: a
    knot is recovered when one cluster holds at least 75 % of its points;
    ok when 95 % of the knots are and the cluster count lies in [0.9, 1.3] x
    knots (adjacent random knots may merge, as in sklearn) — the JAX smoke's
    check (:196-210)."""
    knot_ids = np.repeat(np.arange(n_knots), KNOT_POINTS)
    knot_lab = labels[: n_knots * KNOT_POINTS]
    good = 0
    for kn in range(n_knots):
        vals, cnts = np.unique(knot_lab[knot_ids == kn], return_counts=True)
        if vals[cnts.argmax()] >= 1 and cnts.max() >= 0.75 * KNOT_POINTS:
            good += 1
    n_clusters = len(np.unique(labels[labels >= 1]))
    ok = (good >= int(0.95 * n_knots)
          and int(0.9 * n_knots) <= n_clusters <= int(1.3 * n_knots))
    return good, n_clusters, bool(ok)


def _exact_partition(xy: np.ndarray, eps: float) -> np.ndarray:
    """Eps-graph components by an O(n^2) flood fill (numpy oracle)."""
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    adj = d2 <= eps * eps
    lab = np.full(len(xy), -1)
    cur = 0
    for i in range(len(xy)):
        if lab[i] >= 0:
            continue
        stack = [i]
        lab[i] = cur
        while stack:
            j = stack.pop()
            nbrs = np.flatnonzero(adj[j] & (lab < 0))
            lab[nbrs] = cur
            stack.extend(nbrs.tolist())
        cur += 1
    return lab


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _check_rulebook(dev, grid):
    from ..ops.rulebook import subm_rulebook
    from ..ops.sparse import build_subm_rulebook

    got = subm_rulebook(grid)
    want = build_subm_rulebook(grid, 3)
    if not torch.equal(got, want):
        return f"{int((got != want).sum())} rule entries differ"
    return None


def _check_conv(dev, grid, rng):
    from ..ops.sparse import build_subm_rulebook
    from ..ops.sparse import subm_conv as plain_conv
    from ..ops.subm_conv import subm_conv

    v = grid.keys.shape[0]
    rule = build_subm_rulebook(grid, 3)
    feats = torch.from_numpy(
        rng.normal(size=(v, 32)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(27, 32, 32)) * 0.1)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    got = subm_conv(feats, w, rule).float()
    want = plain_conv(feats, w, rule).float()
    scale = float(want.abs().max().clamp(min=1e-6))
    err = float((got - want).abs().max()) / scale
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        return f"bf16 conv err {err:.3e} of max |out|"
    return None


def _check_cc(dev, rng):
    from ..ops.cc import cc_labels, found_bits, found_bits_plain, prepare

    centers = rng.uniform(0, 12, (6, 2))
    blobs = [c + rng.normal(0, 0.03, (120, 2)) for c in centers]
    xy = np.vstack(blobs + [rng.uniform(0, 12, (80, 2))]).astype(np.float32)
    pts = torch.from_numpy(xy).to(dev)
    p = prepare(pts, 0.15)
    if not torch.equal(found_bits(p), found_bits_plain(p)):
        return "found bits differ from the plain version"
    if not _same_partition(cc_labels(pts, 0.15), _exact_partition(xy, 0.15)):
        return "components differ from the exact eps-graph partition"
    return None


def _check_knn(dev, rng):
    from ..ops.knn import (_first_cell, banded_knn_classify, knn_pass,
                           knn_pass_plain, prepare_pass)

    ref_pts = rng.uniform(0, 8, (3000, 3)).astype(np.float32)
    ref_lab = rng.integers(1, 9, 3000).astype(np.int64)
    q = rng.uniform(0, 8, (500, 3)).astype(np.float32)
    p = prepare_pass(torch.from_numpy(ref_pts).to(dev),
                     torch.from_numpy(ref_lab).to(dev),
                     torch.from_numpy(q).to(dev), _first_cell(ref_pts), 5)
    w, f = knn_pass(p)
    wp, fp = knn_pass_plain(p)
    if not (torch.equal(w, wp) and torch.equal(f, fp)):
        return "pass winners or found counts differ from the plain version"
    ours = banded_knn_classify(ref_pts, ref_lab, q, k=5, device=dev)
    d2 = ((q[:, None, :] - ref_pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :5]
    exact = np.array([np.bincount(ref_lab[r]).argmax() for r in idx])
    agree = float((np.asarray(ours) == exact).mean())
    # distance ties can legitimately flip votes; demand near-total accord
    if agree < 0.99:
        return f"vote agrees with the exact vote on {agree:.4f} of queries"
    return None


def _check_vert(dev, rng):
    from ..ops.vert import (moments, moments_plain, prepare,
                            vert_from_moments)

    pts = rng.uniform(0, 6, (4000, 3)).astype(np.float32)
    qpts = pts[rng.choice(4000, 400, replace=False)]
    p = prepare(torch.from_numpy(pts).to(dev), torch.from_numpy(qpts).to(dev),
                0.6)
    m, mp = moments(p), moments_plain(p)
    if not torch.equal(m[:, 0], mp[:, 0]):
        return "neighbor counts differ from the plain version"
    mom_err = float(((m - mp).abs() / mp.abs().amax(0).clamp(min=1e-12)).max())
    if mom_err > 1e-4:
        return f"moments differ from the plain version by {mom_err:.2e}"
    vert_s, cnt_s = vert_from_moments(m)
    vert = np.empty(len(qpts), np.float32)
    cnt = np.empty(len(qpts), np.float32)
    order = p.q_order.cpu().numpy()
    vert[order] = vert_s.float().cpu().numpy()
    cnt[order] = cnt_s.float().cpu().numpy()
    # closed-form numpy oracle (treelearn_tpu/utils/smoke.py:134-150)
    d2 = ((qpts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    exact = np.full(len(qpts), np.nan, np.float32)
    for i in range(len(qpts)):
        nb = pts[d2[i] <= 0.36]
        if len(nb) < 3:
            continue
        _, ev = np.linalg.eigh(np.cov(nb.T, bias=True))
        exact[i] = 1.0 - abs(ev[2, 0])
    ok = ~np.isnan(exact)
    cnt_exact = (d2[ok] <= 0.36).sum(axis=1)
    err = float(np.max(np.abs(vert[ok] - exact[ok]))) if ok.any() else 0.0
    if not ok.any() or not np.allclose(cnt[ok], cnt_exact) or err >= 5e-2:
        return f"verticality vs the numpy oracle: max err {err:.3e}"
    return None


def _check_hdbscan(dev, n_knots, extras):
    from .. import ops
    from ..ops.hdbscan import hdbscan_cluster

    pts = knot_layout(n_knots)
    kept = os.environ.get("TL_HDBSCAN_DEVICE_MAX")
    os.environ["TL_HDBSCAN_DEVICE_MAX"] = str(1 << 20)
    launches0 = ops._cuda.LAUNCHES["cc"]
    try:
        t0 = time.time()
        log = {}
        lab = hdbscan_cluster(pts, min_cluster_size=50,
                              not_assigned_label=-1, start_num=1,
                              device=dev, log=log)
        seconds = time.time() - t0
    finally:
        if kept is None:
            os.environ.pop("TL_HDBSCAN_DEVICE_MAX", None)
        else:
            os.environ["TL_HDBSCAN_DEVICE_MAX"] = kept
    good, n_clusters, ok = knot_recovery(lab, n_knots)
    extras.update(hdbscan_points=len(pts), hdbscan_seconds=seconds,
                  hdbscan_knots_recovered=good, hdbscan_clusters=n_clusters,
                  hdbscan_cc_launches=ops._cuda.LAUNCHES["cc"] - launches0,
                  hdbscan_levels_active=sum(a > 0 for a in log["active"]))
    if log["route"] != "ladder":
        return f"route {log['route']}, not the eps-ladder"
    if not ok:
        return (f"{good} of {n_knots} knots recovered, {n_clusters} "
                f"clusters")
    return None


def run_gpu_smoke(device=None, n_knots: int = 96) -> dict:
    """Every kernel wrapper against its plain version at small sizes, then
    the eps-ladder HDBSCAN on :func:`knot_layout` (``n_knots`` knots: 96
    give 220,000 points).  Runs on ``device`` (the card unless the caller
    asks for the CPU, where the wrappers take their plain versions; without
    a card this raises).  Returns ``{"passed", "failed", "checks": {name:
    bool}, "errors": {name: message}, ...}`` with the HDBSCAN check's
    numbers."""
    from ..ops.sparse import grid_from_sorted_keys

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    keys, ss = _sorted_keys_case()
    grid = grid_from_sorted_keys(torch.from_numpy(keys).to(dev), ss)
    extras: dict = {}
    checks, errors = {}, {}
    for name, fn in (
            ("rulebook", lambda: _check_rulebook(dev, grid)),
            ("subm_conv", lambda: _check_conv(dev, grid, rng)),
            ("cc", lambda: _check_cc(dev, rng)),
            ("knn", lambda: _check_knn(dev, rng)),
            ("vert", lambda: _check_vert(dev, rng)),
            ("hdbscan_ladder", lambda: _check_hdbscan(dev, n_knots, extras))):
        try:
            why = fn()
        except Exception as e:  # noqa: BLE001 - reported, never hidden
            why = f"{type(e).__name__}: {e}"
        checks[name] = why is None
        if why is not None:
            errors[name] = why
    passed = sum(checks.values())
    return {"passed": passed, "failed": len(checks) - passed,
            "checks": checks, "errors": errors, **extras}
