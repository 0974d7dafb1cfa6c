"""HDBSCAN for the grouping stage's hdbscan mode (port of
treelearn_tpu/ops/hdbscan.py).

Replaces the host sklearn HDBSCAN the reference uses for instance grouping
(reference tree_learn/util/pipeline.py:184-191: ``HDBSCAN(min_cluster_size=
npoint_thr)`` over the xy of offset-shifted coords, followed by the tau_min
size filter).  Single hyperparameter contract preserved: ``min_cluster_size``.

Every horizontal cut of the mutual-reachability dendrogram at distance
``eps`` equals the connected components of the graph whose vertices are the
points with ``core_distance <= eps`` and whose edges join active pairs within
``eps``.  So the hierarchy is rebuilt from a geometric ladder of eps levels,
each one run of the eps-graph component pass (:func:`ops.cc.cc_labels`:
kernel 5 on a CUDA tensor, its plain version on a CPU tensor), and the
condensed tree and the excess-of-mass extraction run on the host.

The host half (ladder, coarsening, nesting union, condensed tree, the
weighted large-N route) is the JAX package's numpy code, names and
arithmetic unchanged.  Two stated differences:

- core distances (:func:`kth_neighbor_d2`) are exact, from the host
  ``scipy.spatial.cKDTree``; the JAX grid pass can overestimate in clumped
  cells (treelearn_tpu/ops/hdbscan.py:49-52);
- ``cell_cap`` is gone: it capped the JAX package's XLA CC engine, which the
  port does not have.  Each level runs the exact pass, which is what the JAX
  package's TPU branch (``pallas_cc.cc_labels_banded``) runs.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from .cc import cc_labels


def kth_neighbor_d2(points: np.ndarray, k: int) -> np.ndarray:
    """Squared distance to the k-th nearest neighbor (self-inclusive) of each
    point: exact, from the host KD-tree (float64 distances rounded to
    float32).  Where the JAX grid pass samples a clumped cell and
    overestimates, this returns the true value."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float32)
    n, d = points.shape
    if n <= k:
        # fewer points than k: everything is each other's neighborhood
        c = points - points.mean(0)
        return np.full(n, float((c * c).sum(-1).max()) * 4 + 1e-6, np.float32)
    dist, _ = cKDTree(points).query(points, k=[k], workers=-1)
    return np.square(dist[:, 0]).astype(np.float32)


def _ladder(core_d: np.ndarray, n_levels: int) -> np.ndarray:
    """Geometric eps ladder (ascending) spanning the core-distance range and
    reaching far enough that distinct structures merge into common roots."""
    pos = core_d[np.isfinite(core_d) & (core_d > 0)]
    if len(pos) == 0:
        return np.geomspace(1e-3, 1.0, n_levels)
    lo = max(float(np.percentile(pos, 2.0)), 1e-4)
    hi = max(float(np.percentile(pos, 99.0)) * 64.0, lo * 64.0)
    return np.geomspace(lo, hi, n_levels).astype(np.float64)


def _coarse_reps(xy: np.ndarray, eps: float, factor: float = 8.0):
    """Quantize active points onto an eps/``factor`` grid; returns
    (reps (M, 2) f32 centroids, inverse (N,) int64 point->rep map).

    Same-cell points are within cell-diagonal eps*sqrt(2)/factor < eps of
    each other, so collapsing a cell to its centroid cannot split a
    component; centroid-vs-point distances err by at most one cell diagonal
    (~0.18*eps at factor 8), below the eps-ladder's own geomspace step.
    This keeps the component pass non-degenerate at coarse eps: the
    representative count shrinks as eps grows."""
    g = max(float(eps) / factor, 1e-4)
    lo = xy.min(axis=0)
    ix = np.floor((xy - lo) / g).astype(np.int64)
    key = ix[:, 0] * (int(ix[:, 1].max()) + 2) + ix[:, 1]
    uniq, inverse, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
    reps = np.zeros((len(uniq), 2), np.float64)
    np.add.at(reps, inverse, xy)
    reps /= counts[:, None]
    return reps.astype(np.float32), inverse


def _union_nested(prev_row: np.ndarray, cur_row: np.ndarray) -> np.ndarray:
    """Enforce hierarchy nesting: union current-level components that share
    a previous (finer) level component.  Per-level coarsening breaks the
    exact pass's nesting: a centroid pair can fall just outside eps where
    the finer level already merged the underlying points."""
    m = cur_row >= 0
    if not m.any():
        return cur_row
    labels_u, inv = np.unique(cur_row[m], return_inverse=True)
    act = (prev_row >= 0) & m
    if not act.any():
        return cur_row
    pair = np.unique(np.stack([prev_row[act], cur_row[act]], 1), axis=0)
    cv = np.searchsorted(labels_u, pair[:, 1])
    parent = np.arange(len(labels_u))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    pv = pair[:, 0]
    start = np.ones(len(pv), bool)
    start[1:] = pv[1:] != pv[:-1]  # pairs sorted by prev label (np.unique)
    head = 0
    for s, c in zip(start.tolist(), cv.tolist()):
        if s:
            head = c
            continue
        ra, rb = find(head), find(c)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    root = np.array([find(i) for i in range(len(labels_u))], np.int64)
    out = cur_row.copy()
    out[m] = labels_u[root[inv]]
    return out


def _level_components(points_xy: np.ndarray, core_d: np.ndarray,
                      eps_levels: np.ndarray, coarsen_above: int = 32768,
                      device=None, log: dict | None = None) -> np.ndarray:
    """(L, N) component labels, finest level first; -1 = inactive.

    Each level runs :func:`ops.cc.cc_labels` over the level's active subset
    on ``device``: kernel 5 on the card, the plain version on the CPU, both
    labelling a component by its minimum input index (the contract of
    ``pallas_cc.cc_labels_banded``, which the JAX package runs on the TPU).
    Above ``coarsen_above`` active points the subset is first quantized onto
    an eps/8 grid and the pass runs over cell centroids
    (:func:`_coarse_reps`).  Hierarchy nesting is enforced explicitly
    (:func:`_union_nested`).  ``log``, when given, gains per level the
    active points (``active``) and the points the pass saw (``reps``)."""
    dev = resolve_device(device)
    n = len(points_xy)
    out = np.empty((len(eps_levels), n), np.int32)

    prev_row = None
    for i, eps in enumerate(eps_levels):
        # compare in f32 (core_d is f32; an f64 eps equal to a representable
        # f32 would spuriously exclude points)
        active = np.isfinite(core_d) & (core_d <= np.float32(eps))
        row = np.full(n, -1, np.int32)
        idx = np.where(active)[0]
        pts_cc = None
        if len(idx):
            xy = np.ascontiguousarray(points_xy[idx, :2], np.float32)
            inverse = None
            pts_cc = xy
            if len(idx) > coarsen_above:
                reps, inv_q = _coarse_reps(xy, float(eps))
                if len(reps) <= 0.7 * len(idx):
                    pts_cc, inverse = reps, inv_q
            comp = cc_labels(torch.from_numpy(pts_cc).to(dev), float(eps))
            comp_pt = comp if inverse is None else comp[inverse]
            # label values only need uniqueness within the level (the
            # condensed-tree walk keys on (node, comp) pairs); the pass's
            # labels are min-subset/rep-index, always < n+1
            row[idx] = comp_pt.astype(np.int32)
            if prev_row is not None:
                row = _union_nested(prev_row, row)
        if log is not None:
            log.setdefault("active", []).append(len(idx))
            log.setdefault("reps", []).append(
                0 if pts_cc is None else len(pts_cc))
        out[i] = row
        prev_row = row
    return out


def _condense_and_extract(levels: np.ndarray, lambdas: np.ndarray,
                          min_cluster_size: int,
                          weights: np.ndarray | None = None) -> np.ndarray:
    """Condensed-tree construction + excess-of-mass cluster extraction over
    the discrete hierarchy.  ``levels`` is (L, N) finest-first; ``lambdas``
    the matching 1/eps values (descending).  Returns per-point cluster ids
    (consecutive from 0) or -1 for noise.

    ``weights`` (optional, (N,) float): point multiplicities for the
    quantized large-N path — component sizes compare summed weight against
    ``min_cluster_size`` and stability accumulates weight·Δλ, which is
    exactly HDBSCAN run on the un-quantized points up to the cell size."""
    L, n = levels.shape
    m = int(min_cluster_size)
    w = (np.ones(n, np.float64) if weights is None
         else np.asarray(weights, np.float64))
    # one virtual step beyond the finest level: points that survive to the
    # bottom leave there (truncates all stabilities equally)
    lam_end = lambdas[0] * (lambdas[0] / lambdas[1] if L > 1 else 2.0)

    parent: list[int] = []
    birth: list[float] = []
    stability: list[float] = []
    node_of_point = np.full(n, -1, np.int64)
    leave_node = np.full(n, -1, np.int64)

    # roots: big components at the coarsest level
    c_top = levels[L - 1]
    act = c_top >= 0
    uniq, inv = np.unique(c_top[act], return_inverse=True)
    counts = np.bincount(inv, weights=w[act])
    big = counts >= m
    comp_to_node = np.full(len(uniq), -1, np.int64)
    for ci in np.where(big)[0]:
        comp_to_node[ci] = len(parent)
        parent.append(-1)
        birth.append(lambdas[L - 1])
        stability.append(0.0)
    node_of_point[act] = comp_to_node[inv]

    for li in range(L - 2, -1, -1):  # coarse -> fine
        lam = lambdas[li]
        c = levels[li]
        inn = node_of_point >= 0
        if not inn.any():
            break
        idx = np.where(inn)[0]
        nodes = node_of_point[idx]
        comps = c[idx]
        # pair (node, comp) for points still active at this level
        alive = comps >= 0
        pair_key = nodes[alive] * np.int64(n + 1) + comps[alive]
        ukey, uinv = np.unique(pair_key, return_inverse=True)
        ucnt = np.bincount(uinv, weights=w[idx][alive])
        unode = ukey // (n + 1)
        # per node: how many big children
        big_mask = ucnt >= m
        n_big = np.bincount(unode[big_mask].astype(np.int64),
                            minlength=len(parent))
        # stability closes for nodes that split (>=2 big children) or die
        # (0 big children); nodes with exactly 1 big child continue.
        # points leaving now: inactive, in small comps, or any point of a
        # splitting node.
        # map (node, comp) pairs of splitting nodes' big children -> new nodes
        new_node_of_pair = np.full(len(ukey), -1, np.int64)
        for pi in np.where(big_mask)[0]:
            nd = int(unode[pi])
            if n_big[nd] >= 2:
                new_node_of_pair[pi] = len(parent)
                parent.append(nd)
                birth.append(lam)
                stability.append(0.0)

        # continuation pairs: single big child of a non-splitting node
        keep_pair = big_mask & (n_big[unode] == 1)

        # per-point transition
        pair_of_point = np.full(len(idx), -1, np.int64)
        pair_of_point[alive] = uinv
        stays = np.zeros(len(idx), bool)
        next_node = np.full(len(idx), -1, np.int64)
        pa = pair_of_point[alive]
        stay_keep = keep_pair[pa]
        stay_new = new_node_of_pair[pa] >= 0
        al_idx = np.where(alive)[0]
        stays[al_idx[stay_keep]] = True
        next_node[al_idx[stay_keep]] = nodes[alive][stay_keep]
        stays[al_idx[stay_new]] = True
        next_node[al_idx[stay_new]] = new_node_of_pair[pa[stay_new]]

        leaving = ~stays
        # stability: leavers contribute (lam - birth[node]); points entering
        # child nodes contribute (lam_split - birth[parent]) to the parent
        birth_arr = np.asarray(birth)
        stab_add = np.zeros(len(parent))
        w_idx = w[idx]
        np.add.at(stab_add, nodes[leaving],
                  (lam - birth_arr[nodes[leaving]]) * w_idx[leaving])
        moved = stay_new & (new_node_of_pair[pa] >= 0)
        np.add.at(stab_add, nodes[alive][moved],
                  (lam - birth_arr[nodes[alive][moved]]) * w_idx[alive][moved])
        for ni in np.nonzero(stab_add)[0]:
            stability[ni] += stab_add[ni]

        leave_node[idx[leaving]] = nodes[leaving]
        node_of_point[idx[leaving]] = -1
        node_of_point[idx[stays]] = next_node[stays]

    # survivors leave at lam_end
    inn = node_of_point >= 0
    if inn.any():
        birth_arr = np.asarray(birth)
        nodes = node_of_point[inn]
        stab_add = np.zeros(len(parent))
        np.add.at(stab_add, nodes, (lam_end - birth_arr[nodes]) * w[inn])
        for ni in np.nonzero(stab_add)[0]:
            stability[ni] += stab_add[ni]
        leave_node[inn] = nodes

    n_nodes = len(parent)
    if n_nodes == 0:
        return np.full(n, -1, np.int64)
    parent_arr = np.asarray(parent, np.int64)
    stab = np.asarray(stability)

    # excess-of-mass selection, children before parents (ids ascend root->leaf)
    children: list[list[int]] = [[] for _ in range(n_nodes)]
    for i in range(n_nodes):
        if parent_arr[i] >= 0:
            children[parent_arr[i]].append(i)
    sel_stab = np.zeros(n_nodes)
    selected = np.zeros(n_nodes, bool)
    for i in range(n_nodes - 1, -1, -1):
        child_sum = sum(sel_stab[c] for c in children[i])
        # allow_single_cluster=False semantics: a root that splits stands in
        # for HDBSCAN's global root and is never selected over its children
        root_with_children = parent_arr[i] < 0 and bool(children[i])
        if not children[i] or (stab[i] >= child_sum and not root_with_children):
            sel_stab[i] = stab[i]
            selected[i] = True
        else:
            sel_stab[i] = child_sum
    # prune: a node selected with a selected ancestor defers to the ancestor
    label_node = np.full(n_nodes, -1, np.int64)
    final_sel = np.zeros(n_nodes, bool)
    for i in range(n_nodes):  # roots first
        p = parent_arr[i]
        anc = label_node[p] if p >= 0 else -1
        if anc >= 0:
            label_node[i] = anc
        elif selected[i]:
            label_node[i] = i
            final_sel[i] = True

    out = np.full(n, -1, np.int64)
    has = leave_node >= 0
    out[has] = label_node[leave_node[has]]
    # consecutive ids from 0
    pos = out >= 0
    if pos.any():
        uniq = np.unique(out[pos])
        remap = {int(u): i for i, u in enumerate(uniq)}
        out[pos] = np.vectorize(remap.get)(out[pos])
    return out


def _quantize_weighted(points_xy: np.ndarray, target_cells: int = 40000,
                       max_cell: float = 0.05):
    """Quantize 2D points onto a grid, returning (cells (M, 2) f32 centroids,
    weights (M,) f64, inverse (N,) int, cell size).

    The cell size targets ``target_cells`` occupied cells but is capped at
    ``max_cell`` metres so the positional error stays far below tree-scale
    cluster separations even on sprawling plots (more cells simply cost a
    little more host time, which is linear)."""
    pts = np.asarray(points_xy, np.float32)[:, :2]
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-6)
    cell = min(float(np.sqrt(span[0] * span[1] / max(target_cells, 1))),
               max_cell)
    cell = max(cell, 1e-4)
    ix = np.floor((pts - lo) / cell).astype(np.int64)
    key = ix[:, 0] * (int(span[1] / cell) + 2) + ix[:, 1]
    uniq, inverse, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
    m = len(uniq)
    cells = np.zeros((m, 2), np.float64)
    np.add.at(cells, inverse, pts)
    cells /= counts[:, None]
    return cells.astype(np.float32), counts.astype(np.float64), inverse, cell


def _weighted_core_distance(cells: np.ndarray, w: np.ndarray, k: int,
                            tree=None) -> np.ndarray:
    """Distance from each cell to the k-th nearest POINT (multiplicity-
    weighted, self-inclusive), via neighbor-count escalation on a KD-tree."""
    from scipy.spatial import cKDTree

    m = len(cells)
    if tree is None:
        tree = cKDTree(cells)
    core = np.full(m, np.inf, np.float64)
    need = np.arange(m)
    mean_w = max(float(w.mean()), 1.0)
    kq = min(m, max(4, int(np.ceil(k / mean_w)) + 4))
    for _ in range(8):
        if len(need) == 0 or kq > m:
            break
        d, i = tree.query(cells[need], k=kq, workers=-1)
        if kq == 1:
            d, i = d[:, None], i[:, None]
        cw = np.cumsum(w[i], axis=1)
        found = cw[:, -1] >= k
        pos = np.argmax(cw >= k, axis=1)
        rows = np.where(found)[0]
        core[need[rows]] = d[rows, pos[rows]]
        need = need[~found]
        kq = min(m, kq * 4)
    if len(need):
        # fewer than k points in the whole set reachable: cap at the full
        # query (kq clipped to m above ensures the final pass saw everyone)
        d, i = tree.query(cells[need], k=m, workers=-1)
        if m == 1:
            d, i = d[:, None], i[:, None]
        cw = np.cumsum(w[i], axis=1)
        pos = np.minimum(np.argmax(cw >= k, axis=1), m - 1)
        core[need] = d[np.arange(len(need)), pos]
    return core


def _knn_mst_edges(cells: np.ndarray, core: np.ndarray, k_edges: int = 16,
                   tree=None):
    """Mutual-reachability MST (forest) edges over the k-NN candidate graph.

    Returns (u, v, weight) arrays sorted ascending by weight.  The k-NN graph
    contains every mutual-reachability MST edge whose weight is one of the
    endpoint core distances (such a neighbor lies within the endpoint's core
    radius); genuinely long bridge edges between far-apart dense regions can
    fall outside it, in which case those regions stay separate roots of the
    forest — for excess-of-mass extraction that is equivalent to merging at
    a very coarse level."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import cKDTree

    m = len(cells)
    if tree is None:
        tree = cKDTree(cells)
    kq = min(m, k_edges + 1)
    d, i = tree.query(cells, k=kq, workers=-1)
    if kq == 1:
        d, i = d[:, None], i[:, None]
    src = np.repeat(np.arange(m, dtype=np.int64), kq - 1)
    dst = i[:, 1:].ravel().astype(np.int64)
    dd = d[:, 1:].ravel()
    mr = np.maximum(dd, np.maximum(core[src], core[dst]))
    # canonical undirected pairs with min weight (coo duplicate entries SUM
    # on conversion, so dedup first)
    a = np.minimum(src, dst)
    b = np.maximum(src, dst)
    key = a * np.int64(m) + b
    order = np.lexsort((mr, key))
    key_s, mr_s = key[order], mr[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    key_u, mr_u = key_s[first], mr_s[first]
    au, bu = key_u // m, key_u % m
    g = coo_matrix((mr_u + 1e-12, (au, bu)), shape=(m, m)).tocsr()
    t = minimum_spanning_tree(g).tocoo()
    order = np.argsort(t.data, kind="stable")
    return (t.row[order].astype(np.int64), t.col[order].astype(np.int64),
            t.data[order] - 1e-12)


def _levels_from_mst(mst_u, mst_v, mst_w, core: np.ndarray,
                     eps_levels: np.ndarray) -> np.ndarray:
    """(L, M) component labels from thresholding the MST at each eps level
    (finest first), -1 where the cell's core distance exceeds the level.

    Exact w.r.t. the MST: components at eps are the MST edges with weight
    <= eps (single-linkage property), built incrementally with union-find."""
    m = len(core)
    parent = np.arange(m, dtype=np.int64)

    def find_all():
        p = parent
        while True:
            gp = p[parent]
            if np.array_equal(gp, parent):
                return parent
            parent[:] = gp

    def union(a, b):
        ra, rb = a, b
        while parent[ra] != ra:
            ra = parent[ra]
        while parent[rb] != rb:
            rb = parent[rb]
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    out = np.empty((len(eps_levels), m), np.int32)
    e = 0
    for li, eps in enumerate(eps_levels):
        while e < len(mst_w) and mst_w[e] <= eps:
            union(int(mst_u[e]), int(mst_v[e]))
            e += 1
        roots = find_all().copy()
        row = roots.astype(np.int32)
        row[core > np.float64(eps)] = -1
        out[li] = row
    return out


def hdbscan_cluster_large(points_xy: np.ndarray, min_cluster_size: int,
                          min_samples: int | None = None, n_levels: int = 64,
                          target_cells: int = 40000) -> np.ndarray:
    """Scalable HDBSCAN for the >device_max regime: grid-quantized weighted
    formulation on the host (KD-tree cores + k-NN-graph mutual-reachability
    MST + the weighted condensed tree of :func:`_condense_and_extract`).

    Equivalent to HDBSCAN on the raw points up to the quantization cell
    (<= 5 cm, far below tree-base separations).  Returns labels >= 0,
    noise = -1 (the caller maps the public contract)."""
    pts = np.asarray(points_xy, np.float32)[:, :2]
    n = len(pts)
    m = int(min_cluster_size)
    k = m if min_samples is None else int(min_samples)

    cells, w, inverse, cell_sz = _quantize_weighted(pts,
                                                    target_cells=target_cells)
    from scipy.spatial import cKDTree

    tree = cKDTree(cells)
    core = _weighted_core_distance(cells, w, k, tree=tree)
    mst_u, mst_v, mst_w = _knn_mst_edges(cells, core, tree=tree)

    finite_core = core[np.isfinite(core) & (core > 0)]
    pool = np.concatenate([finite_core, mst_w[mst_w > 0]])
    if len(pool) == 0:
        # degenerate: every point coincident (zero cores, zero-length MST)
        # — one cluster if it clears the size bar, else noise
        lab = 0 if w.sum() >= m else -1
        return np.full(n, lab, np.int64)
    # floor the ladder at the quantization scale: a heavy cell (hundreds of
    # coincident-after-quantization points) has weighted core distance 0, and
    # a ladder descending below the cell size would resolve "structure" the
    # quantization erased — every dense cell splits off as its own maximally
    # stable cluster.  Below ~2 cells nothing is distinguishable, so that is
    # where the hierarchy must bottom out.
    lo = max(float(np.percentile(pool, 2.0)), 2.0 * cell_sz, 1e-4)
    hi = max(float(pool.max()) * 1.001, lo * 4.0)
    eps_levels = np.geomspace(lo, hi, n_levels).astype(np.float64)

    levels = _levels_from_mst(mst_u, mst_v, mst_w, core, eps_levels)
    lambdas = 1.0 / eps_levels
    cell_labels = _condense_and_extract(levels, lambdas, m, weights=w)
    return cell_labels[inverse]


def hdbscan_cluster(points_xy: np.ndarray, min_cluster_size: int,
                    min_samples: int | None = None, n_levels: int = 32,
                    not_assigned_label: int = -1, start_num: int = 1,
                    device=None, log: dict | None = None) -> np.ndarray:
    """HDBSCAN labels over 2D points: exact core distances, the eps-ladder's
    component passes on ``device`` (kernel 5 on the card), host
    condensed-tree extraction.

    Matches the grouping contract of the reference's group_hdbscan
    (util/pipeline.py:184-191): clusters numbered from ``start_num``,
    noise = ``not_assigned_label``; the caller applies the tau_min size
    filter (already implied by min_cluster_size here).  ``device`` is
    ``cuda`` unless the caller asks otherwise; without a card this raises.

    Above ``TL_HDBSCAN_DEVICE_MAX`` points (default 50k) this switches to
    :func:`hdbscan_cluster_large` on the host (grid-quantized weighted
    HDBSCAN); ``TL_HDBSCAN_HOST=sklearn`` takes sklearn's HDBSCAN there
    instead (the reference's engine), imported only then.

    ``log``, when given, gains ``route`` ("ladder", "large" or "sklearn")
    and, on the ladder, the seconds of the core distances, the ladder and
    the condense/extract (``core_s``, ``ladder_s``, ``condense_s``), its
    inputs and rows (``core_d``, ``eps_levels``, ``levels``) and per level
    the active points and the points the pass saw (``active``, ``reps``)."""
    dev = resolve_device(device)
    points_xy = np.asarray(points_xy, np.float32)[:, :2]
    n = len(points_xy)
    if n == 0:
        return np.zeros(0, np.int64)
    m = int(min_cluster_size)
    if n < m:
        return np.full(n, not_assigned_label, np.int64)
    log = {} if log is None else log

    device_max = int(os.environ.get("TL_HDBSCAN_DEVICE_MAX", 50000))
    if n > device_max:
        if os.environ.get("TL_HDBSCAN_HOST") == "sklearn":
            from sklearn.cluster import HDBSCAN

            log["route"] = "sklearn"
            ref = HDBSCAN(
                min_cluster_size=m,
                min_samples=None if min_samples is None else int(min_samples),
            ).fit(points_xy).labels_
        else:
            log["route"] = "large"
            ref = hdbscan_cluster_large(points_xy, m, min_samples=min_samples)
        out = np.full(n, not_assigned_label, np.int64)
        pos = ref >= 0
        out[pos] = ref[pos] + start_num
        return out

    k = m if min_samples is None else int(min_samples)
    log["route"] = "ladder"
    t0 = time.time()
    core_d2 = kth_neighbor_d2(points_xy, k=k)
    core_d = np.sqrt(core_d2)
    eps_levels = _ladder(core_d, n_levels)
    t1 = time.time()
    levels = _level_components(points_xy, core_d, eps_levels, device=dev,
                               log=log)
    t2 = time.time()
    lambdas = 1.0 / eps_levels
    labels = _condense_and_extract(levels, lambdas, m)
    log.update(core_s=t1 - t0, ladder_s=t2 - t1, condense_s=time.time() - t2,
               core_d=core_d, eps_levels=eps_levels, levels=levels)
    out = np.full(n, not_assigned_label, np.int64)
    pos = labels >= 0
    out[pos] = labels[pos] + start_num
    return out
