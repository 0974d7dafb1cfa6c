"""Plain HDBSCAN (Campello, Moulavi and Sander 2013; the algorithm of
scikit-learn's ``HDBSCAN(min_cluster_size=m)`` that the configuration's
grouping names): exact core distances, the exact minimum spanning tree of
the mutual-reachability graph, the single-linkage hierarchy, the condensed
tree and the excess-of-mass selection without a single cluster.

- Core distance: the distance to the ``min_samples``-th nearest point, the
  point itself counted (a KD-tree, float64).
- Mutual reachability: max(core(p), core(q), |p - q|).
- The spanning tree: Boruvka rounds, each finding every point's lightest
  edge to another component by brute force over all points (blocks of rows
  on ``device``), edges ordered by (weight, lower index, higher index) so
  that ties cannot close a cycle.
- Condensed tree: from the root down, a split into two children of at
  least ``min_cluster_size`` points makes two clusters; a smaller child's
  points fall out of the cluster at lambda = 1 / distance.
- Stability of a cluster: the sum over what falls out of it of (lambda -
  its birth lambda) x size; a cluster is selected where its stability is not
  below the sum of its children's selected stabilities; the root is never
  selected; every point takes the selected cluster it falls out of, or of
  the nearest selected ancestor, else -1.
"""

from __future__ import annotations

import numpy as np
import torch


def core_distances(xy: np.ndarray, k: int) -> np.ndarray:
    from scipy.spatial import cKDTree

    xy = np.asarray(xy, np.float64)
    k = min(int(k), len(xy))
    d, _ = cKDTree(xy).query(xy, k=k)
    return d.reshape(len(xy), k)[:, -1]


def _lightest_edges(x, y, c2, comp, block: int):
    """Per point, the squared weight and index of its lightest edge to a
    point of another component, the lowest index among equal weights."""
    n = x.shape[0]
    best_w = torch.empty(n, dtype=x.dtype, device=x.device)
    best_q = torch.empty(n, dtype=torch.long, device=x.device)
    for s in range(0, n, block):
        e = min(n, s + block)
        dx = x[None, :] - x[s:e, None]
        w = dx * dx
        del dx
        dy = y[None, :] - y[s:e, None]
        w.addcmul_(dy, dy)
        del dy
        torch.maximum(w, c2[None, :], out=w)
        torch.maximum(w, c2[s:e, None], out=w)
        w.masked_fill_(comp[None, :] == comp[s:e, None], float("inf"))
        q = torch.argmin(w, dim=1)
        best_q[s:e] = q
        best_w[s:e] = w.gather(1, q[:, None])[:, 0]
        del w
    return best_w, best_q


def mutual_reachability_mst(xy: np.ndarray, core: np.ndarray, device,
                            block: int = 2048):
    """(u, v, weight) of the n - 1 edges of the exact minimum spanning tree
    of the mutual-reachability graph, by Boruvka rounds."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(xy)
    dev = torch.device(device)
    dt = torch.float64 if dev.type == "cpu" else torch.float32
    xy = np.asarray(xy, np.float64)
    x = torch.as_tensor(xy[:, 0], dtype=dt, device=dev)
    y = torch.as_tensor(xy[:, 1], dtype=dt, device=dev)
    c2 = torch.as_tensor(np.square(np.asarray(core, np.float64)), dtype=dt,
                         device=dev)
    comp = np.arange(n)
    us, vs, ws = [], [], []
    n_comp = n
    while n_comp > 1:
        bw, bq = _lightest_edges(x, y, c2,
                                 torch.as_tensor(comp, device=dev), block)
        bw = bw.double().cpu().numpy()
        bq = bq.cpu().numpy()
        p = np.arange(n)
        a, b = np.minimum(p, bq), np.maximum(p, bq)
        order = np.lexsort((b, a, bw, comp))
        first = np.ones(n, bool)
        first[1:] = comp[order][1:] != comp[order][:-1]
        pick = order[first]
        key = np.unique(a[pick] * np.int64(n) + b[pick], return_index=True)[1]
        pick = pick[key]
        us.append(a[pick])
        vs.append(b[pick])
        ws.append(np.sqrt(bw[pick]))
        g = coo_matrix((np.ones(len(pick)), (comp[a[pick]], comp[b[pick]])),
                       shape=(n, n))
        n_comp, lab = connected_components(g, directed=False)
        comp = lab[comp]
        n_comp = len(np.unique(comp))
    if not us:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    return np.concatenate(us), np.concatenate(vs), np.concatenate(ws)


def single_linkage(u, v, w, n: int):
    """The dendrogram of the spanning tree: for each merge, in order of
    weight, (left node, right node, distance, size); node n + i is merge
    i."""
    order = np.argsort(w, kind="stable")
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, np.int64)
    left = np.empty(n - 1, np.int64)
    right = np.empty(n - 1, np.int64)
    dist = np.empty(n - 1)

    def find(a):
        r = a
        while parent[r] != r:
            r = parent[r]
        while parent[a] != r:
            parent[a], a = r, parent[a]
        return r

    for i, e in enumerate(order):
        ra, rb = find(int(u[e])), find(int(v[e]))
        node = n + i
        left[i], right[i], dist[i] = ra, rb, w[e]
        size[node] = size[ra] + size[rb]
        parent[ra] = parent[rb] = node
    return left, right, dist, size


def _leaves(left, right, n: int):
    """Leaves of the dendrogram in depth-first order and, per node, the
    start of its leaves in that order."""
    start = np.zeros(2 * n - 1, np.int64)
    out = []
    stack = [2 * n - 2]
    while stack:
        node = stack.pop()
        if node < n:
            start[node] = len(out)
            out.append(node)
            continue
        start[node] = len(out)
        stack.append(right[node - n])
        stack.append(left[node - n])
    return np.asarray(out, np.int64), start


def condensed_tree(left, right, dist, size, n: int, m: int):
    """Records (parent cluster, child, lambda, child size) of the condensed
    tree, clusters numbered from 0 (the root) in the order they are born;
    a child that is a point has size 1 and is flagged by ``is_point``."""
    order, start = _leaves(left, right, n)
    parent, child, lam, csize, is_point = [], [], [], [], []
    cluster_of = {2 * n - 2: 0}
    next_cluster = 1
    stack = [2 * n - 2]
    while stack:
        node = stack.pop()
        c = cluster_of[node]
        i = node - n
        d = dist[i]
        lv = 1.0 / d if d > 0 else np.inf
        kids = (left[i], right[i])
        big = [size[k] >= m for k in kids]
        for k, is_big in zip(kids, big):
            if is_big and all(big):
                cluster_of[k] = next_cluster
                parent.append(c)
                child.append(next_cluster)
                lam.append(lv)
                csize.append(size[k])
                is_point.append(False)
                next_cluster += 1
                stack.append(k)
            elif is_big:
                cluster_of[k] = c
                stack.append(k)
            else:
                pts = order[start[k]:start[k] + size[k]]
                parent.extend([c] * len(pts))
                child.extend(pts.tolist())
                lam.extend([lv] * len(pts))
                csize.extend([1] * len(pts))
                is_point.extend([True] * len(pts))
    return (np.asarray(parent, np.int64), np.asarray(child, np.int64),
            np.asarray(lam, np.float64), np.asarray(csize, np.int64),
            np.asarray(is_point, bool), next_cluster)


def select_eom(parent, child, lam, csize, is_point, n_clusters: int):
    """Selected clusters by excess of mass, the root excluded."""
    birth = np.zeros(n_clusters)
    cl = ~is_point
    birth[child[cl]] = lam[cl]
    stab = np.zeros(n_clusters)
    np.add.at(stab, parent, (lam - birth[parent]) * csize)
    kids = [[] for _ in range(n_clusters)]
    for p, c in zip(parent[cl], child[cl]):
        kids[p].append(int(c))
    selected = np.zeros(n_clusters, bool)
    best = stab.copy()
    for c in range(n_clusters - 1, 0, -1):
        sub = sum(best[k] for k in kids[c])
        if kids[c] and sub > stab[c]:
            best[c] = sub
        else:
            selected[c] = True
            todo = list(kids[c])
            while todo:
                k = todo.pop()
                selected[k] = False
                todo.extend(kids[k])
    return selected


def hdbscan_labels(xy: np.ndarray, min_cluster_size: int,
                   min_samples: int | None = None, device="cpu") -> np.ndarray:
    """Cluster ids from 0 (in order of birth), -1 for noise, of 2-D
    points."""
    xy = np.asarray(xy, np.float64)
    n = len(xy)
    m = int(min_cluster_size)
    if n < max(m, 2):
        return np.full(n, -1, np.int64)
    core = core_distances(xy, m if min_samples is None else min_samples)
    u, v, w = mutual_reachability_mst(xy, core, device)
    left, right, dist, size = single_linkage(u, v, w, n)
    parent, child, lam, csize, is_point, nc = condensed_tree(
        left, right, dist, size, n, m)
    selected = select_eom(parent, child, lam, csize, is_point, nc)
    # each point's cluster: climb from the cluster it falls out of to the
    # first selected one
    up = np.full(nc, -1, np.int64)
    cl = ~is_point
    up[child[cl]] = parent[cl]
    owner = np.full(nc, -1, np.int64)
    for c in range(nc):
        if selected[c]:
            owner[c] = c
        elif c > 0 and owner[up[c]] >= 0:
            owner[c] = owner[up[c]]
    out = np.full(n, -1, np.int64)
    out[child[is_point]] = owner[parent[is_point]]
    ids = np.unique(out[out >= 0])
    remap = np.full(nc, -1, np.int64)
    remap[ids] = np.arange(len(ids))
    out[out >= 0] = remap[out[out >= 0]]
    return out
