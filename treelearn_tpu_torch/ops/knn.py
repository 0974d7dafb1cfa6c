"""Banded k-NN majority vote — kernel 6 of the port.

Replaces the Pallas kernel ``_knn_kernel`` / ``_knn_pallas_call`` and the
host pass around it (treelearn_tpu/ops/pallas_knn.py:48,125,216) and keeps
the routing of ``banded_knn_classify`` (pallas_knn.py:310-421), in order:
the small-refs host KD-tree, the pairs threshold, the ``>= 2^24`` label
guard, the 2^14-query probe gate above 2^17 queries, escalation rounds that
make the cell 4x coarser each time, and the exact backstop.

A pass (:func:`prepare_pass`, :func:`knn_pass`) runs on the device: cell
indices ``floor(x * f32(1/cell))`` (a reciprocal multiply, never a
division), cell keys ``i * 30000 + j``, refs and queries sorted by key, and
per query the three sorted-ref ranges of cell rows i-1, i, i+1 (columns
j-1 .. j+1) from ``searchsorted``.  Coordinates are scaled by the same
f32(1/cell), so the radius is 1, as in the Pallas call.  Queries of one cell
(a *group*, a run of equal keys) have the same ranges; the pass also packs
the refs as 16-byte records (x, y, z, label bits) and cuts the groups into
the work items of the CUDA kernel (:func:`pass_items`).

The TPU's 128-aligned DMA windows, their 90th-percentile sizing and the
``overflow_tiles`` re-run guard have nothing to guard here: a query is done
exactly when it found k refs within radius ``cell``.  A round still stops
the escalation when fewer than a quarter of its queries are done.

Bound on the card: the float32 instruction rate (about 10 operations per
candidate ref and query) on clumped refs and in the late rounds, memory on
sparse ones.  The kernel (csrc/knn.cu) gives a block one work item, ``qs`` queries
of a group x ``256 / qs`` partitions of the group's candidates, stages the
candidates through shared memory so that every staged ref serves all the
block's queries, and merges the partitions' k nearest by (d2, position in
the sorted refs), which is the serial walk's order, so the split is exact.
:func:`knn_pass_grouped_plain` is that walk in PyTorch; the one-thread-a-
query kernel it replaced stays behind :func:`knn_pass_serial` as the timed
yardstick.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

GRID_WIDTH = 30000   # cell-key stride, as pallas_knn.py:_GRID_WIDTH
K_MAX = 8            # csrc/knn.cu keeps at most this many neighbors
LABEL_LIMIT = 1 << 24
BLOCK_THREADS = 256  # threads of a block of csrc/knn.cu
CANDS_PER_PART = 256  # candidates a partition should at least walk
MIN_SLICE = 32       # queries a block keeps when its group has that many


class KnnPass(NamedTuple):
    """One pass's problem: scaled, cell-sorted refs and queries."""

    refs: torch.Tensor     # (R, 3) f32, x * f32(1/cell), key-sorted
    labels: torch.Tensor   # (R,) int32 encoded labels, key-sorted
    queries: torch.Tensor  # (Q, 3) f32, x * f32(1/cell), key-sorted
    ranges: torch.Tensor   # (Q, 6) int32 [lo, hi) of cell rows i-1, i, i+1
    q_order: torch.Tensor  # (Q,) int64: sorted row -> input row
    k: int
    refs4: torch.Tensor    # (R, 4) f32 records: refs, then the label's bits
    groups: torch.Tensor   # (G + 1,) int32 starts of the runs of equal key
    items: torch.Tensor    # (N, 3) int32 work items, see pass_items


def prepare_pass(ref_pts: torch.Tensor, ref_enc: torch.Tensor,
                 query_pts: torch.Tensor, cell: float, k: int) -> KnnPass:
    """Sort refs and queries by xy cell key and find each query's three
    cell-row ranges (the span table of pallas_knn.py:225-250, per query)."""
    inv_cell = float(np.float32(1.0) / np.float32(cell))
    ij_r = torch.floor(ref_pts[:, :2] * inv_cell).long()
    ij_q = torch.floor(query_pts[:, :2] * inv_cell).long()
    mins = torch.minimum(ij_r.min(0).values, ij_q.min(0).values)
    ij_r -= mins
    ij_q -= mins
    if int(torch.maximum(ij_r[:, 1].max(), ij_q[:, 1].max())) >= GRID_WIDTH:
        raise ValueError(f"knn: more than {GRID_WIDTH} cell columns")
    if ref_pts.shape[0] >= 2**31:
        raise ValueError("knn: more refs than int32 ranges can index")
    keys_r = ij_r[:, 0] * GRID_WIDTH + ij_r[:, 1]
    keys_q = ij_q[:, 0] * GRID_WIDTH + ij_q[:, 1]
    skeys_r, order_r = torch.sort(keys_r, stable=True)
    skeys_q, order_q = torch.sort(keys_q, stable=True)
    jq = ij_q[order_q, 1]
    lo_off = torch.where(jq > 0, 1, 0)
    hi_off = torch.where(jq < GRID_WIDTH - 1, 2, 1)
    bounds = []
    for di in (-1, 0, 1):
        row = skeys_q + di * GRID_WIDTH
        bounds.append(torch.searchsorted(skeys_r, row - lo_off))
        bounds.append(torch.searchsorted(skeys_r, row + hi_off))
    refs = (ref_pts[order_r, :3] * inv_cell).contiguous()
    labels = ref_enc[order_r].to(torch.int32).contiguous()
    ranges = torch.stack(bounds, 1).to(torch.int32).contiguous()
    first = torch.ones_like(skeys_q, dtype=torch.bool)
    first[1:] = skeys_q[1:] != skeys_q[:-1]
    groups = torch.cat([torch.nonzero(first).squeeze(1),
                        torch.tensor([skeys_q.shape[0]],
                                     device=skeys_q.device)]).to(torch.int32)
    return KnnPass(
        refs=refs, labels=labels,
        queries=(query_pts[order_q, :3] * inv_cell).contiguous(),
        ranges=ranges, q_order=order_q, k=int(k),
        refs4=torch.cat([refs, labels.view(torch.float32)[:, None]],
                        1).contiguous(),
        groups=groups, items=pass_items(groups, ranges))


def pass_items(groups: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Cut the groups into the kernel's work items: (N, 3) int32 rows
    (first sorted query, queries, ``qs``).  A block of ``BLOCK_THREADS``
    threads gives ``qs`` of them a query each, ``BLOCK_THREADS / qs`` times
    over: that many partitions share the group's candidates.  ``qs`` is a
    power of two: as small as leaves every partition ``CANDS_PER_PART``
    candidates, but at least ``MIN_SLICE`` queries (or all the group has),
    so that a staged ref serves many queries.  From the counts alone."""
    dev = groups.device
    g0 = groups[:-1].long()
    n_groups = g0.shape[0]
    if n_groups == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    nq = groups[1:].long() - g0
    rg = ranges[g0].long()
    cand = (rg[:, 1::2] - rg[:, 0::2]).sum(1)
    pow2 = 2 ** torch.arange(1, 9, device=dev)              # 2 .. 256
    parts = 2 ** ((cand // CANDS_PER_PART)[:, None] >= pow2).sum(1)
    parts = torch.clamp(parts, max=BLOCK_THREADS)
    few = 2 ** (torch.clamp(nq, max=MIN_SLICE)[:, None]
                > pow2 // 2).sum(1)            # power of two >= min(nq, MIN_SLICE)
    qs = torch.maximum(BLOCK_THREADS // parts, few)
    n_slices = -(-nq // qs)
    gid = torch.repeat_interleave(torch.arange(n_groups, device=dev),
                                  n_slices)
    before = torch.cumsum(n_slices, 0) - n_slices
    q0 = g0[gid] + (torch.arange(gid.shape[0], device=dev)
                    - before[gid]) * qs[gid]
    left = g0[gid] + nq[gid] - q0
    return torch.stack([q0, torch.minimum(left, qs[gid]), qs[gid]],
                       1).to(torch.int32).contiguous()


def knn_pass_plain(p: KnnPass, max_block: int = 1 << 24):
    """(winner, n_found) int32 in sorted query order: the kernel's
    arithmetic in PyTorch.  Candidates are gathered band by band in sorted
    ref order, in query chunks of at most ``max_block`` candidates; a stable
    sort by d2 keeps the kernel's tie order (equal distances: lower sorted
    ref first).  The distances are written out, not ``torch.cdist``, so that
    both versions round ((dx*dx + dy*dy) + dz*dz) identically at the
    radius."""
    nq, k = p.queries.shape[0], p.k
    dev = p.queries.device
    winner = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    n_found = torch.zeros(nq, dtype=torch.int32, device=dev)
    if nq == 0 or p.refs.shape[0] == 0:
        return winner, n_found
    rg = p.ranges.long()
    span = rg[:, 1::2] - rg[:, 0::2]                    # (Q, 3)
    total = span.sum(1)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    lo = 0
    while lo < nq:
        width = max(int(total[lo:lo + 4096].max()), 1)
        hi = min(nq, lo + max(1, max_block // width))
        width = max(int(total[lo:hi].max()), 1)
        offs = torch.arange(width, device=dev)[None, :]
        s = rg[lo:hi, 0::2]
        sp = span[lo:hi]
        c1 = sp[:, 0:1]
        c2 = c1 + sp[:, 1:2]
        valid = offs < (c2 + sp[:, 2:3])
        band = (offs >= c1).long() + (offs >= c2).long()
        start = torch.gather(s, 1, band)
        before = torch.where(band == 0, 0, torch.where(band == 1, c1, c2))
        idx = torch.where(valid, start + offs - before, 0)
        q = p.queries[lo:hi]
        dx = p.refs[idx, 0] - q[:, 0:1]
        dy = p.refs[idx, 1] - q[:, 1:2]
        dz = p.refs[idx, 2] - q[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        inr = valid & (d2 <= one)
        d2 = torch.where(inr, d2, torch.inf)
        kk = min(k, width)
        d_sorted, order = torch.sort(d2, dim=1, stable=True)
        top = torch.gather(idx, 1, order[:, :kk])
        found = torch.clamp(inr.sum(1), max=k)
        labs = p.labels[top].long()
        n_found[lo:hi] = found.to(torch.int32)
        full = found == k
        if bool(full.any()):
            winner[lo:hi][full] = _vote_rows(labs[full]).to(torch.int32)
        lo = hi
    return winner, n_found


def _vote_rows(votes: torch.Tensor) -> torch.Tensor:
    """Row-wise mode, smallest label among ties."""
    votes = torch.sort(votes, dim=1).values
    counts = (votes[:, :, None] == votes[:, None, :]).sum(2)
    return torch.gather(votes, 1, counts.argmax(1, keepdim=True))[:, 0]


def knn_pass_grouped_plain(p: KnnPass):
    """(winner, n_found) as :func:`knn_pass_plain`, by the CUDA kernel's own
    walk: item by item, the group's candidates in position order dealt to
    ``BLOCK_THREADS / qs`` partitions (position mod partitions), each
    partition's k nearest by (d2, position), the lists merged pairwise
    (partition p takes in p + h, h halving) by the same order, the counts
    added and clamped to k."""
    nq, k = p.queries.shape[0], p.k
    dev = p.queries.device
    winner = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    n_found = torch.zeros(nq, dtype=torch.int32, device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    for q0, n, qs in p.items.tolist():
        parts = BLOCK_THREADS // qs
        rg = p.ranges[q0].tolist()
        idx = torch.cat([torch.arange(rg[2 * b], rg[2 * b + 1], device=dev)
                         for b in range(3)])
        total = idx.shape[0]
        per = max(-(-total // parts), 1)
        q = p.queries[q0:q0 + n]
        dx = p.refs[idx, 0] - q[:, 0:1]
        dy = p.refs[idx, 1] - q[:, 1:2]
        dz = p.refs[idx, 2] - q[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(d2 <= one, d2, torch.inf)
        # (n, positions) -> (n, partitions, walk order), padded with misses
        pad = per * parts - total
        d2 = torch.cat([d2, d2.new_full((n, pad), torch.inf)], 1)
        pos = torch.arange(per * parts, device=dev).expand(n, -1)
        d2 = d2.view(n, per, parts).transpose(1, 2)
        pos = pos.reshape(n, per, parts).transpose(1, 2)
        cnt = torch.clamp((d2 <= one).sum(2), max=k)
        d2, pos = _nearest(d2, pos, k)
        h = parts // 2
        while h >= 1:
            cnt = torch.clamp(cnt[:, :h] + cnt[:, h:2 * h], max=k)
            d2, pos = _nearest(torch.cat([d2[:, :h], d2[:, h:2 * h]], 2),
                               torch.cat([pos[:, :h], pos[:, h:2 * h]], 2), k)
            h //= 2
        found = cnt[:, 0]
        n_found[q0:q0 + n] = found.to(torch.int32)
        full = found == k
        if bool(full.any()):
            labs = p.labels[idx[pos[:, 0][full]]].long()
            winner[q0:q0 + n][full] = _vote_rows(labs).to(torch.int32)
    return winner, n_found


def _nearest(d2: torch.Tensor, pos: torch.Tensor, k: int):
    """The first k of the last axis by (d2, position); short lists are
    padded with misses (inf)."""
    order = torch.sort(pos, dim=-1, stable=True).indices
    d2, pos = torch.gather(d2, -1, order), torch.gather(pos, -1, order)
    order = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    d2, pos = torch.gather(d2, -1, order), torch.gather(pos, -1, order)
    short = k - d2.shape[-1]
    if short > 0:
        d2 = torch.cat([d2, d2.new_full((*d2.shape[:-1], short), torch.inf)],
                       -1)
        pos = torch.cat([pos, pos.new_zeros((*pos.shape[:-1], short))], -1)
    return d2, pos


def _check_pass(p: KnnPass):
    """Wrapper-side checks of a CUDA pass; returns empty outputs."""
    for t, name in ((p.refs, "refs"), (p.queries, "queries"),
                    (p.refs4, "refs4")):
        _cuda.require(t, f"knn {name}", torch.float32, 2)
    _cuda.require(p.labels, "knn labels", torch.int32, 1)
    for t, name in ((p.ranges, "ranges"), (p.items, "items")):
        _cuda.require(t, f"knn {name}", torch.int32, 2)
    if not 1 <= p.k <= K_MAX:
        raise ValueError(f"knn: k={p.k} outside 1..{K_MAX}")
    nq = p.queries.shape[0]
    if (p.refs4.shape != (p.refs.shape[0], 4) or p.ranges.shape != (nq, 6)
            or p.items.shape[1:] != (3,)):
        raise ValueError(f"knn: shapes refs4 {tuple(p.refs4.shape)}, ranges "
                         f"{tuple(p.ranges.shape)}, items "
                         f"{tuple(p.items.shape)}")
    return (torch.empty(nq, dtype=torch.int32, device=p.queries.device),
            torch.empty(nq, dtype=torch.int32, device=p.queries.device))


def knn_pass(p: KnnPass):
    """(winner, n_found) int32 in sorted query order.  CPU tensors take
    :func:`knn_pass_plain`; CUDA tensors launch the kernel, one block per
    work item of ``p.items``."""
    if not p.queries.is_cuda:
        return knn_pass_plain(p)
    winner, n_found = _check_pass(p)
    if winner.shape[0] == 0:
        return winner, n_found
    _cuda.record("knn", problem=p)
    code = _cuda.library().tl_knn_vote(
        p.refs4.data_ptr(), p.queries.data_ptr(), p.ranges.data_ptr(),
        p.items.data_ptr(), p.items.shape[0], p.k, winner.data_ptr(),
        n_found.data_ptr(), _cuda.stream_ptr(p.queries))
    _cuda.check(code, "tl_knn_vote")
    _cuda.LAUNCHES["knn"] += 1
    return winner, n_found


def knn_pass_serial(p: KnnPass):
    """:func:`knn_pass` through the one-thread-a-query kernel the present
    one replaced: the yardstick it is timed against on the card
    (chip_smoke.py, the card tests).  CUDA only; nothing in the package
    calls it."""
    winner, n_found = _check_pass(p)
    if winner.shape[0] == 0:
        return winner, n_found
    code = _cuda.library().tl_knn_vote_serial(
        p.refs.data_ptr(), p.labels.data_ptr(), p.queries.data_ptr(),
        p.ranges.data_ptr(), winner.shape[0], p.k, winner.data_ptr(),
        n_found.data_ptr(), _cuda.stream_ptr(p.queries))
    _cuda.check(code, "tl_knn_vote_serial")
    return winner, n_found


def banded_pass(ref_pts, ref_enc, query_pts, cell: float, k: int):
    """(winner (Q,) int64, done (Q,) bool) in input query order, neighbors
    restricted to distance <= ``cell`` (pallas_knn.py:_banded_knn_pass)."""
    p = prepare_pass(ref_pts, ref_enc, query_pts, cell, k)
    w_s, f_s = knn_pass(p)
    winner = torch.empty_like(w_s)
    found = torch.empty_like(f_s)
    winner[p.q_order] = w_s
    found[p.q_order] = f_s
    return winner.long(), found >= k


def _first_cell(ref_pts: np.ndarray) -> float:
    extent = np.ptp(ref_pts[:, :2], axis=0).max() + 1e-6
    return max(extent / np.sqrt(max(len(ref_pts), 1) / 32.0), 1e-3)


def banded_knn_classify(ref_pts: np.ndarray, ref_labels: np.ndarray,
                        query_pts: np.ndarray, k: int = 5,
                        max_rounds: int = 6, small_refs_kdtree: bool = True,
                        device=None, log=None) -> np.ndarray:
    """Majority vote over the k nearest refs, banded passes with cell-size
    escalation on ``device``; exact against brute force up to float-equal
    distance ties.  ``small_refs_kdtree=False`` forces the device path.
    ``log``, when given, collects ``rounds`` as (n_queries, cell, done
    share, seconds) and ``n_brute``, the stragglers the backstop
    answered."""
    from ..device import resolve_device
    from .cluster import brute_knn, kdtree_knn, vote

    ref_pts = np.asarray(ref_pts, np.float32)
    query_pts = np.asarray(query_pts, np.float32)
    nq, nr = len(query_pts), len(ref_pts)
    log = {} if log is None else log
    log.setdefault("rounds", [])
    log["n_brute"] = 0
    if nq == 0:
        return np.zeros(0, np.int64)
    enc = np.asarray(ref_labels).astype(np.int64)
    base = int(enc.min()) if nr else 0
    enc = enc - base + 1          # labels >= 1, as the Pallas readout needs

    small = int(os.environ.get("TL_KNN_SMALL_REFS", 1 << 17))
    min_pairs = float(os.environ.get("TL_KNN_KDTREE_MIN_PAIRS", 2e10))
    if small_refs_kdtree and nr and nr <= small:
        return vote(enc[kdtree_knn(ref_pts, query_pts, k)]) + base - 1
    dev = resolve_device(device)
    result = np.full(nq, -1, np.int64)
    need = np.ones(nq, bool)
    use_banded = nr >= k and k <= K_MAX
    if use_banded and nq * max(nr, 1) > min_pairs:
        use_banded = False
    if use_banded and nr and int(enc.max()) >= LABEL_LIMIT:
        # the Pallas call carries labels as float32 and packs them under a
        # bit-30 flag; int32 here has room, but the route stays the same
        use_banded = False
    if use_banded:
        refs_d = torch.from_numpy(ref_pts).to(dev)
        enc_d = torch.from_numpy(enc).to(dev)
    if use_banded and nq > 1 << 17:
        # probe a sample before committing many queries (pallas_knn.py:357)
        rng = np.random.default_rng(0)
        sample = query_pts[rng.choice(nq, 1 << 14, replace=False)]
        _, done_s = banded_pass(refs_d, enc_d, torch.from_numpy(sample).to(dev),
                                _first_cell(ref_pts), k)
        if float(done_s.float().mean()) < 0.25:
            use_banded = False
    if use_banded:
        cell = _first_cell(ref_pts)
        queries_d = torch.from_numpy(query_pts).to(dev)
        for _ in range(max_rounds):
            if not need.any():
                break
            idx = np.where(need)[0]
            t0 = time.time()
            winner, done = banded_pass(
                refs_d, enc_d, queries_d[torch.from_numpy(idx).to(dev)],
                float(cell), k)
            winner, done = winner.cpu().numpy(), done.cpu().numpy()
            result[idx[done]] = winner[done]
            need[idx] = ~done
            share = float(done.mean())
            log["rounds"].append((len(idx), float(cell), share,
                                  time.time() - t0))
            if share < 0.25:
                break
            cell *= 4.0

    if need.any():
        idx = np.where(need)[0]
        log["n_brute"] = len(idx)
        if len(idx) * max(nr, 1) > min_pairs:
            nn = kdtree_knn(ref_pts, query_pts[idx], k)
        else:
            nn = brute_knn(ref_pts, query_pts[idx], k=k, device=dev)
        result[idx] = vote(enc[nn])
    return result + base - 1
