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
j-1 .. j+1) from ``searchsorted``.  The CUDA kernel (csrc/knn.cu) walks the
ranges with one thread per query and votes in place.  Coordinates are
scaled by the same f32(1/cell), so the radius is 1, as in the Pallas call.

The TPU's 128-aligned DMA windows, their 90th-percentile sizing and the
``overflow_tiles`` re-run guard have nothing to guard here: a query is done
exactly when it found k refs within radius ``cell``.  A round still stops
the escalation when fewer than a quarter of its queries are done.

Bound on the card: the float32 rate on clumped refs (about 10 operations
per candidate ref), memory on sparse ones.
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


class KnnPass(NamedTuple):
    """One pass's problem: scaled, cell-sorted refs and queries."""

    refs: torch.Tensor     # (R, 3) f32, x * f32(1/cell), key-sorted
    labels: torch.Tensor   # (R,) int32 encoded labels, key-sorted
    queries: torch.Tensor  # (Q, 3) f32, x * f32(1/cell), key-sorted
    ranges: torch.Tensor   # (Q, 6) int32 [lo, hi) of cell rows i-1, i, i+1
    q_order: torch.Tensor  # (Q,) int64: sorted row -> input row
    k: int


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
    return KnnPass(
        refs=(ref_pts[order_r, :3] * inv_cell).contiguous(),
        labels=ref_enc[order_r].to(torch.int32).contiguous(),
        queries=(query_pts[order_q, :3] * inv_cell).contiguous(),
        ranges=torch.stack(bounds, 1).to(torch.int32).contiguous(),
        q_order=order_q, k=int(k))


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


def knn_pass(p: KnnPass):
    """(winner, n_found) int32 in sorted query order.  CPU tensors take
    :func:`knn_pass_plain`; CUDA tensors launch the kernel."""
    if not p.queries.is_cuda:
        return knn_pass_plain(p)
    for t, name in ((p.refs, "refs"), (p.queries, "queries")):
        _cuda.require(t, f"knn {name}", torch.float32, 2)
    _cuda.require(p.labels, "knn labels", torch.int32, 1)
    _cuda.require(p.ranges, "knn ranges", torch.int32, 2)
    if not 1 <= p.k <= K_MAX:
        raise ValueError(f"knn: k={p.k} outside 1..{K_MAX}")
    nq = p.queries.shape[0]
    winner = torch.empty(nq, dtype=torch.int32, device=p.queries.device)
    n_found = torch.empty(nq, dtype=torch.int32, device=p.queries.device)
    if nq == 0:
        return winner, n_found
    _cuda.record("knn", problem=p)
    lib = _cuda.library()
    code = lib.tl_knn_vote(
        p.refs.data_ptr(), p.labels.data_ptr(), p.queries.data_ptr(),
        p.ranges.data_ptr(), nq, p.k, winner.data_ptr(), n_found.data_ptr(),
        _cuda.stream_ptr(p.queries))
    _cuda.check(code, "tl_knn_vote")
    _cuda.LAUNCHES["knn"] += 1
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
