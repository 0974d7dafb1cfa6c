"""What the CPU reaches of the redesigned kernels 4 and 5 of
treelearn_tpu_torch: the 3-D cell table of the verticality moments against
the xy table and the JAX kernel (interpret mode), the work items, the
band-form neighbor-cell lookup and the box prune of the eps-graph found bits
against the 25 searches and the unpruned walk, and the zero-padded route of
the 4 -> 32 input conv against the unpadded plain conv.  Inputs from numpy
seeds; tolerances stated per test."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RADIUS = 0.6


def _vert_cloud(kind):
    """(refs, queries) float32.  random: a uniform box 12 m tall; forest:
    ground, tall trunks and crowns, queries a subset; lattice: spacing of
    exactly the radius, so refs sit on the sphere and on cell boundaries;
    single_cell: everything inside one cell; empty_cells: far-apart clumps,
    and queries of which half sit where no ref is; apart: queries that are
    not refs, some outside the refs' bounding box."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":
        refs = rng.uniform(0, [6, 6, 12], (4000, 3))
        queries = refs[rng.choice(len(refs), 1500, replace=False)]
    elif kind == "forest":
        ground = np.column_stack([rng.uniform(0, 8, (2500, 2)),
                                  rng.normal(0, 0.03, 2500)])
        trunks = [np.column_stack([c + rng.normal(0, 0.05, (500, 2)),
                                   rng.uniform(0, 12, 500)])
                  for c in rng.uniform(1, 7, (4, 2))]
        refs = np.vstack([ground] + trunks)
        queries = refs[rng.choice(len(refs), 1800, replace=False)]
    elif kind == "lattice":
        g = np.arange(7, dtype=np.float32) * np.float32(RADIUS)
        refs = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        refs = refs - np.float32(1.2)      # negative coordinates too
        queries = refs
    elif kind == "single_cell":
        refs = rng.uniform(0.05, 0.55, (300, 3))
        queries = refs[:120]
    elif kind == "empty_cells":
        refs = np.vstack([c + rng.normal(0, 0.2, (400, 3))
                          for c in ([0, 0, 0], [9, 0, 3], [0, 9, 30])])
        queries = np.vstack([refs[::5], rng.uniform(2, 7, (200, 3))])
    else:
        refs = rng.uniform(0, 5, (2000, 3))
        queries = rng.uniform(-1.5, 6.5, (900, 3))
    return refs.astype(np.float32), queries.astype(np.float32)


def _unsorted(p, values):
    out = torch.empty_like(values)
    out[p.q_order] = values
    return out


VERT_KINDS = ["random", "forest", "lattice", "single_cell", "empty_cells",
              "apart"]


@pytest.mark.parametrize("kind", VERT_KINDS)
def test_vert_3d_table_matches_xy_table(kind):
    """The z cells hide no in-radius ref: counts equal the xy table's
    exactly, moments within 1e-5 of each column's scale (the same refs summed
    in another order).  The 3-D table offers fewer candidates."""
    from treelearn_tpu_torch.ops import vert

    refs, queries = map(torch.from_numpy, _vert_cloud(kind))
    p3 = vert.prepare(refs, queries, RADIUS)
    p2 = vert.prepare(refs, queries, RADIUS, table="xy")
    assert (p3.table, p2.table) == ("xyz", "xy")
    m3 = _unsorted(p3, vert.moments(p3))
    m2 = _unsorted(p2, vert.moments_plain(p2))
    assert torch.equal(m3[:, 0], m2[:, 0])
    assert float(m3[:, 0].max()) >= 1
    scale = m2.abs().amax(0).clamp(min=1e-12)
    assert float(((m3 - m2).abs() / scale).max()) <= 1e-5
    cand3 = (p3.ranges[:, 1::2] - p3.ranges[:, 0::2]).sum(1)
    cand2 = (p2.ranges[:, 1::2] - p2.ranges[:, 0::2]).sum(1)
    assert int(cand3.max()) <= int(cand2.max())
    # brute force, float64 distances away from the sphere's rounding
    d = (queries[:, None, :].double() - refs[None, :, :].double()).norm(dim=2)
    sure = ((d < RADIUS - 1e-5).sum(1), (d < RADIUS + 1e-5).sum(1))
    assert bool(((m3[:, 0] >= sure[0]) & (m3[:, 0] <= sure[1])).all())


@pytest.mark.parametrize("hair,neighbors", [(-2.0 ** -12, 7), (2.0 ** -12, 1)])
def test_vert_lattice_counts_match_pallas_interpret(hair, neighbors,
                                                    monkeypatch):
    """A lattice whose spacing is a hair inside (outside) the radius puts
    the six axis neighbors just inside (outside) the sphere, one z cell up
    and down, and walks the points across the cell boundaries; the JAX
    kernel has no z cells, so equal counts show the z cells hide nothing.
    Exact.  (At a spacing of exactly the radius the two packages round the
    on-sphere distances differently: the JAX kernel centres coordinates per
    tile.  That lattice is held to the port's own xy table above.)"""
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu_torch.ops.vert import verticality

    monkeypatch.setattr(pv, "_INTERPRET", True)
    g = np.arange(7, dtype=np.float32) * np.float32(RADIUS * (1.0 + hair))
    refs = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    refs = (refs - np.float32(1.2)).astype(np.float32)
    _, cj, over = pv.verticality_banded(refs, refs, RADIUS)
    _, cp = verticality(torch.from_numpy(refs), torch.from_numpy(refs), RADIUS)
    ok = ~np.asarray(over)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(cp.numpy()[ok], np.asarray(cj)[ok])
    assert cp.max() == neighbors   # an inner point and its 6 axis neighbors


@pytest.mark.parametrize("seed", [1, 7])
def test_verticality_tall_forest_matches_pallas_interpret(seed, monkeypatch):
    """As tests/test_torch_port_postproc.py holds verticality() to the
    interpret-mode kernel, on trunks 12 m tall, where the 3-D table prunes
    most of a column: counts equal, |dvert| <= 1e-3 after both round through
    float16 but on a 3e-3 share of ill-conditioned neighborhoods (thin
    trunks: the float32 moments are centred per query here and per 64-query
    tile in the Pallas kernel), where the port stays within 5e-3 of the
    float64 answer."""
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu_torch.ops.vert import verticality

    monkeypatch.setattr(pv, "_INTERPRET", True)
    rng = np.random.default_rng(seed)
    ground = np.column_stack([rng.uniform(0, 10, (2500, 2)),
                              rng.normal(0, 0.03, 2500)])
    trunks = [np.column_stack([c + rng.normal(0, 0.04, (400, 2)),
                               rng.uniform(0, 12, 400)])
              for c in rng.uniform(1, 9, (5, 2))]
    pts = np.vstack([ground] + trunks).astype(np.float32)
    qidx = np.sort(rng.choice(len(pts), int(0.6 * len(pts)), replace=False))
    vj, cj, over = pv.verticality_banded(pts, pts[qidx], RADIUS)
    vp, cp = verticality(torch.from_numpy(pts), torch.from_numpy(pts[qidx]),
                         RADIUS)
    ok = ~np.asarray(over)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(cp.numpy()[ok], np.asarray(cj)[ok])
    has = ok & (np.asarray(cj) >= 3)
    far = has & (np.abs(vp.numpy() - np.asarray(vj)) > 1e-3)
    assert far.sum() <= max(1, int(3e-3 * has.sum()))
    if far.any():
        from test_pallas_vert import _oracle

        ov, _ = _oracle(pts, pts[qidx][far], RADIUS)
        assert (np.abs(vp.numpy()[far] - ov) <= 5e-3).all()


def test_vert_dense_table_limit_falls_back_to_xy(monkeypatch):
    """A bounding box with more cells than the dense table may hold takes
    the xy table, in the same problem form and with the same moments."""
    from treelearn_tpu_torch.ops import vert

    refs, queries = map(torch.from_numpy, _vert_cloud("forest"))
    want = vert.prepare(refs, queries, RADIUS)
    monkeypatch.setattr(vert, "DENSE_CELLS", 1000)
    p = vert.prepare(refs, queries, RADIUS)
    assert p.table == "xy" and p.ranges.shape[1] == 18
    got = _unsorted(p, vert.moments(p))
    ref = _unsorted(want, vert.moments(want))
    assert torch.equal(got[:, 0], ref[:, 0])
    scale = ref.abs().amax(0).clamp(min=1e-12)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5


def test_vert_no_queries_and_no_refs():
    from treelearn_tpu_torch.ops import vert

    refs, queries = map(torch.from_numpy, _vert_cloud("random"))
    p = vert.prepare(refs, queries[:0], RADIUS)
    assert p.items.shape == (0, 4) and vert.moments(p).shape == (0, 10)
    v, c = vert.verticality(refs, queries[:0], RADIUS)
    assert v.shape == (0,) and c.shape == (0,)
    p = vert.prepare(refs[:0], queries, RADIUS)
    assert float(vert.moments(p).abs().max()) == 0.0


def _walk_items_counts(p):
    """In-radius counts by the kernel's own walk in numpy: item by item, the
    group's 9 ranges laid end to end, partition ``part`` of ``32 / qs``
    taking positions part, part + 32 / qs, ..."""
    refs = p.refs4[:, :3].numpy()
    q = p.queries.numpy()
    ranges = p.ranges.numpy()
    counts = np.zeros(len(q), np.int64)
    seen = np.zeros(len(q), np.int64)
    r2 = np.float32(p.r2)
    for q0, n, qs, g in p.items.tolist():
        idx = np.concatenate([np.arange(ranges[g, 2 * b], ranges[g, 2 * b + 1])
                              for b in range(9)])
        parts = 32 // qs
        for lane in range(32):
            ql, part = lane % qs, lane // qs
            if ql >= n:
                continue
            mine = idx[part::parts]
            d = refs[mine] - q[q0 + ql]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            counts[q0 + ql] += int((d2 <= r2).sum())
            seen[q0 + ql] += part == 0
    return counts, seen


@pytest.mark.parametrize("table", ["xyz", "xy"])
@pytest.mark.parametrize("kind", ["random", "forest", "single_cell",
                                  "empty_cells", "apart"])
def test_vert_items_cover_every_query_and_candidate_once(kind, table):
    """The work items cut every group into slices of one group's queries,
    each query in exactly one item, ``qs`` the power of two that holds the
    slice, longest walk first; walking the items as the kernel does (queries
    x candidate partitions) counts every (query, candidate) pair once: the
    counts equal the plain version's.  Skewed (forest, single_cell: slices of
    32 queries; empty_cells, apart: lone queries that split their candidates
    32 ways) and uniform clouds, both tables."""
    from treelearn_tpu_torch.ops import vert

    refs, queries = map(torch.from_numpy, _vert_cloud(kind))
    p = vert.prepare(refs, queries, RADIUS, table=table)
    items = p.items.numpy()
    groups = p.groups.numpy()
    q0, n, qs, g = items.T
    assert ((qs & (qs - 1)) == 0).all() and (qs >= 1).all() and (qs <= 32).all()
    assert (n >= 1).all() and (n <= qs).all()
    assert (q0 >= groups[g]).all() and (q0 + n <= groups[g + 1]).all()
    held = np.minimum(groups[g + 1] - groups[g], 32)
    assert (qs // 2 < held).all() and (held <= qs).all()   # the smallest
    if kind in ("forest", "single_cell"):
        assert int(qs.max()) == 32
    if kind in ("empty_cells", "apart"):
        assert int(qs.min()) == 1
    cand = (p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum(1).numpy()
    steps = cand[g] * qs
    assert (steps[:-1] >= steps[1:]).all()
    counts, seen = _walk_items_counts(p)
    assert (seen == 1).all()
    np.testing.assert_array_equal(counts,
                                  vert.moments_plain(p)[:, 0].numpy())


def _cc_points(kind):
    """random: uniform scatter; clumped: dense clumps sigma 0.05 m far apart
    plus bridges (offset-shifted coordinates under a trained head); edge:
    clumps at both ends of the widest grid the keys allow, so rows end at
    column 29999 and the next row starts at column 0; one_cell; single."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    cell = np.float32(0.15 / np.sqrt(2.0))
    if kind == "random":
        xy = rng.uniform(0, 4, (1500, 2))
    elif kind == "clumped":
        centers = rng.uniform(0, 20, (6, 2))
        xy = np.vstack([c + rng.normal(0, 0.05, (500, 2)) for c in centers]
                       + [centers[0] + [0.4, 0.0] + rng.normal(0, 0.05, (300, 2)),
                          rng.uniform(0, 20, (60, 2))])
    elif kind == "edge":
        far = 29999.5 * float(cell)
        xy = np.vstack([rng.uniform(0, 0.5, (300, 2)),
                        [0.0, far] + rng.uniform(0, 0.5, (300, 2)) * [1, -1]])
    elif kind == "one_cell":
        xy = rng.uniform(0.01, 0.09, (100, 2))
    else:
        xy = np.array([[3.0, 4.0]])
    return xy.astype(np.float32)


CC_KINDS = ["random", "clumped", "edge", "one_cell", "single"]


@pytest.mark.parametrize("kind", CC_KINDS)
def test_cc_band_lookup_equals_the_25_searches(kind):
    """Exact."""
    from treelearn_tpu_torch.ops import cc

    p = cc.prepare(torch.from_numpy(_cc_points(kind)), 0.15)
    want = cc.neighbor_cells_probes(p.cell_keys)
    got = cc.neighbor_cells_banded(p.cell_keys)
    assert torch.equal(got, want)
    own = torch.arange(p.cell_keys.shape[0])
    assert torch.equal(got[:, 12], own)
    if kind == "edge":
        j = p.cell_keys.long() % cc.GRID_WIDTH
        assert int(j.max()) == cc.GRID_WIDTH - 1 and int(j.min()) == 0


def test_cc_band_lookup_at_the_grid_edges():
    """Keys crafted so that a row's last column and the next row's first
    have consecutive keys: neither is the other's neighbor."""
    from treelearn_tpu_torch.ops import cc

    w = cc.GRID_WIDTH
    cells = [(0, 0), (0, 1), (0, w - 2), (0, w - 1), (1, 0), (1, 2),
             (1, w - 1), (2, 0), (3, w - 1), (4, 0), (4, 1), (6, 5)]
    keys = torch.tensor(sorted(i * w + j for i, j in cells), dtype=torch.int32)
    want = cc.neighbor_cells_probes(keys)
    assert torch.equal(cc.neighbor_cells_banded(keys), want)
    at = {c: n for n, c in enumerate(sorted(cells))}
    assert int(want[at[(0, w - 1)], 3 * 5 + 3]) == -1     # (1, w): off grid
    assert int(want[at[(0, w - 1)], 3 * 5 + 2]) == at[(1, w - 1)]
    assert int(want[at[(1, 0)], 1 * 5 + 1]) == -1         # (0, -1): off grid
    assert int(want[at[(1, 0)], 1 * 5 + 3]) == at[(0, 1)]


@pytest.mark.parametrize("kind", CC_KINDS)
def test_cc_items_hold_every_point_once(kind):
    from treelearn_tpu_torch.ops import cc

    p = cc.prepare(torch.from_numpy(_cc_points(kind)), 0.15)
    cell, first, rows = p.items.numpy().T
    cs = p.cell_start.numpy()
    assert (rows >= 1).all() and (rows <= 32).all()
    assert (first >= cs[cell]).all() and (first + rows <= cs[cell + 1]).all()
    seen = np.zeros(p.pts.shape[0], np.int64)
    for f, r in zip(first, rows):
        seen[f:f + r] += 1
    assert (seen == 1).all()
    # the boxes hold their cells' points, tightly
    box = p.cell_box.numpy()
    pts = p.pts.numpy()
    for c in range(len(cs) - 1):
        sl = pts[cs[c]:cs[c + 1]]
        np.testing.assert_array_equal(
            box[c], np.concatenate([sl.min(0), sl.max(0)]))


@pytest.mark.parametrize("seed", range(6))
def test_cc_box_prune_never_rejects_a_hit(seed):
    """Seeded sweep with partners placed on the eps circle (the rounded
    distance falls on either side of eps) and in cells two away: wherever
    the unpruned walk finds a point within eps the box test lets the walk
    happen, and the kernel's route (band lookup, box prune, own bit without a
    walk) gives the same bits as the 25 searches and full walks.  Exact."""
    from treelearn_tpu_torch.ops import cc

    rng = np.random.default_rng(seed)
    eps = 0.15
    base = np.vstack([rng.uniform(0, 3, (400, 2)),
                      rng.uniform(0, 3, (1, 2)) + rng.normal(0, 0.04, (300, 2))])
    theta = rng.uniform(0, 2 * np.pi, len(base))
    ring = base + eps * np.column_stack([np.cos(theta), np.sin(theta)])
    xy = np.vstack([base, ring]).astype(np.float32)
    p = cc.prepare(torch.from_numpy(xy), eps)
    want = cc.found_bits_plain(p)
    nbr = cc.neighbor_cells_banded(p.cell_keys)
    skip = cc.box_rejects(p, nbr)
    found = ((want[:, None] >> torch.arange(25)[None, :]) & 1).bool()
    assert not bool((skip & found).any())
    assert int(skip.sum()) > 0                # the prune does prune
    assert bool(found[:, 12].all())
    assert torch.equal(cc.found_bits_plain(p, banded=True), want)
    # on the circle: both outcomes occur among the ring partners
    d = torch.from_numpy(xy[:len(base)] - xy[len(base):])
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    inside = d2 <= torch.tensor(p.eps2)
    assert 0 < int(inside.sum()) < len(base)


@pytest.mark.parametrize("eps", [0.15, 1.5])
@pytest.mark.parametrize("seed", range(3))
def test_cc_box_accept_and_first_walk_are_exact(seed, eps):
    """The CPU route's shortcuts (``found_bits_plain(p, banded=True)``):
    where ``box_accepts`` holds, every point of the neighbor cell lies
    within eps by the computed distance; with them and the first walk of
    ``PROBE`` points the bits equal the unpruned walk's, on dense cells of
    far more than ``PROBE`` points and at a coarse eps, where most neighbor
    cells are accepted whole.  Exact."""
    from treelearn_tpu_torch.ops import cc

    rng = np.random.default_rng(seed)
    xy = np.vstack([rng.uniform(0, 6, (500, 2)),
                    rng.uniform(0, 6, (1, 2)) + rng.normal(0, 0.05, (400, 2)),
                    rng.uniform(0, 6, (1, 2)) + rng.normal(0, 0.3, (400, 2))]
                   ).astype(np.float32)
    p = cc.prepare(torch.from_numpy(xy), eps)
    nbr = cc.neighbor_cells_banded(p.cell_keys)
    acc = cc.box_accepts(p, nbr)
    assert int(acc.sum()) > 0
    cs = p.cell_start.long()
    q, bit = torch.nonzero(acc, as_tuple=True)
    c = nbr[cc._cell_rows(p)[q], bit]
    span = cs[c + 1] - cs[c]
    assert int(span.max()) > cc.PROBE
    offs = torch.arange(int(span.max()))
    m = offs[None, :] < span[:, None]
    idx = torch.where(m, cs[c][:, None] + offs[None, :], 0)
    dx = p.pts[idx, 0] - p.pts[q][:, 0:1]
    dy = p.pts[idx, 1] - p.pts[q][:, 1:2]
    assert bool(((dx * dx + dy * dy <= torch.tensor(p.eps2)) | ~m).all())
    assert torch.equal(cc.found_bits_plain(p, banded=True),
                       cc.found_bits_plain(p))


@pytest.mark.parametrize("kind", ["clumped", "random"])
def test_cc_labels_match_pallas_interpret(kind, monkeypatch):
    """cc_labels on the clumped input equals the interpret-mode banded
    kernel's labels exactly (the minimum-input-index contract), by the plain
    route and by the kernel's own route in PyTorch."""
    import treelearn_tpu.ops.pallas_cc as pcc
    from treelearn_tpu_torch.ops import cc

    monkeypatch.setattr(pcc, "_INTERPRET", True)
    xy = _cc_points(kind)
    want = pcc.cc_labels_banded(xy, eps=0.15)
    np.testing.assert_array_equal(cc.cc_labels(torch.from_numpy(xy), 0.15),
                                  want)
    p = cc.prepare(torch.from_numpy(xy), 0.15)
    got = cc.components_from_bits(
        cc.found_bits_plain(p, banded=True).numpy(), p.skeys.numpy(),
        p.order.numpy())
    np.testing.assert_array_equal(got, want)
    if kind == "clumped":
        sizes = np.bincount(np.unique(want, return_inverse=True)[1])
        assert (sizes >= 300).sum() >= 5      # the clumps are components


@pytest.mark.parametrize("cin,cout,v,dtype,pad", [
    (4, 32, 420575, torch.bfloat16, 28), (4, 32, 57993, torch.bfloat16, 28),
    (4, 32, 100, torch.bfloat16, 28), (4, 32, 420575, torch.float32, 4),
    (32, 32, 420575, torch.bfloat16, 0), (4, 24, 420575, torch.bfloat16, 28),
    (16, 64, 100000, torch.bfloat16, 0), (48, 32, 100000, torch.bfloat16, 0)])
def test_tensor_core_pad_routes(cin, cout, v, dtype, pad):
    """Only a Cin that is no multiple of 8 is padded, at any row count and
    any Cout: in bf16 a Cin below 32 to 32 channels, onto the wgmma plans
    (16 channels need none: the kernel's 16-channel tail slice reads them);
    in float32 to 8 channels, onto the 3xTF32 plans."""
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, dw_plan,
                                                   tensor_core_pad)

    assert tensor_core_pad(cin, cout, v, dtype) == pad
    if pad:
        route = "tf32x3" if dtype == torch.float32 else "wgmma"
        assert conv_plan(cin + pad, cout, v, dtype).route == route
        assert dw_plan(cin + pad, cout, v, dtype).route == route
        assert conv_plan(cin, cout, v, dtype).route == "plain"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_padded_input_conv_equals_unpadded(dtype, tol):
    """Zero channels add exactly: the plain conv and the plain weight
    gradient of the zero-padded 4 -> 32 input conv equal the unpadded ones
    within the order of the float32 sums (1e-6 of the max in float32; the
    bf16 output's one rounding, the kernels' gate of 2e-2, in bf16), and the
    padded rows of dW are zero."""
    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv, subm_conv_dw

    rng = np.random.default_rng(4)
    v = 700
    x = torch.from_numpy(rng.normal(size=(v, 4)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(27, 4, 32)).astype(np.float32)
                         * 0.1).to(dtype)
    g = torch.from_numpy(rng.normal(size=(v, 32)).astype(np.float32)).to(dtype)
    rule = torch.from_numpy(rng.integers(0, v, (27, v)).astype(np.int32))
    rule[torch.from_numpy(rng.random((27, v)) > 0.4)] = -1
    xp, wp = F.pad(x, (0, 28)), F.pad(w, (0, 0, 0, 28))
    assert xp.shape == (v, 32) and wp.shape == (27, 32, 32)
    assert torch.equal(wp[:, :4], w) and float(wp[:, 4:].abs().max()) == 0
    want = subm_conv(x, w, rule).float()
    got = subm_conv(xp, wp, rule).float()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    dw = subm_conv_dw(x, g, rule)
    dwp = subm_conv_dw(xp, g, rule)
    assert float(dwp[:, 4:].abs().max()) == 0
    assert float((dwp[:, :4] - dw).abs().max()) <= 1e-6 * float(dw.abs().max())


def test_cpu_wrappers_take_the_plain_versions(monkeypatch):
    """On CPU tensors neither wrapper reaches the kernel library and no
    launch is counted."""
    from treelearn_tpu_torch.ops import _cuda, cc, vert

    def no_library():
        raise AssertionError("the CPU route must not build the kernels")

    monkeypatch.setattr(_cuda, "library", no_library)
    before = dict(_cuda.LAUNCHES)
    refs, queries = map(torch.from_numpy, _vert_cloud("forest"))
    p = vert.prepare(refs, queries, RADIUS)
    assert torch.equal(vert.moments(p), vert.moments_plain(p))
    pc = cc.prepare(torch.from_numpy(_cc_points("clumped")), 0.15)
    assert torch.equal(cc.found_bits(pc), cc.found_bits_plain(pc))
    assert _cuda.LAUNCHES == before
