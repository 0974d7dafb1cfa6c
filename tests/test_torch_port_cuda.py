"""Each CUDA kernel of treelearn_tpu_torch against its plain PyTorch version
on the card.  Marked ``gpu``; each test skips (inside the test, through the
``cuda`` fixture) where no card is present.  On the card:

    python -m pytest -m gpu tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid(device, seed=0, n=5000, ss=(40, 40, 30), batch=2):
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys

    rng = np.random.default_rng(seed)
    space = int(np.prod(ss))
    keys = np.unique(np.concatenate([
        b * space + rng.choice(space, n, replace=False) for b in range(batch)]))
    return grid_from_sorted_keys(
        torch.from_numpy(keys.astype(np.int32)).to(device), ss)


def _launched(before):
    """Kernel launches counted since ``before`` (a copy of LAUNCHES), the
    kernels that launched nothing left out."""
    from treelearn_tpu_torch.ops import _cuda

    return {n: c - before[n] for n, c in _cuda.LAUNCHES.items()
            if c != before[n]}


def test_rulebook_kernel_exact(cuda):
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import build_subm_rulebook

    g = _grid(cuda)
    before = _cuda.LAUNCHES["rulebook"]
    got = subm_rulebook(g)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["rulebook"] == before + 1
    assert torch.equal(got, build_subm_rulebook(g, 3))


@pytest.mark.parametrize("keys,ss", [
    ([13], (3, 3, 3)),                       # V = 1
    ([13, 14], (3, 3, 3)),                   # V = 2, z neighbors
    ([2, 3], (3, 3, 3)),                     # (0,0,2) and (0,1,0): no wrap
    # two batch elements: last x row of element 0, first of element 1
    ([18, 22, 26, 27, 31, 35], (3, 3, 3)),
    (list(range(27)), (3, 3, 3)),            # dense block
])
def test_band_rulebook_kernel_small_cases(cuda, keys, ss):
    """The band-form kernel and both plain versions give the same rule,
    exactly."""
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import (build_subm_rulebook,
                                                build_subm_rulebook_banded,
                                                grid_from_sorted_keys)

    g = grid_from_sorted_keys(
        torch.tensor(keys, dtype=torch.int32, device=cuda), ss)
    want = build_subm_rulebook(g, 3)
    assert torch.equal(subm_rulebook(g), want)
    assert torch.equal(build_subm_rulebook_banded(g), want)


def test_band_rulebook_kernel_two_element_batch(cuda):
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import build_subm_rulebook

    for seed, n, ss in ((5, 3000, (12, 10, 8)), (6, 400, (12, 10, 8)),
                        (7, 60000, (64, 64, 48))):
        g = _grid(cuda, seed=seed, n=min(n, int(np.prod(ss)) // 2), ss=ss)
        assert torch.equal(subm_rulebook(g), build_subm_rulebook(g, 3))


@pytest.mark.parametrize("dtype,cin,cout", [
    (torch.float32, 4, 32), (torch.float32, 64, 32), (torch.float32, 96, 96),
    (torch.bfloat16, 32, 32), (torch.bfloat16, 448, 224)])
def test_subm_conv_kernel_matches_plain(cuda, dtype, cin, cout):
    """f32: rtol 1e-4 (summation order); bf16: 2e-2 of the output's max
    magnitude (summation order before the final bf16 rounding)."""
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    g = _grid(cuda, seed=1)
    rule = subm_rulebook(g)
    gen = torch.Generator(device="cpu").manual_seed(0)
    v = g.n_active
    x = torch.randn(v, cin, generator=gen).to(cuda, dtype)
    w = (torch.randn(27, cin, cout, generator=gen) * 0.1).to(cuda, dtype)
    got = subm_conv(x, w, rule).float()
    want = plain(x, w, rule).float()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float((got - want).abs().max()) <= 2e-2 * scale
    part = subm_conv(x, w, rule, n_live=v // 2)
    assert (part[v // 2:] == 0).all()


def _random_rule(gen, v_in, v_out, present):
    """(27, v_out) int32 rule with a ``present`` share of random inputs; the
    conv kernels take any rule, not only a submanifold one."""
    rule = torch.randint(0, v_in, (27, v_out), generator=gen,
                         dtype=torch.int32)
    rule[torch.rand(27, v_out, generator=gen) > present] = -1
    return rule


@pytest.mark.parametrize("v", [1, 63, 128, 136, 1000, 8300, 70000])
@pytest.mark.parametrize("cin,cout", [
    (32, 32), (32, 64), (64, 32), (96, 96), (224, 224), (384, 192),
    (192, 384)])
def test_subm_conv_wgmma_matches_plain(cuda, cin, cout, v):
    """The tensor-core route against the plain conv: 2e-2 of the output's
    max magnitude (float32 sums of the same bf16 products in another order,
    before the final bf16 rounding).  V covers a lone row, ragged tiles, the
    small-level plan (64 x 32 blocks, 8 producer warps), whole-Cout blocks
    (V = 8300: one wave with 8 producer warps at one split, 4 otherwise) and
    the 128-row plan of 32-channel convs (V = 70000);
    n_live < V zeroes the tail; two launches give the same bits."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import conv_plan, subm_conv

    assert conv_plan(cin, cout, v).route == "wgmma"
    gen = torch.Generator(device="cpu").manual_seed(cin * 7 + cout + v)
    v_in = v + 5
    x = torch.randn(v_in, cin, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(27, cin, cout, generator=gen) * 0.1).to(
        cuda, torch.bfloat16)
    rule = _random_rule(gen, v_in, v, 0.4).to(cuda)
    before = dict(_cuda.LAUNCHES)
    got = subm_conv(x, w, rule)
    again = subm_conv(x, w, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_wgmma": 2}
    assert torch.equal(got, again)
    want = plain(x, w, rule).float()
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2e-2 * scale
    n_live = v // 2
    part = subm_conv(x, w, rule, n_live=n_live).float()
    assert (part[n_live:] == 0).all()
    if n_live:
        assert float((part[:n_live] - want[:n_live]).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("v", [136, 8300])
def test_subm_conv_wgmma_sparse_rules(cuda, v):
    """An all -1 rule gives zeros; a rule whose tiles lack most offsets (two
    offsets present, and one lone entry of a third) matches the plain
    conv."""
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    gen = torch.Generator(device="cpu").manual_seed(v)
    x = torch.randn(v, 64, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(27, 64, 96, generator=gen) * 0.1).to(cuda, torch.bfloat16)
    rule = torch.full((27, v), -1, dtype=torch.int32)
    assert (subm_conv(x, w, rule.to(cuda)) == 0).all()
    rule[[3, 13]] = _random_rule(gen, v, v, 0.7)[[3, 13]]
    rule[26, v - 1] = 0
    rule = rule.to(cuda)
    got = subm_conv(x, w, rule).float()
    want = plain(x, w, rule).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("cin,cout,bn", [
    (32, 64, 64), (64, 32, 32), (224, 224, 32), (192, 384, 192)])
def test_pack_weight_kernel_matches_plain(cuda, cin, cout, bn):
    """The pack kernel writes the same images as the torch pack, straight
    and mirrored (a copy: exact)."""
    from treelearn_tpu_torch.ops.subm_conv import mirrored, pack_weight

    gen = torch.Generator(device="cpu").manual_seed(cin + cout)
    w = torch.randn(27, cin, cout, generator=gen).to(torch.bfloat16)
    assert torch.equal(pack_weight(w.to(cuda), bn).cpu(), pack_weight(w, bn))
    bn_m = bn if cin % bn == 0 else 32
    assert torch.equal(pack_weight(w.to(cuda), bn_m, mirror=True).cpu(),
                       pack_weight(mirrored(w), bn_m))


def test_subm_conv_wrapper_checks(cuda):
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    x = torch.zeros(10, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        subm_conv(x, torch.zeros(27, 4, 8, device=cuda),
                  torch.zeros(27, 10, dtype=torch.int32, device=cuda))


def _cloud(seed=0):
    rng = np.random.default_rng(seed)
    ground = np.column_stack([rng.uniform(0, 20, 20000),
                              rng.uniform(0, 20, 20000),
                              rng.normal(0, 0.03, 20000)])
    trunks = [np.column_stack([c[0] + rng.normal(0, 0.05, 2000),
                               c[1] + rng.normal(0, 0.05, 2000),
                               rng.uniform(0, 8, 2000)])
              for c in rng.uniform(2, 18, (10, 2))]
    return np.vstack([ground] + trunks).astype(np.float32)


def test_vert_kernel_matches_plain(cuda):
    from treelearn_tpu_torch.ops import vert

    pts = torch.from_numpy(_cloud()).to(cuda)
    p = vert.prepare(pts, pts[::3].contiguous(), 0.6)
    m = vert.moments(p)
    mp = vert.moments_plain(p)
    assert torch.equal(m[:, 0], mp[:, 0])
    scale = mp.abs().amax(0).clamp(min=1e-12)
    assert float(((m - mp).abs() / scale).max()) <= 1e-4


@pytest.mark.parametrize("table", ["xyz", "xy"])
@pytest.mark.parametrize("kind", ["random", "forest", "lattice", "single_cell",
                                  "empty_cells", "apart", "cloud"])
def test_vert_group_kernel_matches_plain(cuda, kind, table):
    """The cell-group kernel on both tables against its plain version:
    counts exact (the same rounded distance test), moments within 1e-4 of
    each column's scale (float32 sums in another order); two launches give
    the same bits."""
    from test_torch_port_redesign3 import _vert_cloud

    from treelearn_tpu_torch.ops import _cuda, vert

    if kind == "cloud":
        refs = torch.from_numpy(_cloud(2)).to(cuda)
        queries = refs[::3].contiguous()
    else:
        refs, queries = (torch.from_numpy(a).to(cuda)
                         for a in _vert_cloud(kind))
    p = vert.prepare(refs, queries, 0.6, table=table)
    before = _cuda.LAUNCHES["vert"]
    m = vert.moments(p)
    again = vert.moments(p)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["vert"] == before + 2
    assert torch.equal(m, again)
    mp = vert.moments_plain(p)
    assert torch.equal(m[:, 0], mp[:, 0])
    scale = mp.abs().amax(0).clamp(min=1e-12)
    assert float(((m - mp).abs() / scale).max()) <= 1e-4


def test_vert_group_kernel_lone_queries_split_their_candidates(cuda):
    """A few hundred queries over a dense cloud: groups of one or two
    queries, whose candidates the warp's other lanes share 32 or 16 ways;
    same gates."""
    from treelearn_tpu_torch.ops import vert

    pts = torch.from_numpy(_cloud(3)).to(cuda)
    p = vert.prepare(pts, pts[::150].contiguous(), 0.6)
    assert int(p.items[:, 2].min()) == 1 and int(p.items[:, 2].max()) <= 8
    m = vert.moments(p)
    mp = vert.moments_plain(p)
    assert torch.equal(m[:, 0], mp[:, 0])
    scale = mp.abs().amax(0).clamp(min=1e-12)
    assert float(((m - mp).abs() / scale).max()) <= 1e-4


def test_cc_kernel_matches_plain(cuda):
    from treelearn_tpu_torch.ops import cc

    xy = torch.from_numpy(_cloud(1)[:, :2].copy()).to(cuda)
    p = cc.prepare(xy, 0.15)
    assert torch.equal(cc.found_bits(p), cc.found_bits_plain(p))
    labels = cc.cc_labels(xy, 0.15)
    assert np.array_equal(labels, cc.cc_labels(xy.cpu(), 0.15))


@pytest.mark.parametrize("kind", ["random", "clumped", "edge", "one_cell",
                                  "single", "ring", "dense"])
def test_cc_cell_kernel_matches_plain(cuda, kind):
    """The cell-group kernel against the plain found bits (25 searches, full
    walks) and its own route in PyTorch (band lookup, box prune): exact.
    ring: partners on the eps circle; dense: clumps of thousands of points a
    cell, sigma 0.05 m."""
    from test_torch_port_redesign3 import _cc_points

    from treelearn_tpu_torch.ops import _cuda, cc

    rng = np.random.default_rng(11)
    if kind == "ring":
        base = rng.uniform(0, 3, (3000, 2))
        theta = rng.uniform(0, 2 * np.pi, len(base))
        xy = np.vstack([base, base + 0.15 * np.column_stack(
            [np.cos(theta), np.sin(theta)])]).astype(np.float32)
    elif kind == "dense":
        xy = np.vstack([c + rng.normal(0, 0.05, (8000, 2))
                        for c in rng.uniform(0, 30, (8, 2))]
                       ).astype(np.float32)
    else:
        xy = _cc_points(kind)
    p = cc.prepare(torch.from_numpy(xy).to(cuda), 0.15)
    before = _cuda.LAUNCHES["cc"]
    got = cc.found_bits(p)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["cc"] == before + 1
    want = cc.found_bits_plain(p)
    assert torch.equal(got, want)
    assert torch.equal(cc.found_bits_plain(p, banded=True), want)
    assert torch.equal(cc.neighbor_cells_banded(p.cell_keys),
                       cc.neighbor_cells_probes(p.cell_keys))


@pytest.mark.parametrize("v", [100, 9000, 70000])
def test_input_conv_padded_route_matches_plain(cuda, v):
    """The bf16 4 -> 32 input conv and its weight gradient, zero-padded to
    32 input channels onto the tensor-core routes at any row count, within
    the bf16 gates of the unpadded plain versions (2e-2 of max |out|, 1e-3
    of max |dW|)."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import subm_conv, subm_conv_dw

    gen = torch.Generator(device="cpu").manual_seed(v)
    x = torch.randn(v, 4, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(27, 4, 32, generator=gen) * 0.1).to(cuda, torch.bfloat16)
    g = torch.randn(v, 32, generator=gen).to(cuda, torch.bfloat16)
    rule = _random_rule(gen, v, v, 0.4).to(cuda)
    before = dict(_cuda.LAUNCHES)
    out = subm_conv(x, w, rule)
    dw = subm_conv_dw(x, g, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_wgmma": 1, "subm_conv_dw_wgmma": 1}
    want = plain(x, w, rule).float()
    assert out.shape == (v, 32) and dw.shape == (27, 4, 32)
    assert float((out.float() - want).abs().max()) <= 2e-2 * float(
        want.abs().max())
    want_dw = plain_dw(x, g, rule)
    assert float((dw - want_dw).abs().max()) <= 1e-3 * float(
        want_dw.abs().max())


def _knn_problem(device, seed=0, nr=40000, nq=20000, cell=0.5):
    from treelearn_tpu_torch.ops.knn import prepare_pass

    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 30, (40, 3)) * np.array([1, 1, 0.3])
    refs = np.concatenate([c + rng.normal(0, 0.6, (nr // 40, 3))
                           for c in centers]).astype(np.float32)
    labels = np.repeat(np.arange(1, 41), nr // 40)
    queries = (rng.uniform(0, 30, (nq, 3))
               * np.array([1, 1, 0.3])).astype(np.float32)
    return prepare_pass(torch.from_numpy(refs).to(device),
                        torch.from_numpy(labels).to(device),
                        torch.from_numpy(queries).to(device), cell, 5)


def test_knn_kernel_matches_plain(cuda):
    """Winners and found counts exact (same rounding of d2, same tie
    order)."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.knn import knn_pass, knn_pass_plain

    p = _knn_problem(cuda)
    before = _cuda.LAUNCHES["knn"]
    w, f = knn_pass(p)
    wp, fp = knn_pass_plain(p)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["knn"] == before + 1
    assert torch.equal(f, fp)
    assert torch.equal(w, wp)
    assert 0 < int((f == 5).sum()) < f.numel()


def _knn_case(device, kind, k):
    """clumped: 40 dense clumps, cells of up to thousands of candidates
    (many partitions a block); coarse: the same refs under a cell so coarse
    that few groups hold everything (the late rounds); sparse: uniform refs,
    some queries find fewer than k; ties: coordinates on a 0.25 grid with
    every third ref a duplicate, so equal distances abound; lone: groups of
    one query."""
    from treelearn_tpu_torch.ops.knn import prepare_pass

    rng = np.random.default_rng(len(kind) + k)
    if kind in ("clumped", "coarse"):
        centers = rng.uniform(0, 30, (40, 3)) * np.array([1, 1, 0.3])
        refs = np.concatenate([c + rng.normal(0, 0.4, (1500, 3))
                               for c in centers])
        queries = np.concatenate([
            refs[rng.choice(len(refs), 6000)] + rng.normal(0, 0.3, (6000, 3)),
            rng.uniform(0, 30, (3000, 3)) * np.array([1, 1, 0.3])])
        cell = 0.5 if kind == "clumped" else 9.0
    elif kind == "sparse":
        refs = rng.uniform(0, 40, (3000, 3))
        queries = rng.uniform(0, 40, (5000, 3))
        cell = 1.5
    elif kind == "ties":
        refs = np.round(rng.uniform(0, 6, (20000, 3)) * 4) / 4
        refs[::3] = refs[1::3][:len(refs[::3])]
        queries = np.round(rng.uniform(0, 6, (4000, 3)) * 4) / 4
        cell = 1.0
    else:
        refs = rng.uniform(0, 30, (50000, 3)) * np.array([1, 1, 0.1])
        queries = rng.uniform(0, 30, (300, 3)) * np.array([1, 1, 0.1])
        cell = 0.7
    labels = rng.integers(1, 30, len(refs))
    return prepare_pass(torch.from_numpy(refs.astype(np.float32)).to(device),
                        torch.from_numpy(labels).to(device),
                        torch.from_numpy(queries.astype(np.float32)).to(device),
                        cell, k)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", ["clumped", "coarse", "sparse", "ties",
                                  "lone"])
def test_knn_group_kernel_exact(cuda, kind, k):
    """The cooperative kernel against the plain pass and its own plain twin,
    exactly."""
    from treelearn_tpu_torch.ops.knn import (knn_pass, knn_pass_grouped_plain,
                                             knn_pass_plain)

    p = _knn_case(cuda, kind, k)
    qs = p.items[:, 2]
    assert int(p.items[:, 1].sum()) == p.queries.shape[0]
    if kind == "coarse":
        assert int(qs.min()) < 256      # candidates are split among warps
    w, f = knn_pass(p)
    wp, fp = knn_pass_plain(p)
    torch.cuda.synchronize()
    assert torch.equal(f, fp)
    assert torch.equal(w, wp)
    if kind == "sparse":
        assert int((f < k).sum()) > 0
    if kind in ("sparse", "ties"):
        wt, ft = knn_pass_grouped_plain(p)
        assert torch.equal(ft, f) and torch.equal(wt, w)


def test_knn_classify_banded_route_on_card(cuda, monkeypatch):
    """The public route on the card against the exact host KD-tree vote
    (ties aside: 1e-3 share)."""
    from treelearn_tpu_torch.ops import cluster as pc

    monkeypatch.setenv("TL_KNN_SMALL_REFS", "1000")
    rng = np.random.default_rng(1)
    refs = rng.uniform(0, 20, (30000, 3)).astype(np.float32)
    labels = rng.integers(0, 50, 30000)
    queries = rng.uniform(0, 20, (10000, 3)).astype(np.float32)
    del pc.KNN_LOG[:]
    got = pc.knn_classify(refs, labels, queries, k=5, device=cuda)
    assert pc.KNN_LOG[0].route == "banded"
    want = pc.vote(labels[pc.kdtree_knn(refs, queries, 5)])
    assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("dtype,cin,cout", [
    (torch.float32, 4, 32), (torch.float32, 96, 64),
    (torch.bfloat16, 32, 32), (torch.bfloat16, 224, 224)])
def test_subm_conv_dw_kernel_matches_plain(cuda, dtype, cin, cout):
    """f32: rtol 1e-4 of max |dW| (summation order); bf16 inputs: 1e-3 of
    max |dW| (float32 sums of the same bf16 products, in another order).
    Two launches give the same bits (no atomics).  float32 takes the 3xTF32
    kernel (the 4 -> 32 input conv's x padded to 8 channels), bf16 at these
    widths the bf16 tensor-core one."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import (dw_plan, subm_conv_dw,
                                                   tensor_core_pad)

    g_ = _grid(cuda, seed=2)
    rule = subm_rulebook(g_)
    gen = torch.Generator(device="cpu").manual_seed(1)
    v = g_.n_active
    x = torch.randn(v, cin, generator=gen).to(cuda, dtype)
    g = torch.randn(v, cout, generator=gen).to(cuda, dtype)
    pad = tensor_core_pad(cin, cout, v, dtype)
    route = dw_plan(cin + pad, cout, v, dtype).route
    assert route == ("tf32x3" if dtype == torch.float32 else "wgmma")
    name = {"tf32x3": "subm_conv_dw_tf32", "wgmma": "subm_conv_dw_wgmma"}[route]
    before = _cuda.LAUNCHES[name]
    got = subm_conv_dw(x, g, rule)
    again = subm_conv_dw(x, g, rule)
    want = plain(x, g, rule)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert float((got - want).abs().max()) <= tol * scale


DW_VS = [1, 15, 16, 17, 63, 1000, 58000]


@pytest.mark.parametrize("v", DW_VS)
@pytest.mark.parametrize("cin,cout", [
    (32, 32), (32, 64), (64, 32), (224, 224), (448, 224), (192, 384)])
def test_subm_conv_dw_wgmma_matches_plain(cuda, cin, cout, v):
    """The tensor-core dW against the plain dW: 1e-3 of max |dW| (float32
    sums of the same bf16 products in another order).  32 -> 64 / 64 -> 32
    guard the transposed operands, 192 -> 384 the Cout split, 32 -> 32 and
    224 -> 224 the slab pairs that straddle two offsets; V covers a lone
    row, ragged K steps and slots, and several chunks.  Two launches give
    the same bits."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import dw_plan, subm_conv_dw

    assert dw_plan(cin, cout, v).route == "wgmma"
    gen = torch.Generator(device="cpu").manual_seed(cin * 7 + cout + v)
    v_in = v + 5
    x = torch.randn(v_in, cin, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(v, cout, generator=gen).to(cuda, torch.bfloat16)
    rule = _random_rule(gen, v_in, v, 0.4).to(cuda)
    x = x[:v].contiguous()
    rule = torch.where(rule >= v, -1, rule)
    before = dict(_cuda.LAUNCHES)
    got = subm_conv_dw(x, g, rule)
    again = subm_conv_dw(x, g, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_dw_wgmma": 2}
    assert torch.equal(got, again)
    want = plain(x, g, rule)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("v", [136, 8300])
def test_subm_conv_dw_wgmma_sparse_rules(cuda, v):
    """An all -1 rule gives zeros; a rule most of whose K steps are empty
    (two offsets present on a stretch of rows, one lone entry of a third)
    matches the plain dW, the absent offsets' slices exactly zero."""
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import subm_conv_dw

    gen = torch.Generator(device="cpu").manual_seed(v)
    x = torch.randn(v, 64, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(v, 96, generator=gen).to(cuda, torch.bfloat16)
    rule = torch.full((27, v), -1, dtype=torch.int32)
    assert (subm_conv_dw(x, g, rule.to(cuda)) == 0).all()
    lo, hi = v // 3, v // 3 + 40
    rule[[3, 13], lo:hi] = _random_rule(gen, v, v, 0.7)[[3, 13], lo:hi]
    rule[26, v - 1] = 0
    rule = rule.to(cuda)
    got = subm_conv_dw(x, g, rule)
    want = plain(x, g, rule)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert (got[[0, 1, 2, 4, 12, 14, 25]] == 0).all()


def test_subm_conv_fn_grads_match_plain_autograd(cuda):
    """SubmConvFn's dx (kernel 2, mirrored weights) and dW (kernel 3)
    against autograd through the plain conv, float32: 1e-4 of the max."""
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import SubmConvFn

    g_ = _grid(cuda, seed=3)
    rule = subm_rulebook(g_)
    gen = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(g_.n_active, 16, generator=gen).to(cuda)
    w = (torch.randn(27, 16, 24, generator=gen) * 0.1).to(cuda)
    cot = torch.randn(g_.n_active, 24, generator=gen).to(cuda)
    grads = []
    for fn in (SubmConvFn.apply, plain):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        (fn(xx, ww, rule) * cot).sum().backward()
        grads.append((xx.grad, ww.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 32), (192, 384)])
def test_subm_conv_fn_bf16_grads_through_wgmma(cuda, cin, cout):
    """bf16 SubmConvFn: forward and dx go through the tensor-core route (dx
    with Cin and Cout swapped), dW through kernel 3's tensor-core route.
    Each against its plain
    version in the working type on the same bf16 values: dx = the plain conv
    of the cotangent with the mirrored weights, 2e-2 of max |dx| (one bf16
    rounding of float32 sums in another order); dW = the plain weight
    gradient, 1e-3 of max |dW|.  (That dx is the mirrored conv at all is
    the float32 test above; autograd through the plain conv in bf16 adds the
    offsets' parts in bf16 and is no reference.)"""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import SubmConvFn, mirrored

    g_ = _grid(cuda, seed=4)
    rule = subm_rulebook(g_)
    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(g_.n_active, cin, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(27, cin, cout, generator=gen) * 0.1).to(cuda)
    cot = torch.randn(g_.n_active, cout, generator=gen).to(cuda,
                                                           torch.bfloat16)
    before = dict(_cuda.LAUNCHES)
    xx = x.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    out = SubmConvFn.apply(xx, ww, rule)
    out.backward(cot)
    assert _cuda.LAUNCHES["subm_conv_wgmma"] == before["subm_conv_wgmma"] + 2
    assert (_cuda.LAUNCHES["subm_conv_dw_wgmma"]
            == before["subm_conv_dw_wgmma"] + 1)
    w16 = w.to(torch.bfloat16)
    want_out = plain(x, w16, rule).float()
    assert float((out.float() - want_out).abs().max()) <= 2e-2 * float(
        want_out.abs().max())
    want_dx = plain(cot, mirrored(w16), rule).float()
    assert xx.grad.dtype == torch.bfloat16
    assert float((xx.grad.float() - want_dx).abs().max()) <= 2e-2 * float(
        want_dx.abs().max())
    want_dw = plain_dw(x, cot, rule)
    assert ww.grad.dtype == torch.float32
    assert float((ww.grad - want_dw).abs().max()) <= 1e-3 * float(
        want_dw.abs().max())


def test_hdbscan_ladder_rows_card_equal_cpu(cuda, monkeypatch):
    """The eps-ladder's (L, N) rows on a 20k-point knot layout: kernel 5 on
    the card, the plain version on the CPU, equal rows; every level with
    active points launches the kernel once."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.hdbscan import (_ladder, _level_components,
                                                 kth_neighbor_d2)
    from treelearn_tpu_torch.utils.smoke import knot_layout

    pts = knot_layout(9)
    core_d = np.sqrt(kth_neighbor_d2(pts, 50))
    eps_levels = _ladder(core_d, 32)
    before = _cuda.LAUNCHES["cc"]
    log = {}
    card = _level_components(pts, core_d, eps_levels, device=cuda, log=log)
    assert _cuda.LAUNCHES["cc"] - before == sum(a > 0 for a in log["active"])
    cpu = _level_components(pts, core_d, eps_levels, device="cpu")
    assert np.array_equal(card, cpu)


def test_hdbscan_cluster_card_equals_cpu(cuda, monkeypatch):
    from treelearn_tpu_torch.ops.hdbscan import hdbscan_cluster
    from treelearn_tpu_torch.utils.smoke import knot_layout, knot_recovery

    monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", str(1 << 20))
    pts = knot_layout(9)
    log = {}
    card = hdbscan_cluster(pts, 50, device=cuda, log=log)
    assert log["route"] == "ladder"
    assert np.array_equal(card, hdbscan_cluster(pts, 50, device="cpu"))
    assert knot_recovery(card, 9)[2]


@pytest.mark.parametrize("k_size", [3, 5, 9])
@pytest.mark.parametrize("dtype,cin,cout", [
    (torch.float32, 4, 32), (torch.float32, 32, 32), (torch.bfloat16, 32, 64),
    (torch.bfloat16, 96, 96)])
def test_routed_conv_and_dw_any_kernel_size(cuda, k_size, dtype, cin, cout):
    """The routed conv, its dx and its dW at K = 27, 125 and 729 against
    their plain versions: the conv f32 rtol 1e-4 / bf16 2e-2 of max |out|,
    dW 1e-4 / 1e-3 of max |dW|; two dW launches give the same bits.  At
    K = 729 (kernel size 9) no conv kernel takes the shape: the conv and dx
    count no launch, and the dW kernels, which take any offset count, count
    theirs only where both widths are multiples of 8."""
    from treelearn_tpu_torch.model.network import level_rule
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (mirrored, subm_conv,
                                                   subm_conv_dw, subm_conv_dx)

    g_ = _grid(cuda, seed=4, n=3000)
    rule = level_rule(g_, k_size)
    k = rule.shape[0]
    assert k == k_size ** 3
    gen = torch.Generator(device="cpu").manual_seed(k + cin)
    v = g_.n_active
    x = torch.randn(v, cin, generator=gen).to(cuda, dtype)
    w = (torch.randn(k, cin, cout, generator=gen) * 0.1).to(cuda, dtype)
    go = torch.randn(v, cout, generator=gen).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    out = subm_conv(x, w, rule)
    dx = subm_conv_dx(go, w, rule)
    conv_launches = _launched(before)
    before = dict(_cuda.LAUNCHES)
    dw = subm_conv_dw(x, go, rule)
    again = subm_conv_dw(x, go, rule)
    torch.cuda.synchronize()
    dw_launches = _launched(before)
    suffix = "tf32" if dtype == torch.float32 else "wgmma"
    if k_size == 9:
        assert conv_launches == {}
        assert dw_launches == ({} if cin % 8 else
                               {"subm_conv_dw_" + suffix: 2})
    else:
        assert conv_launches == {"subm_conv_" + suffix: 2}
        assert dw_launches == {"subm_conv_dw_" + suffix: 2}
    assert torch.equal(dw, again) and dw.shape == (k, cin, cout)
    for got, want in ((out, plain(x, w, rule)),
                      (dx, plain(go, mirrored(w), rule))):
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * scale)
        else:
            assert float((got - want).abs().max()) <= 2e-2 * scale
    want = plain_dw(x, go, rule)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert float((dw - want).abs().max()) <= tol * float(want.abs().max())


def test_kernel_size_5_routes_and_counts(cuda):
    """At K = 125 the routed wrappers take the bf16 tensor-core kernels
    (the 4 -> 32 input conv padded to 32 channels, no other launch) and
    agree with the plain versions."""
    from treelearn_tpu_torch.model.network import level_rule
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import subm_conv, subm_conv_dw

    g_ = _grid(cuda, seed=5, n=40000, ss=(64, 64, 48), batch=1)
    rule = level_rule(g_, 5)
    gen = torch.Generator(device="cpu").manual_seed(5)
    v = g_.n_active
    x = torch.randn(v, 4, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(125, 4, 32, generator=gen) * 0.1).to(cuda,
                                                          torch.bfloat16)
    go = torch.randn(v, 32, generator=gen).to(cuda, torch.bfloat16)
    before = dict(_cuda.LAUNCHES)
    out = subm_conv(x, w, rule).float()
    dw = subm_conv_dw(x, go, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_wgmma": 1, "subm_conv_dw_wgmma": 1}
    want = plain(x, w, rule).float()
    assert float((out - want).abs().max()) <= 2e-2 * float(want.abs().max())
    want = plain_dw(x, go, rule)
    assert float((dw - want).abs().max()) <= 1e-3 * float(want.abs().max())


# ---- the bf16 tensor-core routes at any odd kernel size up to 7 and any
# width (csrc/subm_conv_wgmma.cu, csrc/subm_conv_dw_wgmma.cu)


@pytest.mark.parametrize("v", [1, 63, 136, 1000, 8300, 70000])
@pytest.mark.parametrize("k_size,cin,cout", [
    (5, 32, 32), (5, 64, 96), (3, 16, 16), (3, 48, 48), (3, 24, 40),
    (3, 16, 112), (5, 16, 48), (7, 48, 16), (3, 4, 16), (3, 12, 20)])
def test_bf16_wgmma_any_kernel_size_and_width(cuda, k_size, cin, cout, v):
    """The routed bf16 conv, its dx and its dW at K = 125 / 343 and at
    widths that are no multiple of 32 (16-channel tail slices, 24 channels
    in a slice with a zero chunk, block widths 8..112, Cout slabs reaching
    past Cout; 4 -> 16 and 12 -> 20 zero-padded) take the tensor-core
    kernels only and match the plain versions: 2e-2 of max |out| (conv;
    dx against the plain conv with the mirrored weights), 1e-3 of max |dW|;
    two launches of each give the same bits; rows past n_live are zero."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (mirrored, subm_conv,
                                                   subm_conv_dw, subm_conv_dx)

    k = k_size ** 3
    gen = torch.Generator(device="cpu").manual_seed(k + 7 * cin + cout + v)
    x = torch.randn(v, cin, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(k, cin, cout, generator=gen) * 0.1).to(
        cuda, torch.bfloat16)
    go = torch.randn(v, cout, generator=gen).to(cuda, torch.bfloat16)
    rule = torch.randint(0, v, (k, v), generator=gen, dtype=torch.int32)
    rule[torch.rand(k, v, generator=gen) > 0.3] = -1
    rule = rule.to(cuda)
    before = dict(_cuda.LAUNCHES)
    out, out2 = subm_conv(x, w, rule), subm_conv(x, w, rule)
    dx, dx2 = subm_conv_dx(go, w, rule), subm_conv_dx(go, w, rule)
    dw, dw2 = subm_conv_dw(x, go, rule), subm_conv_dw(x, go, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_wgmma": 4,
                                 "subm_conv_dw_wgmma": 2}
    assert torch.equal(out, out2) and torch.equal(dx, dx2)
    assert torch.equal(dw, dw2)
    assert out.shape == (v, cout) and dx.shape == (v, cin)
    assert dw.shape == (k, cin, cout)
    for got, want in ((out, plain(x, w, rule)),
                      (dx, plain(go, mirrored(w), rule))):
        want = want.float()
        assert float((got.float() - want).abs().max()) <= 2e-2 * float(
            want.abs().max().clamp(min=1e-6))
    want = plain_dw(x, go, rule)
    assert float((dw - want).abs().max()) <= 1e-3 * float(
        want.abs().max().clamp(min=1e-6))
    n_live = v // 2
    part = subm_conv(x, w, rule, n_live=n_live)
    assert (part[n_live:] == 0).all()
    assert torch.equal(part[:n_live], out[:n_live])


@pytest.mark.parametrize("k", [27, 125])
@pytest.mark.parametrize("cin,cout,bn", [
    (24, 16, 8), (16, 48, 24), (48, 48, 48), (112, 224, 112), (40, 24, 24)])
def test_pack_weight_kernel_tail_slices(cuda, k, cin, cout, bn):
    """The pack kernel writes the same images as the torch pack where Cin
    ends in a 16-channel tail slice or a zero chunk, straight and mirrored,
    at K = 27 and 125 (a copy: exact)."""
    from treelearn_tpu_torch.ops.subm_conv import mirrored, pack_weight

    gen = torch.Generator(device="cpu").manual_seed(cin + cout + k)
    w = torch.randn(k, cin, cout, generator=gen).to(torch.bfloat16)
    assert torch.equal(pack_weight(w.to(cuda), bn).cpu(), pack_weight(w, bn))
    bn_m = bn if cin % bn == 0 else 8
    assert torch.equal(pack_weight(w.to(cuda), bn_m, mirror=True).cpu(),
                       pack_weight(mirrored(w), bn_m))


# ---- the 3xTF32 float32 route (csrc/subm_conv_tf32.cu,
# csrc/subm_conv_dw_tf32.cu): the float32 tolerances of the rows above


def _f32_case(gen, v, cin, cout, k=27, present=0.4):
    v_in = v + 5
    x = torch.randn(v_in, cin, generator=gen)
    w = torch.randn(k, cin, cout, generator=gen) * 0.1
    rule = torch.randint(0, v_in, (k, v), generator=gen, dtype=torch.int32)
    rule[torch.rand(k, v, generator=gen) > present] = -1
    return x, w, rule


@pytest.mark.parametrize("v", [1, 63, 136, 1000, 8300, 70000])
@pytest.mark.parametrize("cin,cout", [
    (8, 8), (8, 32), (16, 24), (32, 32), (64, 32), (96, 96), (224, 224),
    (384, 192), (192, 384)])
def test_subm_conv_tf32_matches_plain(cuda, cin, cout, v):
    """The 3xTF32 conv against the plain float32 conv: rtol 1e-4, atol 1e-4
    of max |out| (float32 sums in another order; each product within
    2^-21 of the float32 one).  V covers a lone row, ragged tiles, the
    32-channel blocks of small levels and whole-Cout blocks; slots of 8, 16
    and 32 channels; n_live < V zeroes the tail; two launches give the same
    bits and no other conv kernel launches."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import conv_plan, subm_conv

    assert conv_plan(cin, cout, v, torch.float32).route == "tf32x3"
    gen = torch.Generator(device="cpu").manual_seed(cin * 7 + cout + v)
    x, w, rule = (t.to(cuda) for t in _f32_case(gen, v, cin, cout))
    before = dict(_cuda.LAUNCHES)
    got = subm_conv(x, w, rule)
    again = subm_conv(x, w, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_tf32": 2}
    assert torch.equal(got, again)
    want = plain(x, w, rule)
    scale = float(want.abs().max().clamp(min=1e-6))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    n_live = v // 2
    part = subm_conv(x, w, rule, n_live=n_live)
    assert (part[n_live:] == 0).all()
    torch.testing.assert_close(part[:n_live], want[:n_live], rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("cin,cout,bn,sk", [
    (8, 32, 32, 8), (16, 24, 24, 16), (64, 32, 32, 32), (224, 224, 112, 32),
    (224, 224, 32, 32), (192, 384, 128, 32)])
def test_pack_weight_tf32_kernel_matches_plain(cuda, cin, cout, bn, sk):
    """The tf32 pack kernel writes the torch pack's images, straight and
    mirrored, bit for bit (cvt.rna.tf32.f32 is the bit rounding of
    ``tf32_split``)."""
    from treelearn_tpu_torch.ops.subm_conv import mirrored, pack_weight_tf32

    gen = torch.Generator(device="cpu").manual_seed(cin + cout)
    w = torch.randn(27, cin, cout, generator=gen)
    assert torch.equal(pack_weight_tf32(w.to(cuda), bn, sk).cpu(),
                       pack_weight_tf32(w, bn, sk))
    bn_m = bn if cin % bn == 0 else 8
    sk_m = 32 if cout % 32 == 0 else 8
    assert torch.equal(pack_weight_tf32(w.to(cuda), bn_m, sk_m,
                                        mirror=True).cpu(),
                       pack_weight_tf32(mirrored(w), bn_m, sk_m))


@pytest.mark.parametrize("v", [1, 17, 63, 1000, 58000])
@pytest.mark.parametrize("cin,cout,k", [
    (8, 32, 27), (16, 24, 27), (32, 32, 27), (64, 32, 27), (224, 224, 27),
    (448, 224, 27), (192, 384, 27), (32, 64, 125), (8, 32, 125)])
def test_subm_conv_dw_tf32_matches_plain(cuda, cin, cout, k, v):
    """The 3xTF32 dW against the plain float32 dW: 1e-4 of max |dW|.  The
    M blocks straddle 8 offsets at Cin 8 and split one at Cin >= 64, the
    last ragged; V covers a lone row, ragged slots and several chunks;
    two launches give the same bits."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import dw_plan, subm_conv_dw

    assert dw_plan(cin, cout, v, torch.float32, k).route == "tf32x3"
    gen = torch.Generator(device="cpu").manual_seed(cin * 7 + cout + v + k)
    x, _, rule = _f32_case(gen, v, cin, cout, k)
    x = x[:v].contiguous().to(cuda)
    rule = torch.where(rule >= v, -1, rule).to(cuda)
    g = torch.randn(v, cout, generator=gen).to(cuda)
    before = dict(_cuda.LAUNCHES)
    got = subm_conv_dw(x, g, rule)
    again = subm_conv_dw(x, g, rule)
    torch.cuda.synchronize()
    assert _launched(before) == {"subm_conv_dw_tf32": 2}
    assert torch.equal(got, again)
    want = plain(x, g, rule)
    assert got.shape == (k, cin, cout)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("v", [136, 8300])
def test_subm_conv_tf32_sparse_rules(cuda, v):
    """An all -1 rule gives zeros from both 3xTF32 kernels; a rule with two
    offsets present and one lone entry of a third matches the plain
    versions, the absent offsets' dW slices exactly zero."""
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import subm_conv, subm_conv_dw

    gen = torch.Generator(device="cpu").manual_seed(v)
    x = torch.randn(v, 64, generator=gen).to(cuda)
    w = (torch.randn(27, 64, 96, generator=gen) * 0.1).to(cuda)
    g = torch.randn(v, 96, generator=gen).to(cuda)
    rule = torch.full((27, v), -1, dtype=torch.int32)
    assert (subm_conv(x, w, rule.to(cuda)) == 0).all()
    assert (subm_conv_dw(x, g, rule.to(cuda)) == 0).all()
    rule[[3, 13]] = _random_rule(gen, v, v, 0.7)[[3, 13]]
    rule[26, v - 1] = 0
    rule = rule.to(cuda)
    want = plain(x, w, rule)
    torch.testing.assert_close(subm_conv(x, w, rule), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    got, want = subm_conv_dw(x, g, rule), plain_dw(x, g, rule)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert (got[[0, 1, 2, 4, 12, 14, 25]] == 0).all()


@pytest.mark.parametrize("k_size,cin,cout", [(3, 4, 32), (3, 32, 64),
                                             (3, 64, 32), (5, 32, 64),
                                             (5, 4, 32)])
def test_subm_conv_fn_float32_grads_through_tf32(cuda, k_size, cin, cout):
    """float32 SubmConvFn on a submanifold rule: forward, dx (the conv with
    the mirrored weights) and dW through the 3xTF32 kernels (the 4 -> 32
    input conv padded to 8 input channels, its dx of 4 output channels
    padded to 8 and cut back), against autograd through the plain conv:
    1e-4 of each one's max."""
    from treelearn_tpu_torch.model.network import level_rule
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import SubmConvFn

    g_ = _grid(cuda, seed=6, n=3000)
    rule = level_rule(g_, k_size)
    gen = torch.Generator(device="cpu").manual_seed(cin + cout + k_size)
    v = g_.n_active
    x = torch.randn(v, cin, generator=gen).to(cuda)
    w = (torch.randn(k_size ** 3, cin, cout, generator=gen) * 0.1).to(cuda)
    cot = torch.randn(v, cout, generator=gen).to(cuda)
    before = dict(_cuda.LAUNCHES)
    res = []
    for i, fn in enumerate((SubmConvFn.apply, plain)):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        out = fn(xx, ww, rule)
        (out * cot).sum().backward()
        res.append((out, xx.grad, ww.grad))
        if i == 0:
            torch.cuda.synchronize()
            launched = _launched(before)
    assert launched == {"subm_conv_tf32": 2, "subm_conv_dw_tf32": 1}
    for got, want in zip(*res):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.parametrize("mode", ["tiles", "whole_plot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_loop_pinned_side_stream_equals_serial(cuda, mode, dtype):
    """The overlapped loop on the card (inputs pinned, their H2D on the
    prefetch thread's side stream, the packed float16 + int32 ship into
    pinned buffers, batch t-1 harvested behind t) returns the serial loop's
    arrays bit for bit."""
    from test_torch_port_inference_loop import (CFG, _batches,
                                                _assert_bitwise, serial_loop)
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.pipeline.inference import (get_pointwise_preds,
                                                        stage)

    model = TreeLearn(**CFG).init(0).to(cuda).eval()
    want, counts = serial_loop(model, _batches(mode), dev=cuda,
                               compute_dtype=dtype)
    tm = {}
    got = get_pointwise_preds(model, _batches(mode), device=cuda,
                              compute_dtype=dtype, timings=tm)
    for a, b in zip(got, want):
        _assert_bitwise(a, b)
    assert tm["steps"] == len(counts)
    assert tm["h2d_ms"] > 0 and tm["d2h_ms"] > 0
    np.testing.assert_array_equal(
        tm["rule_nnz"], np.max([c[1] for c in counts], axis=0))

    side = torch.cuda.Stream(cuda)
    staged = stage(next(iter(_batches(mode))), cuda, side)
    assert staged["h2d"] is not None
    assert all(t.device.type == "cuda" for t in staged["tensors"])
    staged["h2d"][1].synchronize()


def _devoxelize_problem(device, n_rows, n_live, n_voxels, seed=0):
    """(v2p int64, order int64, p_order, v_start int32) on ``device``: the
    first ``n_live`` of ``n_rows`` points in ``n_voxels`` voxels (each at
    least one point, voxel 0 also a run of 300), in shuffled order, the rest
    padded (v2p = V); ``order`` a stable sort of v2p, as voxelize_points
    orders the points, and the CSR ``voxel_point_csr`` builds from it."""
    from treelearn_tpu_torch.ops.voxelize import voxel_point_csr

    gen = torch.Generator().manual_seed(seed)
    extra = torch.randint(0, n_voxels, (n_live - n_voxels - 300,),
                          generator=gen)
    live = torch.cat([torch.arange(n_voxels), extra,
                      torch.zeros(300, dtype=torch.int64)])
    v2p = torch.full((n_rows,), n_voxels, dtype=torch.int64)
    v2p[:n_live] = live[torch.randperm(n_live, generator=gen)]
    v2p = v2p.to(device)
    order = torch.sort(v2p, stable=True).indices
    return (v2p, order) + voxel_point_csr(order, v2p, n_voxels)


@pytest.mark.parametrize("c,dtype,n_rows,n_live,n_voxels", [
    (32, torch.bfloat16, 1 << 20, 580_000, 400_000),   # train_crops_35m
    (64, torch.bfloat16, 1 << 20, 580_000, 400_000),   # train_ptv3_crops_35m
    (16, torch.bfloat16, 1 << 16, 40_000, 25_000),
    (16, torch.float32, 1 << 16, 40_000, 25_000),
    (8, torch.float32, 1 << 16, 40_000, 25_000),       # chip_smoke phase 8
    (64, torch.float32, 1 << 16, 40_000, 25_000),
])
def test_devoxelize_kernels_equal_plain(cuda, c, dtype, n_rows, n_live,
                                        n_voxels):
    """Both kernels of csrc/devoxelize.cu equal the plain versions run on CPU
    copies, bit for bit; a second launch gives the same bits; each wrapper
    counts its launch."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.voxelize import (devoxelize_backward_cuda,
                                                  devoxelize_backward_plain,
                                                  devoxelize_cuda,
                                                  devoxelize_plain)

    v2p, _, p_order, v_start = _devoxelize_problem(cuda, n_rows, n_live,
                                                   n_voxels)
    gen = torch.Generator().manual_seed(c)
    feats = torch.randn(n_voxels, c, generator=gen).to(cuda, dtype)
    grad = torch.randn(n_rows, c, generator=gen).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    out = devoxelize_cuda(feats, v2p)
    dfeats = devoxelize_backward_cuda(grad, p_order, v_start)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["devoxelize_fwd"] == before["devoxelize_fwd"] + 1
    assert _cuda.LAUNCHES["devoxelize_bwd"] == before["devoxelize_bwd"] + 1
    assert out.dtype == dtype and dfeats.dtype == dtype
    assert torch.equal(out.cpu(), devoxelize_plain(feats.cpu(), v2p.cpu()))
    assert torch.equal(dfeats.cpu(), devoxelize_backward_plain(
        grad.cpu(), v2p.cpu(), n_voxels))
    assert torch.equal(devoxelize_cuda(feats, v2p), out)
    assert torch.equal(devoxelize_backward_cuda(grad, p_order, v_start),
                       dfeats)


def test_devoxelize_autograd_on_card_takes_the_kernels(cuda):
    """devoxelize under autograd on the card: the gradient is the backward
    kernel's over the CSR built from the sort, and the counter takes the
    cuda route once."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.voxelize import (DevoxelizeFn,
                                                  devoxelize_backward_plain)
    from treelearn_tpu_torch.utils.trace import SpanTimer

    v2p, order, _, _ = _devoxelize_problem(cuda, 1 << 14, 9000, 5000)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(5000, 32, generator=gen).to(cuda, torch.bfloat16)
    grad = torch.randn(1 << 14, 32, generator=gen).to(cuda, torch.bfloat16)
    x = feats.clone().requires_grad_(True)
    before = dict(_cuda.LAUNCHES)
    with SpanTimer(cuda) as timer:
        DevoxelizeFn.apply(x, v2p, order).backward(grad)
    torch.cuda.synchronize()
    assert timer.counters() == {"devoxelize.bwd.cuda": 1}
    assert _cuda.LAUNCHES["devoxelize_fwd"] == before["devoxelize_fwd"] + 1
    assert _cuda.LAUNCHES["devoxelize_bwd"] == before["devoxelize_bwd"] + 1
    assert torch.equal(x.grad.cpu(), devoxelize_backward_plain(
        grad.cpu(), v2p.cpu(), 5000))


@pytest.mark.parametrize("c,dtype,error", [
    (32, torch.float16, TypeError),
    (32, torch.float64, TypeError),
    (24, torch.bfloat16, ValueError),     # 3 lanes of 16 bytes
    (4, torch.bfloat16, ValueError),      # half a lane
    (12, torch.float32, ValueError),
    (256, torch.float32, ValueError),     # 64 lanes
])
def test_devoxelize_kernels_refuse_other_rows(cuda, c, dtype, error):
    from treelearn_tpu_torch.ops.voxelize import (devoxelize_backward_cuda,
                                                  devoxelize_cuda)

    v2p, _, p_order, v_start = _devoxelize_problem(cuda, 1 << 12, 2000, 1000)
    feats = torch.zeros(1000, c, dtype=dtype, device=cuda)
    grad = torch.zeros(1 << 12, c, dtype=dtype, device=cuda)
    with pytest.raises(error):
        devoxelize_cuda(feats, v2p)
    with pytest.raises(error):
        devoxelize_backward_cuda(grad, p_order, v_start)


def _mask_logits(device, nq, k, seed):
    """Mask logits (nq, k) float32 on the card: half the queries open
    near one window of keys (so whole tiles close), the rest about half
    open at random; exact zeros, negative zeros and NaNs among them, and
    two rows with every entry negative."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(nq, k, generator=g, device=device)
    centre = torch.randint(0, k, (nq, 1), generator=g, device=device)
    keys = torch.arange(k, device=device)[None]
    window = torch.where((keys - centre).abs() < max(1, k // 20), 2.0, -2.0)
    p = torch.where(torch.arange(nq, device=device)[:, None] % 2 == 0,
                    p * 0.5 + window, p)
    flat = p.view(-1)
    pick = torch.randint(0, flat.numel(), (3 * max(1, flat.numel() // 100),),
                         generator=g, device=device)
    third = len(pick) // 3
    flat[pick[:third]] = 0.0
    flat[pick[third:2 * third]] = -0.0
    flat[pick[2 * third:]] = float("nan")
    for r in (1, nq - 1):
        p[r] = -torch.rand(k, generator=g, device=device) - 0.1
    return p


@pytest.mark.parametrize("nq,k", [(400, 200_000), (70, 1), (70, 33), (5, 100),
                                  (130, 1000), (64, 129), (512, 4100)])
def test_mask_pack_kernel_equals_plain(cuda, nq, k):
    """tl_mask_attn_pack gives the plain packer's bits, all-closed rows,
    tile bytes and counts exactly (so the skipped tiles are a plain
    recount), and two launches the same bits."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.mask_attn import (mask_pack_cuda,
                                                   mask_pack_plain)

    p = _mask_logits(cuda, nq, k, seed=nq + k)
    before = dict(_cuda.LAUNCHES)
    m = mask_pack_cuda(p)
    torch.cuda.synchronize()
    assert _launched(before) == {"mask_attn_pack": 1}
    want = mask_pack_plain(p)
    assert m.keys == want.keys
    for name in ("bits", "row_closed", "tiles", "stats"):
        assert torch.equal(getattr(m, name), getattr(want, name)), name
    assert torch.equal(m.row_closed, (p < 0).all(-1))
    assert int(m.row_closed.sum()) >= (2 if nq > 2 else 1)
    assert torch.equal(mask_pack_cuda(p).bits, m.bits)


def _mask_attn_problem(device, nq, ks, heads, seed=0):
    from treelearn_tpu_torch.ops.mask_attn import mask_pack_cuda

    g = torch.Generator(device=device).manual_seed(seed)
    d = heads * 32
    q = torch.randn(len(ks), nq, d, generator=g, device=device)
    kv = torch.randn(sum(ks), 2 * d, generator=g, device=device)
    ranges, s = [], 0
    for k in ks:
        ranges.append((s, s + k))
        s += k
    masks = [mask_pack_cuda(_mask_logits(device, nq, k, seed + i))
             for i, k in enumerate(ks)]
    grad = torch.randn(len(ks), nq, d, generator=g, device=device)
    return (q.to(torch.bfloat16), kv.to(torch.bfloat16), masks, ranges,
            grad.to(torch.bfloat16))


def _rel_rms(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("nq,ks,heads", [
    (400, (200_000,), 8),           # the SPFormer cell's shape
    (70, (100, 1000), 2), (20, (1, 33), 1), (130, (64, 129), 4),
    (512, (3000, 5), 8)])
def test_mask_attention_kernels_match_plain(cuda, nq, ks, heads):
    """Forward and dq / dk / dv of the kernels against the plain version in
    float32 on the same bf16 inputs: bf16 outputs and bf16 P in the
    products, so 1 % RMS (the outputs' rounding is ~0.3 %); two runs give
    the same bits; one forward and one backward launch an element."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.mask_attn import (mask_attention,
                                                   mask_attention_plain)

    q, kv, masks, ranges, grad = _mask_attn_problem(cuda, nq, ks, heads)
    scale = 32 ** -0.5
    runs = []
    for _ in range(2):
        qq = q.clone().requires_grad_(True)
        kk = kv.clone().requires_grad_(True)
        before = dict(_cuda.LAUNCHES)
        o = mask_attention(qq, kk, masks, ranges, heads, scale)
        o.backward(grad)
        torch.cuda.synchronize()
        assert _launched(before) == {"mask_attn_fwd": len(ks),
                                     "mask_attn_bwd": len(ks)}
        assert o.dtype == qq.grad.dtype == kk.grad.dtype == torch.bfloat16
        runs.append((o.detach(), qq.grad, kk.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    qf = q.float().requires_grad_(True)
    kf = kv.float().requires_grad_(True)
    want = mask_attention_plain(qf, kf, masks, ranges, heads, scale)
    want.backward(grad.float())
    got = runs[0]
    assert torch.isfinite(got[0]).all()
    assert _rel_rms(got[0], want.detach()) < 1e-2
    assert _rel_rms(got[1], qf.grad) < 2e-2
    d = heads * 32
    assert _rel_rms(got[2][:, :d], kf.grad[:, :d]) < 2e-2
    assert _rel_rms(got[2][:, d:], kf.grad[:, d:]) < 2e-2


def test_mask_attention_elements_never_mix(cuda):
    """Changing the second element's keys and values moves nothing of the
    first element's output, dq or key/value gradient, bit for bit."""
    from treelearn_tpu_torch.ops.mask_attn import mask_attention

    q, kv, masks, ranges, grad = _mask_attn_problem(cuda, 100, (3000, 2000),
                                                    4, seed=3)
    s, e = ranges[1]
    kv2 = kv.clone()
    kv2[s:e] = kv2[s:e] * 2
    res = []
    for k in (kv, kv2):
        qq = q.clone().requires_grad_(True)
        kk = k.clone().requires_grad_(True)
        o = mask_attention(qq, kk, masks, ranges, 4, 32 ** -0.5)
        o.backward(grad)
        res.append((o[0].detach(), qq.grad[0], kk.grad[:ranges[0][1]]))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    assert not torch.equal(res[0][1], torch.zeros_like(res[0][1]))


def test_mask_attention_refuses_other_shapes(cuda):
    from treelearn_tpu_torch.ops.mask_attn import mask_attention

    q, kv, masks, ranges, _ = _mask_attn_problem(cuda, 20, (100,), 2)
    with pytest.raises(TypeError):
        mask_attention(q.float(), kv.float(), masks, ranges, 2, 0.2)
    with pytest.raises(ValueError):      # heads of width 16
        mask_attention(q, kv, masks, ranges, 4, 0.25)
    big, kv2, m2, r2, _ = _mask_attn_problem(cuda, 513, (100,), 2)
    with pytest.raises(ValueError):
        mask_attention(big, kv2, m2, r2, 2, 0.2)


def test_spformer_decoder_on_card_takes_the_kernels(cuda):
    """A bf16 SPFormer head on the card: each layer packs its mask once an
    element and attends through the kernels (forward and backward), and the
    gradients are finite."""
    from treelearn_tpu_torch.model.spformer import SPFormerHead
    from treelearn_tpu_torch.ops import _cuda

    torch.manual_seed(0)
    head = SPFormerHead(32, num_layer=2, num_query=40).to(cuda)
    x = torch.randn(3000, 32, device=cuda)
    before = dict(_cuda.LAUNCHES)
    out = head(x, [(0, 1800), (1800, 3000)], dtype=torch.bfloat16)
    loss = sum(p.float().square().mean() for p in out["pred_masks"][-1])
    loss = loss + out["pred_logits"][-1].float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert _launched(before) == {"mask_attn_pack": 4, "mask_attn_fwd": 4,
                                 "mask_attn_bwd": 4}
    assert out["mask_tiles"].shape == (2, 2)
    assert int(out["mask_tiles"][0, 1]) == 1 * (-(-1800 // 64)
                                                + -(-1200 // 64))
    for p in head.parameters():
        if p.grad is not None:
            assert torch.isfinite(p.grad).all()
