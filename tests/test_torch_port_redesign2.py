"""The redesigned k-NN and weight-gradient kernels of treelearn_tpu_torch, as
far as the CPU reaches: the plain twin of the cooperative k-NN walk (groups,
work items, candidate partitions, merge by (d2, position)) against the plain
pass, on its own and through the banded route beside the JAX package's
Pallas kernel in interpret mode; the group and item tables; the launch plan
of the tensor-core weight gradient for every shape of the training path; the
chunked two-pass sum; and the CPU routing of the wrappers.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_pallas_knn import _data

torch.set_num_threads(1)

CHANNELS = [32 * (i + 1) for i in range(7)]
# the training path's convs: C -> C at every level, decoder 2C -> C
TRAIN_SHAPES = ([(c, c) for c in CHANNELS]
                + [(2 * c, c) for c in CHANNELS[:-1]])
DW_VS = [1, 15, 16, 17, 63, 1000, 58000]


@st.composite
def knn_problems(draw):
    """Refs on a coarse lattice with duplicated points (equal distances
    abound), queries on and off it and far away (empty ranges, fewer than k
    found), a cell from tiny (groups of one query) to the whole cloud (one
    group), and a partition size small enough that candidates are split."""
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    nr = draw(st.integers(1, 400))
    nq = draw(st.integers(1, 120))
    step = draw(st.sampled_from([0.25, 0.5, 1.0]))
    refs = np.round(rng.uniform(0, 6, (nr, 3)) / step) * step
    dup = rng.integers(0, nr, nr // 3)
    refs[rng.integers(0, nr, len(dup))] = refs[dup]
    queries = np.concatenate([
        np.round(rng.uniform(0, 6, (nq, 3)) / step) * step,
        rng.uniform(-1, 7, (nq // 2, 3)),
        rng.uniform(40, 60, (3, 3))])
    labels = rng.integers(1, 6, nr)
    return dict(refs=refs.astype(np.float32), labels=labels,
                queries=queries.astype(np.float32),
                cell=draw(st.sampled_from([0.3, 1.0, 3.0, 20.0])),
                k=draw(st.integers(1, 8)),
                cands_per_part=draw(st.sampled_from([1, 4, 64, 256])))


def _prepare(case, monkeypatch):
    from treelearn_tpu_torch.ops import knn

    monkeypatch.setattr(knn, "CANDS_PER_PART", case["cands_per_part"])
    return knn.prepare_pass(
        torch.from_numpy(case["refs"]), torch.from_numpy(case["labels"]),
        torch.from_numpy(case["queries"]), case["cell"], case["k"])


@settings(max_examples=60, deadline=None)
@given(knn_problems())
def test_grouped_walk_equals_plain_pass(case):
    """Splitting a group's candidates among partitions and merging their k
    nearest by (d2, position) gives the plain pass's winners and found
    counts exactly, ties, empty ranges and short lists included."""
    from treelearn_tpu_torch.ops.knn import (knn_pass_grouped_plain,
                                             knn_pass_plain)

    with pytest.MonkeyPatch.context() as mp:
        p = _prepare(case, mp)
    w, f = knn_pass_plain(p)
    wg, fg = knn_pass_grouped_plain(p)
    assert torch.equal(f, fg)
    assert torch.equal(w, wg)
    assert bool(((w >= 0) == (f == case["k"])).all())


@settings(max_examples=60, deadline=None)
@given(knn_problems())
def test_group_and_item_tables_partition_the_queries(case):
    """Groups are the runs of equal cell key: they partition the sorted
    queries and every query of a group has the group's ranges.  Items cut
    each group into slices of at most ``qs`` queries, ``qs`` a power of two
    that divides the block, in order and without gaps."""
    from treelearn_tpu_torch.ops.knn import BLOCK_THREADS

    with pytest.MonkeyPatch.context() as mp:
        p = _prepare(case, mp)
    nq = p.queries.shape[0]
    groups = p.groups.tolist()
    assert groups[0] == 0 and groups[-1] == nq
    assert all(a < b for a, b in zip(groups, groups[1:]))
    gid = torch.repeat_interleave(torch.arange(len(groups) - 1),
                                  torch.diff(p.groups.long()))
    assert torch.equal(p.ranges, p.ranges[p.groups[:-1].long()][gid])
    # a new group starts where the ranges' middle row changes cell
    starts = torch.tensor(groups[:-1])
    items = p.items.tolist()
    at = 0
    for q0, n, qs in items:
        assert q0 == at and 1 <= n <= qs
        assert qs & (qs - 1) == 0 and BLOCK_THREADS % qs == 0
        assert int(gid[q0]) == int(gid[q0 + n - 1])      # one group a slice
        at += n
    assert at == nq
    assert set(starts.tolist()) <= {q0 for q0, _, _ in items}


def test_items_split_candidates_and_keep_queries_together():
    """A group of 1000 queries over 100,000 candidates keeps 32 queries a
    block (8 partitions); a lone query over as many takes all 256 threads
    as partitions; 30 queries over 300 candidates are not split."""
    from treelearn_tpu_torch.ops.knn import pass_items

    groups = torch.tensor([0, 1000, 1001, 1031], dtype=torch.int32)
    ranges = torch.zeros((1031, 6), dtype=torch.int32)
    ranges[:1001, 1] = 100000
    ranges[1001:, 3] = 300
    items = pass_items(groups, ranges)
    assert items[:32].tolist() == [[32 * i, 32 if i < 31 else 8, 32]
                                   for i in range(32)]
    assert items[32:].tolist() == [[1000, 1, 1], [1001, 30, 256]]


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_walk_through_banded_route_matches_pallas(seed, monkeypatch):
    """The banded route with the grouped walk as its pass gives the votes of
    the plain pass exactly, and those of the interpret-mode Pallas route but
    for float-equal distance ties."""
    import treelearn_tpu.ops.pallas_knn as pk
    from treelearn_tpu_torch.ops import knn

    monkeypatch.setattr(pk, "_INTERPRET", True)
    refs, labels, queries = _data(seed=seed)
    plain = knn.banded_knn_classify(refs, labels, queries, k=5, device="cpu")
    monkeypatch.setattr(knn, "CANDS_PER_PART", 16)
    monkeypatch.setattr(knn, "knn_pass_plain", knn.knn_pass_grouped_plain)
    log = {}
    got = knn.banded_knn_classify(refs, labels, queries, k=5, device="cpu",
                                  log=log)
    assert np.array_equal(got, plain)
    assert log["rounds"]
    jax_vote = pk.banded_knn_classify(refs, labels, queries, k=5,
                                      small_refs_kdtree=False)
    assert (got == jax_vote).mean() >= 0.998


@pytest.mark.parametrize("v", DW_VS)
@pytest.mark.parametrize("cin,cout", TRAIN_SHAPES)
def test_dw_plan_fits_the_card_and_covers_the_rows(cin, cout, v):
    """Every bf16 shape of the training path takes the tensor-core route
    with shared memory inside a block's limit, partials under the cap, a
    ring slot of whole K steps, and chunks that cover every row once."""
    from treelearn_tpu_torch.ops.subm_conv import (DW_PARTIAL_BYTES,
                                                   SMEM_LIMIT, dw_plan,
                                                   dw_smem_bytes)

    plan = dw_plan(cin, cout, v, torch.bfloat16)
    assert plan.route == "wgmma"
    assert plan.bn % 32 == 0 and plan.bn <= 256
    assert plan.bn * plan.n_splits == cout
    assert plan.producers in (128, 256) and 2 <= plan.stages <= 8
    assert plan.smem_bytes == dw_smem_bytes(plan.bn, plan.producers,
                                            plan.stages)
    assert plan.smem_bytes <= SMEM_LIMIT
    rows = plan.producers // 4
    assert rows % 16 == 0 and plan.rows_per_chunk % rows == 0
    assert plan.n_chunks >= 1
    assert (plan.n_chunks - 1) * plan.rows_per_chunk < v
    assert plan.n_chunks * plan.rows_per_chunk >= v
    if plan.n_chunks > 1:
        assert plan.n_chunks * 27 * cin * cout * 4 <= DW_PARTIAL_BYTES


@pytest.mark.parametrize("cin,cout,dtype", [
    (32, 32, torch.float32), (224, 224, torch.float32),
    (4, 32, torch.bfloat16), (4, 32, torch.float32),
    (48, 32, torch.bfloat16), (32, 40, torch.bfloat16)])
def test_dw_plan_routes_float32_and_odd_widths_to_plain(cin, cout, dtype):
    """Widths in multiples of 8 take the tensor-core dW of their dtype
    (3xTF32 in float32; wgmma in bf16, 48 x 32 and 32 x 40 since the bf16
    kernel takes any multiple of 8); the plan of a width that is none (the
    unpadded 4 -> 32 input conv) is the plain version, one chunk, which the
    wrapper avoids by padding first.  Either way the chunks cover every row
    once."""
    from treelearn_tpu_torch.ops.subm_conv import dw_plan

    tc = cin % 8 == 0 and cout % 8 == 0
    want = ("plain" if not tc else "tf32x3" if dtype == torch.float32
            else "wgmma")
    for v in DW_VS:
        plan = dw_plan(cin, cout, v, dtype)
        assert plan.route == want
        if not tc:
            assert plan.n_chunks == 1
        assert plan.n_chunks * plan.rows_per_chunk >= v
        assert (plan.n_chunks - 1) * plan.rows_per_chunk < v


@pytest.mark.parametrize("cin,cout,v,dtype", [
    (32, 64, 1000, torch.bfloat16), (64, 32, 1234, torch.bfloat16),
    (96, 96, 700, torch.bfloat16), (8, 32, 900, torch.float32)])
def test_chunked_two_pass_sum_equals_plain_dw(cin, cout, v, dtype):
    """The per-chunk partials of a plan, added in chunk order, are the plain
    weight gradient within 1e-5 of max |dW| (float32 sums in another
    order).  8 -> 32 in float32 is the 4 -> 32 input conv as the wrapper
    pads it onto the 3xTF32 dW."""
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import dw_chunked_plain, dw_plan

    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.normal(size=(v, cin)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(v, cout)).astype(np.float32)).to(dtype)
    rule = torch.from_numpy(rng.integers(0, v, (27, v)).astype(np.int32))
    rule[torch.from_numpy(rng.random((27, v)) > 0.4)] = -1
    plan = dw_plan(cin, cout, v, dtype)
    assert plan.n_chunks > 1
    want = plain(x, g, rule)
    got = dw_chunked_plain(x, g, rule, plan)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_cpu_wrappers_take_the_plain_versions(monkeypatch):
    """On CPU tensors neither wrapper reaches the kernel library, whatever
    the dtype and width, and no launch is counted."""
    from treelearn_tpu_torch.ops import _cuda, knn
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import subm_conv_dw

    def no_library():
        raise AssertionError("the CPU route must not build the kernels")

    monkeypatch.setattr(_cuda, "library", no_library)
    before = dict(_cuda.LAUNCHES)
    rng = np.random.default_rng(0)
    rule = torch.from_numpy(rng.integers(-1, 300, (27, 300)).astype(np.int32))
    for dtype, cin, cout in ((torch.bfloat16, 32, 64), (torch.float32, 4, 8)):
        x = torch.from_numpy(rng.normal(size=(300, cin)).astype(
            np.float32)).to(dtype)
        g = torch.from_numpy(rng.normal(size=(300, cout)).astype(
            np.float32)).to(dtype)
        assert torch.equal(subm_conv_dw(x, g, rule), plain(x, g, rule))
    refs, labels, queries = _data()
    p = knn.prepare_pass(torch.from_numpy(refs), torch.from_numpy(labels),
                         torch.from_numpy(queries), 0.5, 5)
    w, f = knn.knn_pass(p)
    wp, fp = knn.knn_pass_plain(p)
    assert torch.equal(w, wp) and torch.equal(f, fp)
    assert _cuda.LAUNCHES == before
