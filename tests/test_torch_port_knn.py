"""treelearn_tpu_torch k-NN (kernel 6's plain version, the banded routing,
brute_knn) vs the JAX package on the CPU.  The Pallas k-NN kernel runs in
interpret mode, as tests/test_pallas_knn.py runs it."""

import numpy as np
import pytest
import torch

from test_pallas_knn import _data, _oracle_vote

torch.set_num_threads(1)


def _clumped():
    return _data()


def _negative_labels():
    refs, labels, queries = _data(seed=1)
    return refs, labels - 1, queries          # labels in {-1, 0, .., 6}


def _sparse_escalation():
    rng = np.random.default_rng(2)
    refs = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 64)
    queries = np.array([[50.0, 50.0, 0.0], [2.0, 2.0, 0.0],
                        [-30.0, 10.0, 1.0]], np.float32)
    return refs, labels, queries


@pytest.mark.parametrize("case,share", [
    (_clumped, 0.998), (_negative_labels, 0.998), (_sparse_escalation, 1.0)])
def test_banded_matches_pallas_interpret_and_oracle(case, share, monkeypatch):
    """The port's banded route (plain pass) against the interpret-mode
    Pallas route and the float64 brute-force vote: equal on at least
    ``share`` of the queries (the two sides may break float-equal distance
    ties differently; the sparse case has none)."""
    import treelearn_tpu.ops.pallas_knn as pk
    from treelearn_tpu_torch.ops.knn import banded_knn_classify

    monkeypatch.setattr(pk, "_INTERPRET", True)
    refs, labels, queries = case()
    log = {}
    got = banded_knn_classify(refs, labels, queries, k=5, device="cpu",
                              log=log)
    jax_vote = pk.banded_knn_classify(refs, labels, queries, k=5,
                                      small_refs_kdtree=False)
    oracle = _oracle_vote(refs, labels, queries, 5)
    assert (got == jax_vote).mean() >= share
    assert (got == oracle).mean() >= share
    assert log["rounds"], log


def test_knn_pass_plain_counts_and_votes():
    """One plain pass against a direct float32 count of the in-radius refs
    (capped at k) and the vote over the k nearest of them; the radius is 1
    after scaling by f32(1/cell)."""
    from treelearn_tpu_torch.ops.cluster import vote
    from treelearn_tpu_torch.ops.knn import knn_pass_plain, prepare_pass

    refs, labels, queries = _data(seed=3, n_ref=2000, n_q=400)
    enc = labels + 1
    cell = 1.3
    p = prepare_pass(torch.from_numpy(refs), torch.from_numpy(enc),
                     torch.from_numpy(queries), cell, 5)
    winner, found = knn_pass_plain(p, max_block=1 << 12)
    inv = np.float32(1.0) / np.float32(cell)
    r = refs * inv
    q = queries[p.q_order.numpy()] * inv
    d = q[:, None, :] - r[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    inr = d2 <= np.float32(1.0)
    np.testing.assert_array_equal(found.numpy(),
                                  np.minimum(inr.sum(1), 5))
    full = found.numpy() == 5
    assert 0 < full.sum() < len(full)
    order = np.argsort(np.where(inr, d2, np.inf)[full], axis=1,
                       kind="stable")[:, :5]
    np.testing.assert_array_equal(winner.numpy()[full], vote(enc[order]))
    assert (winner.numpy()[~full] == -1).all()


def test_brute_knn_matches_jax():
    """Exact k nearest against the JAX package's brute_knn: the same
    neighbor distances (float64, 1e-6), and fewer refs than k repeats the
    nearest in both."""
    from treelearn_tpu.ops.cluster import brute_knn as jbrute
    from treelearn_tpu_torch.ops.cluster import brute_knn

    refs, _, queries = _data(seed=4, n_ref=1200, n_q=300)
    got = brute_knn(refs, queries, k=5, q_block=128, r_block=256,
                    device="cpu")
    want = jbrute(refs, queries, k=5)

    def dist(idx):
        return np.linalg.norm(queries[:, None, :].astype(np.float64)
                              - refs[idx].astype(np.float64), axis=2)

    np.testing.assert_allclose(dist(got), dist(want), atol=1e-6)
    assert (got == want).mean() > 0.99
    few = brute_knn(refs[:3], queries[:10], k=5, device="cpu")
    np.testing.assert_array_equal(few, jbrute(refs[:3], queries[:10], k=5))


@pytest.mark.parametrize("env,route", [
    ({}, "kdtree_small_refs"),
    ({"TL_KNN_SMALL_REFS": "100", "TL_KNN_KDTREE_MIN_PAIRS": "1e5"},
     "kdtree_backstop"),
    ({"TL_KNN_SMALL_REFS": "100"}, "banded"),
])
def test_knn_classify_route_selection(env, route, monkeypatch):
    """knn_classify takes the route the thresholds select and answers the
    exact vote on each (ties aside); the banded route logs its rounds."""
    from treelearn_tpu_torch.ops import cluster as pc

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    refs, labels, queries = _data(seed=5, n_ref=1600, n_q=300)
    del pc.KNN_LOG[:]
    got = pc.knn_classify(refs, labels, queries, k=5, device="cpu")
    (call,) = pc.KNN_LOG
    assert (call.route, call.n_refs, call.n_queries) == (route, 1600, 300)
    assert bool(call.rounds) == (route == "banded")
    assert (got == _oracle_vote(refs, labels, queries, 5)).mean() >= 0.998


@pytest.mark.parametrize("env,route", [
    ({}, "kdtree_small_refs"),
    ({"TL_KNN_SMALL_REFS": "100", "TL_KNN_KDTREE_MIN_PAIRS": "1e5"},
     "kdtree_backstop"),
    ({"TL_KNN_SMALL_REFS": "100"}, "banded"),
])
def test_knn_classify_routes_are_logged_and_counted(env, route, monkeypatch):
    """Under a span timer each route of knn_classify names itself three
    ways: its KNN_LOG entry, its spans (knn.banded, or knn.kdtree and
    knn.vote) and the counter knn.queries.<route>, which takes the call's
    queries and no other route's counter does."""
    from treelearn_tpu_torch.ops import cluster as pc
    from treelearn_tpu_torch.utils.trace import SpanTimer

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    refs, labels, queries = _data(seed=7, n_ref=1200, n_q=200)
    del pc.KNN_LOG[:]
    with SpanTimer("cpu") as timer:
        pc.knn_classify(refs, labels, queries, k=5, device="cpu")
    assert [c.route for c in pc.KNN_LOG] == [route]
    assert timer.counters() == {f"knn.queries.{route}": 200}
    assert set(timer.summary()) == ({"knn.banded"} if route == "banded"
                                    else {"knn.kdtree", "knn.vote"})


def test_banded_knn_classify_reads_no_thresholds(monkeypatch):
    """The port's banded_knn_classify leaves the route to knn_classify: the
    environment's thresholds do not reach it, and its pair threshold is an
    argument.  Below the problem's query x ref pairs it sends every query
    to the host KD-tree backstop, with no banded round and no brute pass."""
    from treelearn_tpu_torch.ops import cluster as pc
    from treelearn_tpu_torch.ops.knn import banded_knn_classify

    monkeypatch.setenv("TL_KNN_SMALL_REFS", str(1 << 30))
    monkeypatch.setenv("TL_KNN_KDTREE_MIN_PAIRS", "1")
    refs, labels, queries = _data(seed=8, n_ref=1200, n_q=200)
    want = _oracle_vote(refs, labels, queries, 5)
    log = {}
    got = banded_knn_classify(refs, labels, queries, k=5, device="cpu",
                              log=log)
    assert log["rounds"] and (got == want).mean() >= 0.99

    def no_brute(*args, **kwargs):
        raise AssertionError("the backstop above min_pairs is the KD-tree")

    monkeypatch.setattr(pc, "brute_knn", no_brute)
    log = {}
    got = banded_knn_classify(refs, labels, queries, k=5, min_pairs=1e3,
                              device="cpu", log=log)
    assert log["rounds"] == [] and log["n_brute"] == 200
    assert (got == want).mean() >= 0.99


def test_banded_route_label_guard(monkeypatch):
    """Encoded labels at or above 2^24 leave the banded passes (the Pallas
    call carries labels as float32): no rounds, every query answered by the
    exact backstop, labels returned unchanged."""
    from treelearn_tpu_torch.ops import cluster as pc

    monkeypatch.setenv("TL_KNN_SMALL_REFS", "100")
    refs, labels, queries = _data(seed=6, n_ref=800, n_q=100)
    labels = labels * (1 << 22)          # 0 .. 7 * 2^22: encoded >= 2^24
    del pc.KNN_LOG[:]
    got = pc.knn_classify(refs, labels, queries, k=5, device="cpu")
    (call,) = pc.KNN_LOG
    assert call.route == "banded" and call.rounds == ()
    assert call.n_brute == 100
    assert (got == _oracle_vote(refs, labels, queries, 5)).mean() >= 0.99
