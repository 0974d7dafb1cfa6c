"""SPFormer's query decoder as the port's second head
(``TreeLearn(head="spformer")``, model/spformer.py, train/matching.py)
against the plain float32 reference ``benchmark/reference/spformer.py`` on
seeded random weights, at a small size that keeps every mechanism: the
U-Net at 5 levels of 8-40 channels, Q 16 queries of width 32 in 4 heads, an
FFN of 64, 2 layers (so 3 predictions), two batch elements of 1,290 and
702 voxels with 4 trees each, ignored and non-tree points among them.

Tolerances: the program and the reference compute in float32 with other
orders of summation (the reference gathers per offset, attends in explicit
blocks and forms the costs as SPFormer writes them); the predictions agree
to ~2e-6 and the loss to ~1e-7 (relative), so 1e-4 and 1e-5 leave a margin
of 50 or more, while one mask entry, one matched pair or one dropped term
moves them by 1e-2 or more.  The gradients' worst leaf, a U-Net BatchNorm
whose gradient sums ~2,000 nearly cancelling voxel terms, agrees to
~2e-4, hence 2e-3."""

import os
import time

import numpy as np
import pytest
import torch

from benchmark.reference import spformer as ref
from benchmark.reference.sparse import topology

torch.set_num_threads(1)

SMALL = {"num_query": 16, "d_model": 32, "nhead": 4, "hidden_dim": 64,
         "num_layer": 2}
MODEL = {"channels": 8, "num_blocks": 5, "voxel_size": 0.1,
         "head": "spformer", "spformer": dict(SMALL)}
CRIT = dict(SMALL, loss_weight=(0.5, 1.0, 1.0, 0.5),
            cost_weight=(0.5, 1.0, 1.0), non_object_weight=0.1)


def _batch(seed=0, stretch=1.0):
    """Two crops (1,400 and 900 points, 4 trees of vertical slabs each,
    10 % non-tree and 5 % ignored points), 60 padding rows; ``stretch``
    scales the second crop's heights."""
    g = np.random.default_rng(seed)
    a = g.uniform([0, 0, 0], [1.6, 1.6, 3.0], (1400, 3))
    b = g.uniform([0, 0, 0], [1.0, 1.0, 2.0 * stretch], (900, 3)) + 5.0
    xyz = np.concatenate([a, b, np.zeros((60, 3))]).astype(np.float32)
    n = len(xyz)
    inst = np.r_[1 + (a[:, 0] // 0.4).astype(int),
                 1 + ((b[:, 1] - 5.0) // 0.3).astype(int),
                 np.zeros(60)].astype(np.int64)
    inst[g.random(n) < 0.1] = 0
    inst[g.random(n) < 0.05] = -1
    return {"coords": xyz, "input_feats": np.zeros((n, 1), np.float32),
            "batch_ids": np.r_[np.zeros(1400), np.ones(900),
                               np.zeros(60)].astype(np.int32),
            "valid": np.r_[np.ones(2300, bool), np.zeros(60, bool)],
            "instance_labels": inst, "batch_size": 2, "n_points": 2300,
            "masks_sem": np.ones(n, bool), "masks_off": np.ones(n, bool),
            "semantic_labels": np.zeros(n, np.int64),
            "offset_labels": np.zeros((n, 3), np.float32)}


def _model(weights=None, cfg=MODEL):
    from treelearn_tpu_torch.model import TreeLearn

    spec = ref.param_spec(cfg)
    w = ref.make_weights(5, "cpu", spec) if weights is None else weights
    m = TreeLearn(**cfg)
    m.load_state_dict(w, strict=True)
    return m, w, spec


def _matched_rows(preds, assign):
    """The reference loss's input: each prediction's mask logits cut to the
    assignment's query rows."""
    return [[(c, sc, pm[torch.as_tensor(assign[lp][e][0], dtype=torch.long)])
             for lp, (c, sc, pm) in enumerate(pb)]
            for e, pb in enumerate(preds)]


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.fixture(scope="module")
def trained_pass():
    """The program's training forward, loss and gradients on the small
    batch with its records; the reference's on the same weights, masks and
    assignments."""
    from treelearn_tpu_torch.train.loop import (batch_to_device,
                                                loss_from_output)

    model, w, spec = _model()
    model.train()
    model.spformer.record = []
    batch = _batch()
    b = batch_to_device(batch, "cpu", instances=True)
    out = model(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
                batch_size=2)
    loss, terms = loss_from_output(out, b)
    loss.backward()
    rec = model.spformer.record[0]

    p = {k: (v.clone().requires_grad_(True) if spec[k][1] in ref.TRAINABLE
             else v) for k, v in w.items()}
    t = {k: torch.from_numpy(np.asarray(batch[k]))
         for k in ("coords", "batch_ids", "valid", "instance_labels")}
    topo = topology(t["coords"], t["batch_ids"], t["valid"], 2, 0.1, 5)
    x = ref.Backbone(p, topo, 5, training=True).voxels()
    ranges = ref.element_ranges(topo, 2)
    tg = ref.targets(topo, t["instance_labels"], t["batch_ids"].long(),
                     t["valid"], ranges)
    dec = ref.Decoder(p, CRIT)
    preds, own = [], []
    for e, (s, end) in enumerate(ranges):
        pb, ob = dec.forward(x[s:end], [mk[e] for mk in rec["masks"]])
        preds.append(pb)
        own.append(ob)
    assign = []
    for lp in range(SMALL["num_layer"] + 1):
        row = []
        for e in range(2):
            pos = {int(g): i for i, g in enumerate(tg[e][0])}
            rows, labs = rec["assignments"][lp][e]
            row.append((list(rows), [pos[int(g)] for g in labs]))
        assign.append(row)
    rloss = ref.spformer_loss(_matched_rows(preds, assign), tg, assign,
                              CRIT)
    rloss.backward()
    return dict(model=model, out=out, loss=loss, terms=terms, rec=rec,
                params=p, spec=spec, ranges=ranges, tg=tg, preds=preds,
                own=own, assign=assign, rloss=rloss, b=b)


def test_small_model_has_every_mechanism(trained_pass):
    """Both elements have targets and matches, masks close some keys and
    leave some open, and the elements' voxel ranges are the reference's."""
    tp = trained_pass
    assert tp["out"]["voxel_ranges"] == tp["ranges"]
    assert all(len(labels) == 4 for labels, _ in tp["tg"])
    opens = tp["rec"]["open_pairs"]
    keys = tp["ranges"][-1][1] * SMALL["num_query"]
    assert all(0 < o < keys for o in opens)
    assert all(len(r) == 4 for lp in tp["assign"] for r, _ in lp)


@pytest.mark.parametrize("pred", range(SMALL["num_layer"] + 1))
def test_predictions_equal_reference(trained_pass, pred):
    """Each prediction's class logits, score logits and mask logits."""
    tp = trained_pass
    out = tp["out"]
    for e in range(2):
        cls, score, pm = tp["preds"][e][pred]
        assert _rel(out["pred_logits"][pred][e], cls) < 1e-4
        assert _rel(out["pred_scores"][pred][e], score) < 1e-4
        assert _rel(out["pred_masks"][pred][e], pm) < 1e-4


def test_masks_and_open_pairs_equal_reference(trained_pass):
    """The reference's own attention masks are the program's, entry for
    entry, and the program's open pairs (the counters' source) its own."""
    tp = trained_pass
    for e in range(2):
        for mine, theirs in zip(tp["own"][e], tp["rec"]["masks"]):
            assert torch.equal(mine, theirs[e])
    want = [sum(int((~tp["own"][e][lyr]).sum()) for e in range(2))
            for lyr in range(SMALL["num_layer"])]
    assert list(tp["rec"]["open_pairs"]) == want


def test_assignments_equal_reference(trained_pass):
    """Every matching of the program is the reference's own optimum."""
    from scipy.optimize import linear_sum_assignment

    tp = trained_pass
    for lp, row in enumerate(tp["assign"]):
        for e, (rows, cols) in enumerate(row):
            cls, _, pm = tp["preds"][e][lp]
            c = ref.cost_matrix(cls.detach(), pm.detach(), tp["tg"][e][1],
                                CRIT["cost_weight"]).double().numpy()
            r, k = linear_sum_assignment(c)
            assert list(r) == list(rows) and list(k) == list(cols)
            assert ref.match_gap(c, rows, cols) == 0.0


def test_loss_equals_reference(trained_pass):
    tp = trained_pass
    loss, rloss = float(tp["loss"].detach()), float(tp["rloss"].detach())
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    assert float(sum(tp["terms"].values()).detach()) == pytest.approx(
        loss, rel=1e-6)


def test_every_leaf_gradient_equals_reference(trained_pass):
    """Every leaf whose reference gradient is at least a thousandth of the
    median leaf's (so the key slices of the in-projection biases, whose
    exact gradient is 0, and the score head, which no pair of IoU above
    0.5 reaches on random weights, are left out)."""
    tp = trained_pass
    p = tp["params"]
    norms = {k: float(v.grad.norm()) for k, v in p.items()
             if v.requires_grad and v.grad is not None}
    med = float(np.median(list(norms.values())))
    checked = 0
    for name, prm in tp["model"].named_parameters():
        if norms.get(name, 0.0) < 1e-3 * med:
            continue
        assert _rel(prm.grad, p[name].grad) < 2e-3, name
        checked += 1
    assert checked > 100


@pytest.mark.parametrize("route", ["mask_bias", "mask_attention_plain"])
def test_all_closed_row_is_opened(route):
    """A query whose mask logits are all negative attends to every key of
    its element; the others keep P < 0 closed; the reference agrees.  Both
    routes: the CPU's SDPA under ``mask_bias`` of the closed mask, and the
    plain masked attention from the packed bits (the kernels' reference)."""
    from treelearn_tpu_torch.model.spformer import (attention, closed_mask,
                                                    mask_bias)
    from treelearn_tpu_torch.ops.mask_attn import (mask_attention_plain,
                                                   mask_pack)

    g = torch.Generator().manual_seed(0)
    p = torch.randn(5, 40, generator=g)
    p[2] = -torch.rand(40, generator=g) - 0.1
    a = closed_mask(p)
    assert not a[2].any()
    others = [0, 1, 3, 4]
    assert torch.equal(a[others], p[others] < 0)
    assert torch.equal(a, ref.closed_of(p))
    q, k, v = (torch.randn(1, 2, n, 8, generator=g) for n in (5, 40, 40))
    if route == "mask_bias":
        o = attention(q, k, v, mask_bias(a, torch.float32), 8 ** -0.5)
    else:
        m = mask_pack(p)
        assert bool(m.row_closed[2]) and int(m.row_closed.sum()) == 1

        def merged(x):      # (1, H, L, d) -> (L, H d)
            return x[0].transpose(0, 1).reshape(x.shape[2], -1)

        kv = torch.cat([merged(k), merged(v)], 1)
        o = mask_attention_plain(merged(q)[None], kv, [m], [(0, 40)], 2,
                                 8 ** -0.5)
        o = o[0].view(5, 2, 8).transpose(0, 1)[None]
    assert torch.isfinite(o).all()
    want = torch.softmax(q @ k.transpose(-1, -2) * 8 ** -0.5, -1) @ v
    assert torch.allclose(o[0, :, 2], want[0, :, 2], atol=1e-5)


def test_elements_never_see_each_other():
    """In eval mode (BatchNorm on its running statistics) the first
    element's predictions do not change when the second element's points
    are stretched: its keys reach only its own queries."""
    from treelearn_tpu_torch.train.loop import make_eval_step

    model, _, _ = _model()
    step = make_eval_step(model, batch_size=2)
    a = step(_batch())
    b = step(_batch(stretch=1.3))
    assert a["voxel_ranges"][0] == b["voxel_ranges"][0]
    for lp in range(SMALL["num_layer"] + 1):
        assert torch.equal(a["pred_logits"][lp][0], b["pred_logits"][lp][0])
        assert torch.equal(a["pred_masks"][lp][0], b["pred_masks"][lp][0])
        if lp:      # the learned queries read no key before layer 1
            assert not torch.equal(a["pred_logits"][lp][1],
                                   b["pred_logits"][lp][1])


def test_target_majority_rule():
    """A voxel split 2 : 1 between two trees goes to the two-thirds tree;
    a voxel whose majority is non-tree or ignored is in no target; a tree
    that wins no voxel is an empty target."""
    from treelearn_tpu_torch.train.matching import (instance_table,
                                                    voxel_targets)

    # voxel 0: 7, 7, 9; voxel 1: 7, 0, 0; voxel 2: 9, -1, -1; voxel 3:
    # 9, 9, -1; voxel 4: 11 alone among 0, 0; then a padding row
    inst = np.array([7, 7, 9, 7, 0, 0, 9, -1, -1, 9, 9, -1, 11, 0, 0, 5])
    v2p = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5])
    batch = {"instance_labels": inst, "batch_ids": np.zeros(16, np.int32),
             "valid": np.r_[np.ones(15, bool), False], "batch_size": 1}
    ids, labels = instance_table(batch)
    assert list(labels[0]) == [7, 9, 11]
    assert ids[-1] == -1 and ids[4] == -1 and ids[7] == -1
    t = voxel_targets(v2p, torch.from_numpy(ids), [(0, 5)], [3])[0]
    assert t.tolist() == [[1, 0, 0, 0, 0], [0, 0, 0, 1, 0], [0, 0, 0, 0, 0]]


def test_targets_equal_reference(trained_pass):
    """The program's targets of the small batch, with their labels, are
    the reference's."""
    from treelearn_tpu_torch.train.matching import voxel_targets

    tp = trained_pass
    b = tp["b"]
    counts = [len(x) for x in b["instance_elems"]]
    got = voxel_targets(tp["out"]["v2p_map"], b["instance_ids"],
                        tp["ranges"], counts)
    for e in range(2):
        labels, t = tp["tg"][e]
        assert list(b["instance_elems"][e]) == list(labels)
        assert torch.equal(got[e], t)


def _aligned_output():
    """A hand-made decoder output of one element (12 keys, 3 targets by
    voxel, 4 queries) whose first two queries' masks match two targets,
    so that the score term has pairs of IoU above 0.5."""
    g = torch.Generator().manual_seed(3)
    tau = torch.tensor([0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3])
    mfeat = torch.nn.functional.one_hot(tau, 4).float()
    q = torch.tensor([[4.0, -4, -4, -4], [-4, 4, -4, -4], [-4, -4, 3, -4],
                      [0.3, 0.2, -0.1, 0.5]])[None]
    pred = [q + 0.3 * lp * torch.randn(q.shape, generator=g)
            for lp in range(2)]
    out = {"pred_queries": pred,
           "pred_logits": [torch.randn(1, 4, 2, generator=g)
                           for _ in range(2)],
           "pred_scores": [torch.randn(1, 4, generator=g) for _ in range(2)],
           "mask_feats": mfeat, "voxel_ranges": [(0, 12)],
           "v2p_map": torch.arange(12), "open_pairs": None, "record": {},
           "criterion": {k: CRIT[k] for k in ("loss_weight", "cost_weight",
                                              "non_object_weight")}}
    for x in out["pred_logits"] + out["pred_scores"] + pred:
        x.requires_grad_(True)
    out["pred_masks"] = [[(p[0] @ mfeat.t()).detach()] for p in pred]
    ids = torch.where(tau < 3, tau, -1)
    batch = {"instance_ids": ids,
             "instance_elems": [np.array([4, 8, 15])]}
    return out, batch, tau


def test_score_and_class_terms_equal_reference():
    """On predictions whose matched masks overlap their targets, every term
    (the score's MSE among them) and the gradients of the logits equal the
    reference's."""
    from treelearn_tpu_torch.train.matching import spformer_loss

    out, batch, tau = _aligned_output()
    loss, terms = spformer_loss(out, batch)
    assert float(terms["score_loss"].detach()) > 0
    loss.backward()
    t = torch.stack([(tau == g).float() for g in range(3)])
    preds = [[(out["pred_logits"][lp][0].detach().requires_grad_(True),
               out["pred_scores"][lp][0].detach().requires_grad_(True),
               (out["pred_queries"][lp][0].detach() @ out["mask_feats"].t())
               .requires_grad_(True)) for lp in range(2)]]
    labels = np.array([4, 8, 15])
    assign = []
    for lp, (rows, labs) in enumerate(
            a[0] for a in out["record"]["assignments"]):
        cols = [int(np.flatnonzero(labels == g)[0]) for g in labs]
        assign.append([(list(rows), cols)])
    rloss = ref.spformer_loss(_matched_rows(preds, assign), [(labels, t)],
                              assign, CRIT)
    rloss.backward()
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=1e-6)
    for lp in range(2):
        assert torch.allclose(out["pred_logits"][lp].grad[0],
                              preds[0][lp][0].grad, atol=1e-7)
        assert torch.allclose(out["pred_scores"][lp].grad[0],
                              preds[0][lp][1].grad, atol=1e-7)


def test_published_widths_shapes_and_parameter_count(capsys):
    """SPFormer's published decoder (Q 400, D 256, H 8, FFN 1024, 6 layers)
    on the 5-level U-Net of 32-160 channels over a few hundred keys: the
    shapes of its 7 predictions, the parameter count (equal to the
    reference's spec), a finite loss and finite gradients."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.spformer import PUBLISHED
    from treelearn_tpu_torch.train.loop import (batch_to_device,
                                                loss_from_output)

    cfg = {"channels": 32, "num_blocks": 5, "voxel_size": 0.1,
           "head": "spformer", "spformer": dict(PUBLISHED)}
    m = TreeLearn(**cfg).init(0)
    n = sum(p.numel() for p in m.parameters())
    n_dec = sum(p.numel() for p in m.spformer.parameters())
    spec = ref.param_spec(cfg)
    assert n == sum(int(np.prod(s)) for s, kind, _ in spec.values()
                    if kind in ref.TRAINABLE)
    with capsys.disabled():
        print(f"\nSPFormer published decoder: {n_dec} parameters; "
              f"with the 5-level U-Net: {n}")
    assert n_dec == 6_639_107
    m.train()
    batch = _batch()
    sub = np.r_[np.arange(0, 1400, 5), np.arange(1400, 2300, 5)]
    batch = {k: (v[sub] if isinstance(v, np.ndarray) else v)
             for k, v in batch.items()}
    b = batch_to_device(batch, "cpu", instances=True)
    out = m(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
            batch_size=2)
    keys = out["voxel_ranges"][-1][1]
    assert 200 < keys < 500
    assert len(out["pred_logits"]) == 7
    for lp in range(7):
        assert out["pred_logits"][lp].shape == (2, 400, 2)
        assert out["pred_scores"][lp].shape == (2, 400)
        for e, (s, end) in enumerate(out["voxel_ranges"]):
            assert out["pred_masks"][lp][e].shape == (400, end - s)
    loss, _ = loss_from_output(out, b)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in m.parameters()
               if p.grad is not None)


def test_unknown_head_raises():
    from treelearn_tpu_torch.model import TreeLearn

    with pytest.raises(ValueError, match="unknown head"):
        TreeLearn(head="mask3d")


@pytest.mark.parametrize("kwargs,match", [
    ({"backbone": "ptv3", "head": "spformer"}, "runs on backbone 'unet'"),
    ({"spformer": {"num_query": 8}}, "spformer keys given"),
    ({"head": "spformer", "spformer": {"dropout": 0.1}}, "not implemented"),
    ({"head": "spformer", "spformer": {"num_querys": 8}}, "unknown key"),
], ids=["ptv3", "offset_head", "dropout", "typo"])
def test_head_refusals(kwargs, match):
    from treelearn_tpu_torch.model import TreeLearn

    with pytest.raises(ValueError, match=match):
        TreeLearn(**kwargs)


def test_pipeline_refuses_spformer(tmp_path):
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    cfg = ConfigDict({"model": dict(MODEL), "forest_path": str(tmp_path)})
    with pytest.raises(ValueError, match="query masks"):
        run_treelearn_pipeline(cfg, device="cpu")


def test_train_steps_through_loader_then_instances(tmp_path):
    """Three ``make_train_step`` steps of the small model over
    ``TreeLoader`` batches of synthetic crops (finite losses, every leaf
    but the unreached score head moved), then ``make_eval_step`` and
    ``spformer_instances``: each instance a point mask of at least
    ``npoint_thr`` points of its own element, scores in (0, 1]."""
    from treelearn_tpu_torch.data import TreeDataset, TreeLoader
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest)
    from treelearn_tpu_torch.model.spformer import spformer_instances
    from treelearn_tpu_torch.train.loop import (build_optimizer,
                                                make_eval_step,
                                                make_train_step)

    for i in range(2):
        data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                        points_per_tree=400,
                                        ground_points=800, seed=i)
        make_crop_npz(str(tmp_path / f"crop_{i}.npz"), data,
                      np.zeros((len(data), 1)))
    ds = TreeDataset(str(tmp_path), inner_square_edge_length=4,
                     training=True, data_augmentations={
                         "jitter": True, "flip": True, "rot": True,
                         "scaled": True, "point_jitter": True}, seed=0)
    loader = TreeLoader(ds, batch_size=2, training=True, seed=0,
                        num_workers=0)
    model, _, _ = _model()
    w0 = {k: v.clone() for k, v in model.named_parameters()}
    opt, sched = build_optimizer(list(model.parameters()),
                                 {"type": "AdamW", "lr": 0.003,
                                  "weight_decay": 0.001})
    step = make_train_step(model, opt, sched, batch_size=2,
                           compute_dtype=torch.float32, grad_norm_clip=True,
                           device="cpu")
    losses, last = [], None
    for _ in range(3):
        for batch in loader:
            losses.append(float(step(batch)[0]))
            last = batch
    assert len(losses) == 3 and np.isfinite(losses).all()
    still = {k for k, v in model.named_parameters()
             if torch.equal(v, w0[k])}
    assert not {k for k in still if "out_score" not in k}
    out = make_eval_step(model, batch_size=2)(last)
    assert len(out["pred_masks"]) == SMALL["num_layer"] + 1
    insts = spformer_instances(out, topk_insts=8, score_thr=0.0,
                               npoint_thr=5)
    bid = torch.from_numpy(np.asarray(last["batch_ids"]))
    for e, r in enumerate(insts):
        assert r["masks"].shape[1] == len(bid)
        assert len(r["scores"]) <= 8
        assert bool((r["scores"] > 0).all() and (r["scores"] <= 1).all())
        if len(r["scores"]):
            assert bool((r["masks"].sum(1) >= 5).all())
            assert not r["masks"][:, bid != e].any()


def test_spans_and_counters_of_a_step():
    """The fixed span names and the counters of one training step under a
    span timer; the open pairs a layer are the records'."""
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step
    from treelearn_tpu_torch.utils.trace import SpanTimer, counter_totals

    model, _, _ = _model()
    model.spformer.record = []
    opt, _ = build_optimizer(list(model.parameters()), {"lr": 1e-3})
    step = make_train_step(model, opt, batch_size=2,
                           compute_dtype=torch.float32, device="cpu")
    t0 = time.time_ns()
    with SpanTimer("cpu") as timer:
        step(_batch())
    c = counter_totals(t0, time.time_ns())
    names = set(timer.summary())
    for n in ("spformer.decoder", "spformer.proj", "spformer.layer1",
              "spformer.layer2", "spformer.cross_attn", "spformer.self_attn",
              "spformer.ffn", "spformer.pred0", "spformer.pred2",
              "spformer.match", "spformer.loss"):
        assert n in names, n
    rec = model.spformer.record[0]
    assert c["spformer.keys"] == 1992
    for lyr in (1, 2):
        assert c[f"spformer.open_pairs.l{lyr}"] == rec["open_pairs"][lyr - 1]
        # 1 query tile x ceil(K_b / 64) key blocks of each element
        tiles = c[f"spformer.mask_attn.tiles.l{lyr}"]
        assert tiles == sum(-(-k // 64) for k in (1290, 702))
        assert 0 <= c[f"spformer.mask_attn.tiles_skipped.l{lyr}"] <= tiles
    assert c["spformer.targets"] == 8
    assert c["spformer.matched"] == 8 * (SMALL["num_layer"] + 1)


def test_profile_step_open_shares():
    from treelearn_tpu_torch.tools.profile_step import open_shares

    c = {"spformer.keys": 1000, "spformer.open_pairs.l1": 8000,
         "spformer.open_pairs.l2": 2000}
    assert open_shares(c, 16) == [0.5, 0.125]


def test_profile_step_trains_spformer(tmp_path):
    """``tools/profile_step.py --train --head spformer`` on the CPU at a
    small size, traced: finite losses and one open share a layer."""
    from treelearn_tpu_torch.tools.profile_step import main

    res = main(["--train", "--device", "cpu", "--head", "spformer",
                "--levels", "2", "--channels", "8", "--steps", "2",
                "--crops", "1", "--crop-extent", "6", "--ppt", "300", "400",
                "--trace", str(tmp_path)])
    assert np.isfinite(res["losses"]).all()
    assert len(res["open_share"]) == 6
    assert all(0 < s <= 1 for s in res["open_share"])
    assert os.path.exists(tmp_path / "train_step.trace.json")


def test_train_cli_trains_spformer(tmp_path, monkeypatch):
    """``tools/train.py`` with ``model.head: spformer`` runs one epoch on
    two tiny crops: a checkpoint that the model loads again, the four loss
    terms logged, and a validation record of instances a crop."""
    import json

    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.checkpoint import resume_checkpoint
    from treelearn_tpu_torch.tools import train

    for split, seeds in (("train", (1, 2)), ("val", (3,))):
        d = tmp_path / split
        d.mkdir()
        for s in seeds:
            data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                            points_per_tree=200,
                                            ground_points=500, seed=s)
            data[:, :2] -= data[:, :2].mean(0)
            make_crop_npz(str(d / f"c{s}.npz"), data, verticality_proxy(data))
    cfg = tmp_path / "spf.yaml"
    cfg.write_text(f"""
model: {{channels: 4, num_blocks: 2, spatial_shape: [128, 128, 64],
        voxel_size: 0.1, head: spformer,
        spformer: {{num_query: 8, d_model: 16, nhead: 2, hidden_dim: 32,
                   num_layer: 1, npoint_thr: 5}}}}
dataset_train: {{training: true, data_root: '{tmp_path / "train"}',
                inner_square_edge_length: 4,
                data_augmentations: {{jitter: true, flip: true, rot: true,
                                      scaled: true, point_jitter: true}}}}
dataset_test: {{training: false, data_root: '{tmp_path / "val"}',
               inner_square_edge_length: 4}}
dataloader: {{train: {{batch_size: 1, num_workers: 0}},
             test: {{batch_size: 1, num_workers: 0}}}}
optimizer: {{type: AdamW, lr: 0.003, weight_decay: 0.001}}
scheduler: {{t_initial: 10, lr_min: 0.00005, warmup_lr_init: 0.00001,
            warmup_t: 2}}
epochs: 1
examples_per_epoch: 2
fp16: false
grad_norm_clip: true
save_frequency: 1
validation_frequency: 1
""")
    monkeypatch.chdir(tmp_path)
    model = train.main(["--config", str(cfg), "--device", "cpu"])
    work = tmp_path / "work_dirs" / "spf"
    tags = {json.loads(line)["tag"]
            for line in (work / "scalars.jsonl").read_text().splitlines()}
    assert tags == {"train/class_loss", "train/bce_loss", "train/dice_loss",
                    "train/score_loss", "val/instances"}
    again = TreeLearn(channels=4, num_blocks=2, head="spformer", spformer={
        "num_query": 8, "d_model": 16, "nhead": 2, "hidden_dim": 32,
        "num_layer": 1})
    resume_checkpoint(str(work / "epoch_1.pth"), again)
    for (k, v), (_, w) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(v, w), k
