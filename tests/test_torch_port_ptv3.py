"""Point Transformer V3 as the port's backbone (``TreeLearn(backbone=
"ptv3")``, model/ptv3.py, ops/serialize.py) against the plain float32
reference ``tests/reference_ptv3.py`` on seeded random weights: a small
PTv3 that keeps every mechanism (3 stages of widths 16, 32, 64, head dim 8,
patch 16, two batch elements of unequal size, so that padding and a stage
with K below the patch size both happen, DropPath and the order shuffles
drawn), and the serialization and padding properties."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import reference_ptv3 as ref

torch.set_num_threads(1)

SMALL = {
    "order": ("z", "z-trans", "hilbert", "hilbert-trans"),
    "stride": (2, 2), "enc_depths": (2, 2, 4), "enc_channels": (16, 32, 64),
    "enc_num_head": (2, 4, 8), "enc_patch_size": (16, 16, 16),
    "dec_depths": (2, 2), "dec_channels": (16, 32), "dec_num_head": (2, 4),
    "dec_patch_size": (16, 16), "mlp_ratio": 4, "qkv_bias": True,
    "drop_path": 0.3, "shuffle_orders": True, "seed": 7,
}
VOXEL = 0.1


def _model(seed=3):
    from treelearn_tpu_torch.model import TreeLearn

    return TreeLearn(backbone="ptv3", ptv3=dict(SMALL),
                     voxel_size=VOXEL).init(seed)


def _batch(seed=0):
    """Two crops of unequal size (1,400 and 500 points; the second one's
    deepest stage holds fewer tokens than a patch), 64 padding rows, labels
    for the loss."""
    g = np.random.default_rng(seed)
    a = g.uniform([0, 0, 0], [1.6, 1.6, 3.0], (1400, 3))
    b = g.uniform([0, 0, 0], [0.6, 0.6, 1.2], (500, 3)) + 5.0
    pad = np.zeros((64, 3))
    xyz = np.concatenate([a, b, pad]).astype(np.float32)
    n = len(xyz)
    bid = np.r_[np.zeros(1400), np.ones(500), np.zeros(64)].astype(np.int32)
    valid = np.r_[np.ones(1900, bool), np.zeros(64, bool)]
    return {
        "coords": torch.from_numpy(xyz),
        "input_feats": torch.zeros(n, 1),
        "batch_ids": torch.from_numpy(bid),
        "valid": torch.from_numpy(valid),
        "masks_sem": torch.from_numpy(g.random(n) < 0.8),
        "masks_off": torch.from_numpy(g.random(n) < 0.6),
        "semantic_labels": torch.from_numpy(g.integers(0, 2, n)),
        "offset_labels": torch.from_numpy(
            g.normal(size=(n, 3)).astype(np.float32)),
    }


def _ref_forward(model, b, draws, training):
    params = {k: v.detach().clone().requires_grad_(v.is_floating_point())
              for k, v in model.state_dict().items()}
    f = ref.Forward(params, SMALL, draws, training)
    sem, off = f(b["coords"], b["batch_ids"], b["valid"], 2, VOXEL)
    return params, sem, off


@pytest.fixture(scope="module")
def trained_pass():
    """The port's training forward, loss and gradients on the small
    batch, with its draws recorded; the reference's on the same draws."""
    from treelearn_tpu_torch.train.loop import loss_from_output

    model = _model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    model.ptv3.record_draws = True
    b = _batch()
    out = model(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
                batch_size=2)
    loss, _ = loss_from_output(out, b)
    loss.backward()
    draws = list(model.ptv3.draws)
    model.load_state_dict(before)   # the running statistics as they were
    params, sem, off = _ref_forward(model, b, draws, True)
    rloss = ref.loss_of(sem, off, b)
    rloss.backward()
    return model, b, out, loss, draws, params, sem, off, rloss


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


# -- serialization ------------------------------------------------------------

@pytest.mark.parametrize("order", ref.ORDERS)
def test_codes_equal_reference(order):
    from treelearn_tpu_torch.ops.serialize import encode

    g = torch.Generator().manual_seed(1)
    grid = torch.randint(0, 600, (3000, 3), generator=g)
    batch = torch.randint(0, 3, (3000,), generator=g)
    depth = int(grid.max()).bit_length()
    got = encode(grid, batch, depth, order)
    want = ref.encode(grid, batch, depth, order)
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hilbert_steps_are_face_neighbours(depth):
    """On a full 2^d cube, consecutive Hilbert codes are face neighbours
    and the codes are 0 .. 8^d - 1."""
    from treelearn_tpu_torch.ops.serialize import hilbert_code

    ax = torch.arange(1 << depth)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    code = hilbert_code(grid, depth)
    assert torch.equal(torch.sort(code).values, torch.arange(len(grid)))
    walk = grid[torch.argsort(code)]
    step = (walk[1:] - walk[:-1]).abs().sum(1)
    assert bool((step == 1).all())


@pytest.mark.parametrize("order", ref.ORDERS)
def test_parent_code_is_code_shifted(order):
    """``code >> 3`` is the code of the parent cell (``grid >> 1``, depth
    - 1), the batch element kept."""
    from treelearn_tpu_torch.ops.serialize import encode

    g = torch.Generator().manual_seed(2)
    grid = torch.randint(0, 1000, (4000, 3), generator=g)
    batch = torch.randint(0, 2, (4000,), generator=g)
    depth = int(grid.max()).bit_length()
    assert torch.equal(encode(grid, batch, depth, order) >> 3,
                       encode(grid >> 1, batch, depth - 1, order))


@pytest.mark.parametrize("counts,patch", [
    ([37, 20], 16), ([64, 32], 16), ([5, 40, 23], 16), ([1000, 3000], 1024),
    ([17], 16), ([0, 9, 30], 16)])
def test_pad_unpad_bijection(counts, patch):
    """Every real row is a padded row once, and back; every patch has K
    rows of one element, its pad rows real rows of that element from the
    patch before; the reference's padding gives the same rows."""
    from treelearn_tpu_torch.ops.serialize import patch_layout

    lay = patch_layout(counts, patch, "cpu")
    n = sum(counts)
    assert lay.k == min(patch, min(c for c in counts if c))
    assert lay.n_pad % lay.k == 0 and lay.pad_rows == lay.n_pad - n
    assert torch.equal(lay.pad_src[lay.unpad], torch.arange(n))
    assert sorted(lay.unpad.tolist()) == sorted(set(lay.unpad.tolist()))
    elem = torch.repeat_interleave(torch.arange(len(counts)),
                                   torch.tensor(counts))
    pe = elem[lay.pad_src].view(-1, lay.k)
    assert bool((pe == pe[:, :1]).all())
    real = torch.zeros(lay.n_pad, dtype=torch.bool)
    real[lay.unpad] = True
    pads = torch.nonzero(~real).squeeze(1)
    assert torch.equal(lay.pad_src[pads], lay.pad_src[pads - lay.k])
    batch = torch.repeat_interleave(torch.arange(len(counts)),
                                    torch.tensor(counts))
    if min(counts) > 0:
        pad, unpad, k = ref.padding_and_inverse(batch, patch)
        assert k == lay.k
        assert torch.equal(pad, lay.pad_src) and torch.equal(unpad, lay.unpad)


def test_orders_are_argsort_and_inverse():
    from treelearn_tpu_torch.ops.serialize import orders

    g = torch.Generator().manual_seed(4)
    grid = torch.randint(0, 50, (500, 3), generator=g).unique(dim=0)
    batch = torch.zeros(len(grid), dtype=torch.long)
    codes, order, inverse = orders(grid, batch, 6, ref.ORDERS)
    r_order, r_inverse = ref.argsort_inverse(codes)
    assert torch.equal(order, r_order) and torch.equal(inverse, r_inverse)


# -- the model against the reference -----------------------------------------

def test_small_model_has_every_mechanism(trained_pass):
    model, b, out, *_ = trained_pass
    tokens = out["n_voxels_per_level"].tolist()
    assert len(tokens) == 3 and tokens[0] > tokens[1] > tokens[2]
    kinds = [d[0] for d in trained_pass[4]]
    assert kinds.count("perm") == 3 and kinds.count("keep") > 10
    # the smaller crop's deepest stage holds fewer tokens than a patch
    _, _, v2p = ref.voxelize(b["coords"], b["batch_ids"], b["valid"], 2,
                             VOXEL)
    grid, batch, _ = ref.voxelize(b["coords"], b["batch_ids"], b["valid"],
                                  2, VOXEL)
    deep = torch.unique(torch.cat([batch[:, None], grid >> 2], 1), dim=0)
    assert int((deep[:, 0] == 1).sum()) < 16 < int((deep[:, 0] == 0).sum())


def test_forward_equals_reference(trained_pass):
    _, _, out, _, _, _, sem, off, _ = trained_pass
    valid = trained_pass[1]["valid"]
    # float32 on both sides; sums in another order
    assert _rel(out["semantic_prediction_logits"][valid], sem[valid]) < 1e-5
    assert _rel(out["offset_predictions"][valid], off[valid]) < 1e-5


def test_loss_equals_reference(trained_pass):
    loss, rloss = trained_pass[3], trained_pass[8]
    assert abs(float(loss.detach()) - float(rloss.detach())) <= 1e-5 * abs(
        float(rloss.detach()))


def test_every_leaf_gradient_equals_reference(trained_pass):
    model, params = trained_pass[0], trained_pass[5]
    grads = dict(model.named_parameters())
    gnorms = {k: float(params[k].grad.norm()) for k in grads}
    med = float(np.median(list(gnorms.values())))
    assert set(grads) == {k for k, v in params.items()
                          if v.requires_grad and not k.endswith(
                              ("running_mean", "running_var"))}
    for k, p in grads.items():
        g, rg = p.grad, params[k].grad
        # a leaf's gap against the larger of its own and the median leaf's
        # norm: float32 sums in another order, through ~20 layers
        gap = float((g.double() - rg.double()).norm()) / max(gnorms[k], med)
        assert gap < 2e-4, (k, gap)


def test_one_adamw_step_equals_reference(trained_pass):
    """``make_train_step`` (AdamW, clip 1.0, the schedule's first lr) from
    the same weights and draws against the reference's step."""
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    model, b, *_ = trained_pass
    draws = trained_pass[4]
    m2 = _model()
    w0 = {k: v.clone() for k, v in m2.state_dict().items()}
    opt, sched = build_optimizer(
        [p for p in m2.parameters()], {"type": "AdamW", "lr": 0.003,
                                       "weight_decay": 0.001},
        {"t_initial": 10, "warmup_t": 0, "lr_min": 1e-4}, steps_per_epoch=1)
    step = make_train_step(m2, opt, sched, batch_size=2,
                           compute_dtype=torch.float32, grad_norm_clip=True,
                           device="cpu")
    batch = {k: v.numpy() for k, v in b.items()}
    step(batch)
    params = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in w0.items()}
    f = ref.Forward(params, SMALL, draws, True)
    sem, off = f(b["coords"], b["batch_ids"], b["valid"], 2, VOXEL)
    leaves = [k for k, _ in m2.named_parameters()]
    loss = ref.loss_of(sem, off, b)
    gr = torch.autograd.grad(loss, [params[k] for k in leaves])
    new = ref.adamw_step({k: w0[k] for k in leaves}, dict(zip(leaves, gr)),
                         0.003, 0.001, {}, 1)
    got = dict(m2.named_parameters())
    deltas = {k: float((new[k] - w0[k]).norm()) for k in leaves}
    med = float(np.median(list(deltas.values())))
    gn = {k: float(g.norm()) for k, g in zip(leaves, gr)}
    gmed = float(np.median(list(gn.values())))
    # a leaf whose gradient is zero in exact arithmetic (a bias before a
    # BatchNorm) takes a step of +-lr on rounding noise: left out
    noise = {k for k in leaves if gn[k] < 1e-3 * gmed}
    assert noise and all(k.endswith("bias") for k in noise)
    for k in sorted(set(leaves) - noise):
        # the first AdamW step moves a leaf by ~lr sign(g): a gradient
        # entry near zero may take either sign, so compare the change's
        # norm against the median leaf's change
        gap = float((got[k].detach() - new[k]).norm()) / max(deltas[k], med)
        assert gap < 0.05, (k, gap)


def test_eval_forward_equals_reference():
    """Eval mode: BatchNorm's running statistics, no DropPath, the order
    shuffles still drawn."""
    model = _model(seed=11)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.uniform_(-0.1, 0.1)
            elif k.endswith("running_var"):
                v.uniform_(0.8, 1.2)
    model.eval()
    model.ptv3.record_draws = True
    b = _batch(seed=1)
    with torch.no_grad():
        out = model(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
                    batch_size=2)
    draws = list(model.ptv3.draws)
    assert [d[0] for d in draws] == ["perm"] * 3
    _, sem, off = _ref_forward(model, b, draws, False)
    v = b["valid"]
    assert _rel(out["semantic_prediction_logits"][v], sem[v]) < 1e-5
    assert _rel(out["offset_predictions"][v], off[v]) < 1e-5


def test_shuffles_follow_the_seed():
    """Two models of one seed draw the same permutations; without
    ``shuffle_orders`` none are drawn."""
    b = _batch(seed=2)
    runs = []
    for shuffle in (True, True, False):
        m = _model()
        m.ptv3.shuffle_orders = shuffle
        m.eval()
        m.ptv3.record_draws = True
        with torch.no_grad():
            m(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
              batch_size=2)
        runs.append([d[1] for d in m.ptv3.draws])
    assert runs[0] == runs[1] and len(runs[0]) == 3 and runs[2] == []


# -- construction, checkpoints ------------------------------------------------

def test_unknown_backbone_raises():
    from treelearn_tpu_torch.model import TreeLearn

    with pytest.raises(ValueError, match="unknown backbone"):
        TreeLearn(backbone="pointnet")


@pytest.mark.parametrize("bad", [{"enable_rpe": True}, {"cls_mode": True},
                                 {"enable_flash": False},
                                 {"no_such_key": 1}, {"stride": (4, 2)},
                                 {"in_channels": 6}])
def test_ptv3_refuses_what_it_does_not_implement(bad):
    from treelearn_tpu_torch.model import TreeLearn

    with pytest.raises(ValueError, match="ptv3"):
        TreeLearn(backbone="ptv3", ptv3=dict(SMALL, **bad))


def test_published_widths_count():
    """The published base model: 46.2 M parameters with the heads."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.ptv3 import PUBLISHED

    m = TreeLearn(backbone="ptv3", ptv3=dict(PUBLISHED))
    n = sum(p.numel() for p in m.parameters())
    assert 45_000_000 < n < 47_000_000
    assert m.channels == 64


def test_unet_checkpoint_importer_refuses_ptv3(tmp_path):
    from treelearn_tpu_torch.model import TreeLearn, load_checkpoint
    from treelearn_tpu_torch.model.checkpoint import (resume_checkpoint,
                                                      save_checkpoint)

    unet = TreeLearn(channels=8, num_blocks=2).init(0)
    path = str(tmp_path / "unet.pth")
    save_checkpoint(path, unet)
    m = _model()
    with pytest.raises(ValueError, match="U-Net weights"):
        load_checkpoint(path, m)
    own = str(tmp_path / "ptv3.pth")
    save_checkpoint(own, m)
    m2 = TreeLearn(backbone="ptv3", ptv3=dict(SMALL), voxel_size=VOXEL)
    resume_checkpoint(own, m2)
    for k, v in m.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k])


# -- on the port's normal paths ----------------------------------------------

def _pipeline_config(forest_path, whole_plot):
    from treelearn_tpu_torch.config import ConfigDict

    return ConfigDict.from_dict({
        "forest_path": forest_path, "pretrain": None, "fp16": False,
        "tile_generation": True, "whole_plot": whole_plot,
        "model": {"backbone": "ptv3", "ptv3": dict(SMALL),
                  "use_feats": False, "use_coords": False, "dim_coord": 3,
                  "dim_feat": 1, "max_num_points_per_voxel": 3,
                  "fixed_modules": [], "spatial_shape": [500, 500, 1000],
                  "voxel_size": 0.1},
        "sample_generation": {
            "voxel_size": 0.1, "search_radius_features": 0.6,
            "inner_edge": 6, "outer_edge": 3, "stride": 1,
            "sample_generator": {"n_neigh_sor": None, "multiplier_sor": None,
                                 "rad": None, "npoints_rad": None}},
        "grouping": {"tree_conf_thresh": 0.5, "tau_vert": 0.6, "tau_off": 4,
                     "tau_group": 0.15, "tau_min": 50, "use_hdbscan": False},
        "dataloader": {"batch_size": 2, "num_workers": 0},
        "dataset_test": {"training": False, "data_root": "",
                         "inner_square_edge_length": 6},
        "shape_cfg": {"outer_remove": None, "alpha": 0.6,
                      "buffer_size_to_determine_edge_trees": 0.3},
        "save_cfg": {"save_formats": ["npz"], "save_treewise": False,
                     "save_pointwise": True, "return_type": "original",
                     "results_dir": "results"},
    })


@pytest.mark.parametrize("whole_plot", [True, False],
                         ids=["whole_plot", "tiles"])
def test_pipeline_runs_ptv3(tmp_path, whole_plot):
    """A small plot through ``run_treelearn_pipeline`` with the small PTv3
    in whole-plot and in tile mode: every point labelled, the pointwise
    dump's logits finite and of the backbone's width."""
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    data, _ = make_synthetic_forest(n_trees=3, extent=10, points_per_tree=600,
                                    ground_points=2000, seed=5)
    d = tmp_path / "forest"
    os.makedirs(d)
    path = str(d / "mini.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    res = run_treelearn_pipeline(_pipeline_config(path, whole_plot),
                                 device="cpu")
    assert res is not None
    dumps = [osp.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs
             if f.endswith(".npz") and "pointwise" in f]
    assert dumps
    z = np.load(dumps[0])
    assert np.isfinite(z["semantic_prediction_logits"]).all()
    if "backbone_feats" in z.files:
        assert z["backbone_feats"].shape[1] == SMALL["dec_channels"][0]


def test_train_step_runs_ptv3_through_loader(tmp_path):
    """Three ``make_train_step`` steps of the small PTv3 over
    ``TreeLoader`` batches of synthetic crops: finite losses, every leaf
    moved."""
    from treelearn_tpu_torch.data import TreeDataset, TreeLoader
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest)
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

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
    model = _model()
    w0 = {k: v.clone() for k, v in model.named_parameters()}
    opt, sched = build_optimizer(list(model.parameters()),
                                 {"type": "AdamW", "lr": 0.003,
                                  "weight_decay": 0.001})
    step = make_train_step(model, opt, sched, batch_size=2,
                           compute_dtype=torch.float32, grad_norm_clip=True,
                           device="cpu")
    losses = []
    for _ in range(3):
        for batch in loader:
            losses.append(float(step(batch)[0]))
    assert len(losses) == 3 and np.isfinite(losses).all()
    moved = [k for k, v in model.named_parameters()
             if not torch.equal(v, w0[k])]
    assert len(moved) == len(w0)


def test_spans_and_counters_of_a_forward():
    """The fixed span names and the per-stage counters of one forward
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from treelearn_tpu_torch.utils.trace import counter_totals

    import time

    model = _model()
    model.train()
    b = _batch()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
              batch_size=2)
    t1 = time.time_ns()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    for n in ("ptv3.serialize", "ptv3.embed", "ptv3.enc0", "ptv3.enc2",
              "ptv3.dec0", "ptv3.dec1", "ptv3.pool", "ptv3.unpool",
              "ptv3.cpe", "ptv3.attn", "ptv3.mlp"):
        assert n in names, n
    c = counter_totals(t0, t1)
    for s in range(3):
        assert c[f"ptv3.tokens.s{s}"] > 0
        assert f"ptv3.pad_rows.s{s}" in c and c[f"ptv3.patches.s{s}"] > 0


def test_selftrain_trains_ptv3(tmp_path):
    """``train/selftrain.py`` trains the small PTv3 from a model config and
    writes a checkpoint that the model loads again."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.checkpoint import resume_checkpoint
    from treelearn_tpu_torch.train.selftrain import train_synthetic_checkpoint

    mc = {"backbone": "ptv3", "ptv3": dict(SMALL), "voxel_size": VOXEL}
    path, info = train_synthetic_checkpoint(
        mc, str(tmp_path), steps=3, n_crops=2, crop_extent=12.0, ppt=300,
        device="cpu", compute_dtype=torch.float32, return_info=True)
    assert info["complete"] and len(info["losses"]) == 3
    assert np.isfinite(info["losses"]).all()
    m = TreeLearn(**mc)
    resume_checkpoint(path, m)
    assert m.ptv3.enc[0].blocks[0].attn.qkv.weight.abs().sum() > 0
