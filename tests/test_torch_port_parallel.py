"""treelearn_tpu_torch data parallelism (parallel/mesh.py) on the CPU: two
``gloo`` ranks, spawned and joined through a file store in ``tmp_path``
(parallel/launch.py), against the JAX package's ``make_dp_train_step`` on
a 2-device CPU mesh (conftest forces 8 devices) and against the port's own
single-process paths: the DP gradient, three AdamW + clip steps, DP
inference, the pipeline with ``dist: true`` and ``tools/train.py --dist``.
Each spawn has a time limit, so a hung rank fails its test."""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT = 240.0
CFG = dict(channels=8, num_blocks=3, spatial_shape=[128, 128, 64],
           voxel_size=0.1, use_coords=True, use_feats=True)
OPTIM = {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-3}
SCHED = {"t_initial": 10, "warmup_t": 1, "lr_min": 1e-4,
         "warmup_lr_init": 1e-4}


def _spawn(fn, tmp_path, *args):
    from treelearn_tpu_torch.parallel.launch import spawn_ranks

    spawn_ranks(fn, WORLD, str(tmp_path / "store"), *args,
                timeout=SPAWN_TIMEOUT)


def _dump(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dp_batches(tmp_path, n_steps):
    """``n_steps`` collate_dp stacks of two single-crop shards (no
    augmentation) from the port's loader machinery."""
    from treelearn_tpu_torch.data.dataset import TreeDataset, collate_dp
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)

    d = tmp_path / "crops"
    d.mkdir()
    for i in range(WORLD * n_steps):
        data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                        points_per_tree=300,
                                        ground_points=800, seed=i + 1)
        data[:, :2] -= data[:, :2].mean(0)
        make_crop_npz(str(d / f"c{i}.npz"), data, verticality_proxy(data))
    ds = TreeDataset(str(d), inner_square_edge_length=4.0, training=True,
                     data_augmentations={})
    return [collate_dp([ds[WORLD * s + r] for r in range(WORLD)], WORLD, 1,
                       min_bucket=2048) for s in range(n_steps)]


def _dp_train_rank(init_method, tmp, optim):
    """One rank: ``make_dp_train_step`` from the JAX weights over the
    saved batches; writes its losses, gradients and state."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.parallel import init_dp, make_dp_train_step
    from treelearn_tpu_torch.train.loop import build_optimizer

    torch.set_num_threads(1)
    group = init_dp("gloo", init_method, device="cpu")
    model = TreeLearn(**CFG)
    model.load_state_dict(torch.load(osp.join(tmp, "init.pt")))
    if optim == "sgd":
        opt, sch, clip = torch.optim.SGD(model.parameters(), lr=1.0), None, None
    else:
        (opt, sch), clip = build_optimizer(model.parameters(), OPTIM, SCHED,
                                           1), True
    step = make_dp_train_step(model, opt, sch, group, batch_size=1,
                              compute_dtype=torch.float32,
                              grad_norm_clip=clip)
    losses, lrs = [], []
    for batch in _load(osp.join(tmp, "batches.pkl")):
        lrs.append(opt.param_groups[0]["lr"])
        loss, ld = step(batch)
        losses.append((float(loss), {k: float(v) for k, v in ld.items()}))
    torch.save({"losses": losses, "lrs": lrs, "state": model.state_dict(),
                "grads": {k: p.grad for k, p in model.named_parameters()}},
               osp.join(tmp, f"rank{group.rank}.pt"))
    torch.distributed.destroy_process_group()


def _jax_dp(optimizer, batches, params, state):
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu.parallel import make_dp_train_step, make_mesh

    jm = JaxTreeLearn(**CFG)
    step, _, _ = make_dp_train_step(jm, optimizer, make_mesh(WORLD),
                                    batch_size=1, voxel_capacity=8192,
                                    compute_dtype=jnp.float32,
                                    fast_conv=False)
    params = jax.tree.map(jnp.copy, params)
    state = jax.tree.map(jnp.copy, state)
    opt_state = optimizer.init(params)
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()
              if isinstance(v, np.ndarray)}
        params, state, opt_state, loss, ld = step(params, state, opt_state, jb)
        assert bool(ld["_caps_ok"]), "capacity gate tripped"
        losses.append((float(loss), float(ld["semantic_loss"]),
                       float(ld["offset_loss"])))
    return params, state, losses


def _setup(tmp_path, n_steps):
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu_torch.model import params_from_jax_numpy

    batches = _dp_batches(tmp_path, n_steps)
    params, state = JaxTreeLearn(**CFG).init(0)
    init = params_from_jax_numpy(jax.device_get(params),
                                 jax.device_get(state))
    torch.save(init, tmp_path / "init.pt")
    _dump(batches, tmp_path / "batches.pkl")
    return batches, params, state, init


def _ranks(tmp_path):
    out = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    for k, v in out[0]["state"].items():
        assert torch.equal(v, out[1]["state"][k]), k
    assert out[0]["losses"] == out[1]["losses"]
    return out[0]


def test_dp_gradient_matches_jax_dp_step(tmp_path):
    """One step with SGD(lr=1) on 2 gloo ranks against JAX
    make_dp_train_step with optax.sgd(1.0) on a 2-device mesh, same weights
    and collate_dp batch: the loss and its two parts within rtol 1e-5; each
    parameter's gradient (JAX: params - new params) within 1e-3 of that
    tensor's max |g|, as the one-step card-vs-CPU check holds it; the
    Linear biases before a BatchNorm, zero in exact arithmetic, are left
    out.  BatchNorm running statistics within 1e-5 of the JAX pmean'd
    state, bit-equal across ranks."""
    import optax

    from treelearn_tpu_torch.model import params_from_jax_numpy

    batches, params, state, init = _setup(tmp_path, 1)
    new_params, new_state, jlosses = _jax_dp(optax.sgd(1.0), batches, params,
                                             state)
    _spawn(_dp_train_rank, tmp_path, str(tmp_path), "sgd")
    got = _ranks(tmp_path)
    loss, ld = got["losses"][0]
    np.testing.assert_allclose(loss, jlosses[0][0], rtol=1e-5)
    np.testing.assert_allclose(ld["semantic_loss"], jlosses[0][1], rtol=1e-5)
    np.testing.assert_allclose(ld["offset_loss"], jlosses[0][2], rtol=1e-5)
    want = params_from_jax_numpy(jax.device_get(new_params),
                                 jax.device_get(new_state))
    checked = 0
    for k, g in got["grads"].items():
        if k.endswith("_linear.0.bias"):
            continue
        g_want = init[k] - want[k]
        scale = float(g_want.abs().max())
        err = float((g - g_want).abs().max())
        assert err <= 1e-3 * scale + 1e-7, (k, err, scale)
        checked += 1
    assert checked > 20
    for k, v in got["state"].items():
        if k.endswith(("running_mean", "running_var")):
            err = float((v - want[k]).abs().max())
            assert err <= 1e-5, (k, err)


def test_dp_adamw_trajectory_matches_jax(tmp_path):
    """Three AdamW + warmup cosine + clip steps on 2 ranks against the JAX
    DP trajectory: losses within rtol 1e-5; each parameter's update within
    5e-3 of the summed learning rate, running statistics within 1e-5, with
    the exclusions of the single-device three-step test (the Linear biases
    before a BatchNorm, and that BatchNorm's running_mean at 1e-4)."""
    from treelearn_tpu.train.loop import build_optimizer as jax_optimizer
    from treelearn_tpu_torch.model import params_from_jax_numpy

    batches, params, state, init = _setup(tmp_path, 3)
    new_params, new_state, jlosses = _jax_dp(
        jax_optimizer(OPTIM, SCHED, 1, True), batches, params, state)
    _spawn(_dp_train_rank, tmp_path, str(tmp_path), "adamw")
    got = _ranks(tmp_path)
    for (loss, _), jl in zip(got["losses"], jlosses):
        np.testing.assert_allclose(loss, jl[0], rtol=1e-5)
    lr_sum = sum(got["lrs"])
    want = params_from_jax_numpy(jax.device_get(new_params),
                                 jax.device_get(new_state))
    for k, v in got["state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 3, k
            continue
        d_got, d_want = v - init[k], want[k] - init[k]
        if k.endswith("_linear.0.bias"):
            tol = lr_sum
        elif k.endswith("_linear.1.running_mean"):
            tol = 1e-4
        elif k.endswith(("running_mean", "running_var")):
            tol = 1e-5
        else:
            tol = 5e-3 * lr_sum
        err = float((d_got - d_want).abs().max())
        assert err <= tol, (k, err, tol)


def _tile_batches():
    from treelearn_tpu_torch.data import collate_padded

    rng = np.random.default_rng(7)
    batches = []
    for i in range(5):  # not divisible by 2: ranks forward 3 and 2
        pts = 500
        sample = {
            "coords": rng.uniform(0, 5, (pts, 3)).astype(np.float32),
            "input_feats": np.ones((pts, 1), np.float32),
            "semantic_labels": rng.integers(0, 2, pts).astype(np.int64),
            "offset_labels": rng.normal(size=(pts, 3)).astype(np.float32),
            "instance_labels": rng.integers(0, 4, pts).astype(np.int64),
            "centers": np.full((pts, 3), i, np.float32),
            "masks_inner": rng.random(pts) < 0.7,
            "masks_sem": np.ones(pts, bool),
            "masks_off": np.ones(pts, bool),
            "point_ids": np.arange(i * pts, (i + 1) * pts),
        }
        batches.append(collate_padded([sample], pad_to=1 << 10))
    return batches


def _infer_rank(init_method, tmp):
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.parallel import init_dp
    from treelearn_tpu_torch.pipeline.inference import get_pointwise_preds

    torch.set_num_threads(1)
    group = init_dp("gloo", init_method, device="cpu")
    model = TreeLearn(**dict(CFG, use_coords=False, use_feats=False)).init(1)
    timings = {}
    out = get_pointwise_preds(model, iter(_tile_batches()), group=group,
                              timings=timings)
    _dump({"out": out, "steps": timings["steps"]},
          osp.join(tmp, f"infer{group.rank}.pkl"))
    torch.distributed.destroy_process_group()


def test_dp_inference_matches_single_process(tmp_path):
    """Batch i goes to rank i % 2; rank 0 returns every array in loader
    order, equal to the single-process result; rank 1 returns None."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.pipeline.inference import get_pointwise_preds

    model = TreeLearn(**dict(CFG, use_coords=False, use_feats=False)).init(1)
    single = get_pointwise_preds(model, iter(_tile_batches()), device="cpu")
    _spawn(_infer_rank, tmp_path, str(tmp_path))
    r0, r1 = (_load(tmp_path / f"infer{r}.pkl") for r in range(WORLD))
    assert r1["out"] is None
    assert (r0["steps"], r1["steps"]) == (3, 2)
    assert len(r0["out"]) == len(single) == 9
    for a, b in zip(single, r0["out"]):
        np.testing.assert_array_equal(a, b)


def _pipeline_cfg(forest_path, dist):
    from test_integration import _pipeline_config
    from treelearn_tpu_torch.config import ConfigDict

    config = ConfigDict.from_dict(dict(_pipeline_config(forest_path)))
    config.whole_plot = False  # tiles: several batches to deal out
    config.dist = dist
    return config


def _pipeline_rank(init_method, forest_path, tmp):
    from treelearn_tpu_torch.parallel import init_dp
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    torch.set_num_threads(1)
    group = init_dp("gloo", init_method, device="cpu")
    res = run_treelearn_pipeline(_pipeline_cfg(forest_path, True),
                                 device="cpu")
    with open(osp.join(tmp, f"pipeline{group.rank}.json"), "w") as f:
        json.dump(None if res is None else
                  {k: res[k] for k in ("n_trees", "n_points",
                                       "results_dir")}, f)
    torch.distributed.destroy_process_group()


def _write_plot(root):
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=6, extent=20, points_per_tree=800,
                                    ground_points=4000, seed=3)
    d = root / "plot" / "forest"
    os.makedirs(d)
    path = str(d / "mini.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    return path


def test_dist_pipeline_matches_single_process(tmp_path):
    """run_treelearn_pipeline with ``dist: true, whole_plot: false`` on two
    ranks: rank 0 returns the summary and writes the results, rank 1
    returns None; the pointwise dump equals the single-process run's
    (logits and offsets within 1e-6, instance labels equal), and so do the
    tree count and the full-cloud labels.  Without a process group
    ``dist: true`` runs the single path."""
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    single = run_treelearn_pipeline(
        _pipeline_cfg(_write_plot(tmp_path / "single"), True), device="cpu")
    forest = _write_plot(tmp_path / "dist")
    _spawn(_pipeline_rank, tmp_path, forest, str(tmp_path))
    r0, r1 = (json.loads((tmp_path / f"pipeline{r}.json").read_text())
              for r in range(WORLD))
    assert r1 is None
    assert r0["n_trees"] == single["n_trees"]
    a, b = (np.load(osp.join(d, "pointwise_results", "pointwise_results.npz"))
            for d in (single["results_dir"], r0["results_dir"]))
    assert set(a.files) == set(b.files)
    np.testing.assert_array_equal(a["coords"], b["coords"])
    for k in ("semantic_prediction_logits", "offset_predictions"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a["instance_preds"], b["instance_preds"])
    full = [load_data(osp.join(d, "full_forest", "mini.las"))
            for d in (single["results_dir"], r0["results_dir"])]
    np.testing.assert_array_equal(full[0], full[1])


_TRAIN_YAML = """
model: {{channels: 4, num_blocks: 2, kernel_size: 3, dim_coord: 3, dim_feat: 1,
        use_feats: false, use_coords: false, fixed_modules: [],
        spatial_shape: [128, 128, 64], voxel_size: 0.1,
        max_num_points_per_voxel: 3}}
dataset_train: {{training: true, data_root: '{train}',
                inner_square_edge_length: 4,
                data_augmentations: {{jitter: true, flip: true, rot: true,
                                      scaled: true, point_jitter: true}}}}
dataset_test: {{training: false, data_root: '{val}',
               inner_square_edge_length: 4}}
dataloader: {{train: {{batch_size: 1, num_workers: 0}},
             test: {{batch_size: 1, num_workers: 0}}}}
optimizer: {{type: AdamW, lr: 0.003, weight_decay: 0.001}}
scheduler: {{t_initial: 10, lr_min: 0.00005, warmup_lr_init: 0.00001,
            warmup_t: 2}}
epochs: 1
examples_per_epoch: 4
fp16: false
grad_norm_clip: true
save_frequency: 1
validation_frequency: 1
"""


def _train_rank(init_method, cfg, tmp):
    """``tools/train.py --dist`` on one rank, the group made by the CLI
    itself from ``--dist_url``; counts the checkpoints it writes."""
    import treelearn_tpu_torch.model.checkpoint as ck
    from treelearn_tpu_torch.tools import train

    torch.set_num_threads(1)
    os.chdir(tmp)
    saved = []
    orig = ck.checkpoint_save
    ck.checkpoint_save = lambda *a, **k: saved.append(orig(*a, **k))
    model = train.main(["--config", cfg, "--device", "cpu", "--dist",
                        "--dist_url", init_method])
    rank = int(os.environ["RANK"])
    torch.save({"state": model.state_dict(), "saved": saved},
               osp.join(tmp, f"train{rank}.pt"))


def test_train_cli_dist(tmp_path):
    """``tools/train.py --dist`` on 2 ranks for one epoch of 4 crops
    (global batch 2: two steps): rank 0 alone writes ``epoch_1.pth`` and
    the validation record, the parameters and statistics end bit-equal on
    both ranks and equal to the checkpoint's, and each BatchNorm counted
    two steps."""
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)

    for split, seeds in (("train", (1, 2, 3, 4)), ("val", (5,))):
        d = tmp_path / split
        d.mkdir()
        for s in seeds:
            data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                            points_per_tree=200,
                                            ground_points=500, seed=s)
            data[:, :2] -= data[:, :2].mean(0)
            make_crop_npz(str(d / f"c{s}.npz"), data, verticality_proxy(data))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(_TRAIN_YAML.format(train=tmp_path / "train",
                                      val=tmp_path / "val"))
    _spawn(_train_rank, tmp_path, str(cfg), str(tmp_path))
    r0, r1 = (torch.load(tmp_path / f"train{r}.pt") for r in range(WORLD))
    work = tmp_path / "work_dirs" / "train"
    assert r0["saved"] == [str(osp.join("./work_dirs", "train",
                                        "epoch_1.pth"))]
    assert r1["saved"] == []
    assert [f for f in os.listdir(work) if f.endswith(".pth")] == [
        "epoch_1.pth"]
    ckpt = torch.load(work / "epoch_1.pth")
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
        assert torch.equal(v, ckpt["net"][k]), k
    assert int(r0["state"]["output_layer.0.num_batches_tracked"]) == 2
    tags = {json.loads(line)["tag"]
            for line in (work / "scalars.jsonl").read_text().splitlines()}
    assert tags == {"train/semantic_loss", "train/offset_loss", "val/acc",
                    "val/Offset_MAE"}


def test_shard_batch_arrays_matches_jax():
    from treelearn_tpu.parallel import shard_batch_arrays as jax_shard
    from treelearn_tpu_torch.parallel import shard_batch_arrays

    rng = np.random.default_rng(0)
    batch = {"coords": rng.normal(size=(8, 3)), "valid": np.ones(8, bool),
             "batch_size": 2}
    got, want = shard_batch_arrays(batch, 4), jax_shard(batch, 4)
    assert got.keys() == want.keys()
    for k in ("coords", "valid"):
        assert got[k].shape == (4, 2) + batch[k].shape[1:]
        np.testing.assert_array_equal(got[k], want[k])
    assert got["batch_size"] == 2


def test_make_mesh_without_group_and_backend_default():
    """No process group: ``make_mesh`` is None (the single path runs);
    the CPU takes gloo."""
    from treelearn_tpu_torch.parallel import make_mesh
    from treelearn_tpu_torch.parallel.mesh import default_backend

    assert not torch.distributed.is_initialized()
    assert make_mesh("cpu") is None
    assert default_backend(torch.device("cpu"), 2) == "gloo"


def test_spawn_ranks_fails_on_a_failing_rank(tmp_path):
    from treelearn_tpu_torch.parallel.launch import spawn_ranks

    with pytest.raises(RuntimeError, match="exit codes"):
        spawn_ranks(_failing_rank, WORLD, str(tmp_path), timeout=60)


def _failing_rank(init_method):
    if int(os.environ["RANK"]) == 1:
        raise SystemExit(3)
