"""treelearn_tpu_torch training vs the JAX package (CPU): the weight
gradient (kernel 3's plain version), the autograd conv, training-mode
BatchNorm, the losses, the schedule and clipping, three whole train steps,
checkpoint resume, self-training and the training CLI.  The Pallas dW and
conv kernels run in interpret mode, as tests/test_pallas_conv.py runs
them."""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pallas_conv import _grid

torch.set_num_threads(1)


def _conv_case(seed, cin=8, cout=8):
    """A JAX grid and rule with capacity padding, and x / g zero on the
    padded rows (tests/test_pallas_conv.py:117-134)."""
    from treelearn_tpu.ops.sparse import build_subm_rulebook

    rng = np.random.default_rng(seed)
    grid, _ = _grid(n=300, shape=(12, 12, 24), cap=512, seed=seed)
    rule = build_subm_rulebook(grid, 3)
    live = np.asarray(grid.live_mask)
    x = np.where(live[:, None], rng.normal(size=(512, cin)), 0).astype(
        np.float32)
    g = np.where(live[:, None], rng.normal(size=(512, cout)), 0).astype(
        np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    return grid, rule, x, g, w


def test_subm_conv_dw_plain_matches_jax(monkeypatch):
    """Plain dW against rule_conv_dw_xla (float32 both: rtol 1e-5, atol
    1e-5), and on bf16-rounded inputs against the interpret-mode Pallas
    kernel, which casts x and g to bf16 and sums in float32 (rtol 1e-4,
    atol 1e-4: summation order)."""
    import treelearn_tpu.ops.pallas_conv as pc
    from treelearn_tpu_torch.ops.subm_conv import subm_conv_dw

    monkeypatch.setattr(pc, "_INTERPRET", True)
    grid, rule, x, g, _ = _conv_case(6)
    rule_t = torch.from_numpy(np.asarray(rule))
    got = subm_conv_dw(torch.from_numpy(x), torch.from_numpy(g), rule_t)
    want = pc.rule_conv_dw_xla(jnp.asarray(x), jnp.asarray(g), rule,
                               grid.live_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got16 = subm_conv_dw(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(g).bfloat16(), rule_t)
    assert got16.dtype == torch.float32
    want16 = pc.rule_conv_dw_banded(jnp.asarray(x), jnp.asarray(g), rule,
                                    grid.live_mask, tile=256, window=512)
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16), rtol=1e-4,
                               atol=1e-4)


def test_subm_conv_fn_grads_match_jax(monkeypatch):
    """SubmConvFn's dx (the conv with mirrored weights over the same rule)
    and dW against jax.grad of the XLA subm_conv (float32: rtol 1e-5, atol
    1e-5) and of rule_conv_ad in interpret mode (its bf16 kernels: 1e-2,
    as tests/test_pallas_conv.py holds it)."""
    import treelearn_tpu.ops.pallas_conv as pc
    from treelearn_tpu.ops.sparse import subm_conv as jconv
    from treelearn_tpu_torch.ops.subm_conv import SubmConvFn

    monkeypatch.setattr(pc, "_INTERPRET", True)
    grid, rule, x, cot, w = _conv_case(7, cin=8, cout=16)
    cot = cot[:, :8].repeat(2, axis=1)
    live = grid.live_mask

    def loss_xla(xx, ww):
        return jnp.sum(jconv(xx, ww, rule, live) * cot)

    def loss_ad(xx, ww):
        return jnp.sum(pc.rule_conv_ad(xx, ww, rule, rule, live, live, None,
                                       None, True, True, None) * cot)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = SubmConvFn.apply(xt, wt, torch.from_numpy(np.asarray(rule)))
    (out * torch.from_numpy(cot)).sum().backward()
    for fn, tol in ((loss_xla, 1e-5), (loss_ad, 1e-2)):
        dx, dw = jax.grad(fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), rtol=tol,
                                   atol=tol)
    assert wt.grad.dtype == torch.float32


def test_batchnorm_training_matches_apply_bn():
    """Training-mode statistics over the live rows only (padded rows hold
    garbage), the unbiased running_var, momentum 0.1 and the gradient,
    against apply_bn(training=True): rtol 1e-5, atol 1e-6."""
    from treelearn_tpu.model.blocks import apply_bn
    from treelearn_tpu_torch.model.blocks import BatchNorm

    rng = np.random.default_rng(1)
    x = rng.normal(1.5, 2.0, (64, 6)).astype(np.float32)
    live = np.arange(64) < 50
    x[~live] = 1e3
    p = {"weight": rng.normal(size=6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    s = {"running_mean": rng.normal(size=6).astype(np.float32),
         "running_var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    cot = rng.normal(size=(64, 6)).astype(np.float32)

    def f(xx):
        y, ns = apply_bn(p, s, xx, jnp.asarray(live), training=True)
        return jnp.sum(jnp.where(jnp.asarray(live)[:, None], y, 0) * cot), \
            (y, ns)

    (_, (want, new_s)), dx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    bn = BatchNorm(6)
    bn.load_state_dict({**{k: torch.from_numpy(v)
                           for k, v in {**p, **s}.items()},
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, torch.from_numpy(live))
    (y * torch.from_numpy(live)[:, None] * torch.from_numpy(cot)).sum(
    ).backward()
    np.testing.assert_allclose(y.detach().numpy()[live],
                               np.asarray(want)[live], rtol=1e-5, atol=1e-6)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(new_s[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-5,
                               atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def test_losses_match_jax():
    """point_wise_loss and total_loss, including an empty offset mask:
    rtol 1e-6."""
    from treelearn_tpu.train.losses import point_wise_loss as jpl
    from treelearn_tpu.train.losses import total_loss as jtl
    from treelearn_tpu_torch.train import point_wise_loss, total_loss

    rng = np.random.default_rng(2)
    n = 200
    args = [rng.normal(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.random(n) < 0.7, rng.random(n) < 0.4,
            rng.integers(0, 2, n), rng.normal(size=(n, 3)).astype(np.float32)]
    for off_mask in (args[3], np.zeros(n, bool)):
        a = args[:3] + [off_mask] + args[4:]
        want, wd = jtl(*jpl(*(jnp.asarray(v) for v in a)))
        got, gd = total_loss(*point_wise_loss(*(torch.from_numpy(v)
                                                for v in a)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        for k in wd:
            np.testing.assert_allclose(float(gd[k]), float(wd[k]), rtol=1e-6,
                                       atol=1e-7)


def test_schedule_and_clip_match_jax():
    """The learning rate of every step (optimizer stepped, then the
    scheduler) against make_epoch_cosine_schedule (rtol 1e-6), and
    clip_by_global_norm_ against optax.clip_by_global_norm above and below
    the threshold (rtol 1e-6)."""
    import optax
    from treelearn_tpu.train.loop import make_epoch_cosine_schedule
    from treelearn_tpu_torch.train.loop import (build_optimizer,
                                                clip_by_global_norm_)

    sched = {"t_initial": 8, "warmup_t": 3, "lr_min": 5e-5,
             "warmup_lr_init": 1e-5}
    jsched = make_epoch_cosine_schedule({**sched, "base_lr": 3e-3}, 4)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sch = build_optimizer([p], {"type": "AdamW", "lr": 3e-3,
                                     "weight_decay": 1e-3}, sched, 4)
    for step in range(48):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(jsched(step)), rtol=1e-6)
        opt.step()
        sch.step()
    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0):
        gs = [rng.normal(size=s).astype(np.float32) * scale
              for s in ((4, 5), (7,))]
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
        for prm, g in zip(params, gs):
            prm.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(params, 1.0)
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], None)
        for prm, w in zip(params, want):
            np.testing.assert_allclose(prm.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-9)


CFG = dict(channels=8, num_blocks=3, spatial_shape=[128, 128, 64],
           voxel_size=0.1, use_coords=True, use_feats=True)
OPTIM = {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-3}
SCHED = {"t_initial": 10, "warmup_t": 1, "lr_min": 1e-4,
         "warmup_lr_init": 1e-4}


def _batches(tmp_path, n=3):
    """Padded single-crop training batches (no augmentation) from the
    port's loader machinery; the JAX step reads the same numpy arrays."""
    from treelearn_tpu_torch.data import TreeDataset, collate_padded
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)

    d = tmp_path / "crops"
    d.mkdir()
    for i in range(n):
        data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                        points_per_tree=300,
                                        ground_points=800, seed=i + 1)
        data[:, :2] -= data[:, :2].mean(0)
        make_crop_npz(str(d / f"c{i}.npz"), data, verticality_proxy(data))
    ds = TreeDataset(str(d), inner_square_edge_length=4.0, training=True,
                     data_augmentations={})
    return [collate_padded([ds[i]], min_bucket=2048) for i in range(n)]


def test_three_train_steps_match_jax(tmp_path):
    """Three steps from the same weights and batches as the JAX
    make_train_step(fast_conv=False), float32, AdamW + warmup cosine + clip:
    losses within rtol 1e-5; each parameter's update within 5e-3 of the
    summed learning rate (absolute), BatchNorm running statistics within
    1e-5.  Not held to that: the Linear biases right before each MLP's
    BatchNorm, whose gradient is zero in exact arithmetic (AdamW turns the
    two frameworks' rounding noise into steps of up to lr), and the
    running_mean of that BatchNorm, which records them (1e-4)."""
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu.train.loop import build_optimizer as jax_optimizer
    from treelearn_tpu.train.loop import make_train_step as jax_train_step
    from treelearn_tpu_torch.model import TreeLearn, params_from_jax_numpy
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    batches = _batches(tmp_path)
    jm = JaxTreeLearn(**CFG)
    params, state = jm.init(0)
    jopt = jax_optimizer(OPTIM, SCHED, 1, True)
    opt_state = jopt.init(params)
    jstep = jax_train_step(jm, jopt, batch_size=1, voxel_capacity=8192,
                           compute_dtype=jnp.float32, fast_conv=False)
    model = TreeLearn(**CFG).init(0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sch = build_optimizer(model.parameters(), OPTIM, SCHED, 1)
    step = make_train_step(model, opt, sch, batch_size=1,
                           compute_dtype=torch.float32, grad_norm_clip=True,
                           device="cpu")
    lr_sum = 0.0
    for b in batches:
        lr_sum += opt.param_groups[0]["lr"]
        jb = {k: jnp.asarray(v) for k, v in b.items()
              if isinstance(v, np.ndarray)}
        params, state, opt_state, jloss, ld = jstep(params, state, opt_state,
                                                    jb)
        assert bool(ld["_caps_ok"])
        loss, _ = step(b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = params_from_jax_numpy(jax.device_get(params),
                                 jax.device_get(state))
    for k, v in model.state_dict().items():
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


def test_resume_continues_like_one_run(tmp_path):
    """Two steps, save, resume into fresh objects, one more step: the same
    parameters, moments and learning rate as three uninterrupted steps
    (bit-equal on the CPU)."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.checkpoint import (resume_checkpoint,
                                                      save_checkpoint)
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    batches = _batches(tmp_path)
    cfg = dict(CFG, channels=4, num_blocks=2)

    def fresh():
        m = TreeLearn(**cfg).init(0)
        o, s = build_optimizer(m.parameters(), OPTIM, SCHED, 1)
        return m, o, s, make_train_step(m, o, s, batch_size=1,
                                        compute_dtype=torch.float32,
                                        grad_norm_clip=True, device="cpu")

    m1, o1, s1, st1 = fresh()
    for b in batches:
        st1(b)
    m2, o2, s2, st2 = fresh()
    for b in batches[:2]:
        st2(b)
    path = str(tmp_path / "ck.pth")
    save_checkpoint(path, m2, o2, s2, epoch=2)
    m3, o3, s3, st3 = fresh()
    assert resume_checkpoint(path, m3, o3, s3) == 3
    st3(batches[2])
    assert o3.param_groups[0]["lr"] == o1.param_groups[0]["lr"]
    for (k, a), b in zip(m1.state_dict().items(), m3.state_dict().values()):
        assert torch.equal(a, b), k


def test_selftrain_budget_resume_and_cache(tmp_path):
    """train_synthetic_checkpoint: a zero-second budget stops after one
    step with a partial checkpoint; the next call resumes and finishes;
    the third returns the cached file without training."""
    from treelearn_tpu_torch.train.selftrain import train_synthetic_checkpoint

    kw = dict(model_cfg=dict(channels=4, num_blocks=2),
              cache_dir=str(tmp_path), steps=3, n_crops=2, crop_extent=10.0,
              ppt=200, hard_frac=0.0, return_info=True, device="cpu",
              compute_dtype=torch.float32)
    path, info = train_synthetic_checkpoint(max_seconds=0.0, **kw)
    assert path.endswith("_partial.pth") and not info["complete"]
    assert info["completed_steps"] == 1
    path, info = train_synthetic_checkpoint(**kw)
    assert info["complete"] and len(info["losses"]) == 2
    assert np.isfinite(info["losses"]).all()
    assert not osp.exists(path.replace(".pth", "_partial.pth"))
    again, info = train_synthetic_checkpoint(**kw)
    assert again == path and info["cached"]
    assert sorted(os.listdir(tmp_path)) == [osp.basename(path)]


def test_train_cli(tmp_path, monkeypatch):
    """``tools/train.py`` raises without a card unless ``--device cpu``,
    and with it runs one epoch on two tiny crops: a checkpoint and a
    validation record."""
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)
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
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"""
model: {{channels: 4, num_blocks: 2, kernel_size: 3, dim_coord: 3, dim_feat: 1,
        use_feats: false, use_coords: false, fixed_modules: [],
        spatial_shape: [128, 128, 64], voxel_size: 0.1,
        max_num_points_per_voxel: 3}}
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
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--config", str(cfg)])
    model = train.main(["--config", str(cfg), "--device", "cpu"])
    work = tmp_path / "work_dirs" / "train"
    assert (work / "epoch_1.pth").is_file()
    tags = {json.loads(line)["tag"]
            for line in (work / "scalars.jsonl").read_text().splitlines()}
    assert tags == {"train/semantic_loss", "train/offset_loss", "val/acc",
                    "val/Offset_MAE"}
    assert int(model.output_layer["0"].num_batches_tracked) == 2
