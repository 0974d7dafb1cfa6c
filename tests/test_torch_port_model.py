"""treelearn_tpu_torch model vs the JAX package (CPU): weights carry-over,
state_dict keys, and the forward pass on a synthetic crop."""

import os.path as osp

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CFG = dict(channels=8, num_blocks=3, spatial_shape=[128, 128, 64],
           voxel_size=0.1)


def _jax_model():
    from treelearn_tpu.model import TreeLearn

    model = TreeLearn(**CFG)
    return model, model.init(0)


def test_init_bit_identical_to_jax():
    from treelearn_tpu_torch.model import TreeLearn, params_from_jax_numpy

    _, (params, state) = _jax_model()
    want = params_from_jax_numpy(params, state)
    got = TreeLearn(**CFG).init(0).state_dict()
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_params_round_trip():
    from treelearn_tpu.model.checkpoint import flatten_tree
    from treelearn_tpu_torch.model import (jax_numpy_from_state_dict,
                                           params_from_jax_numpy)

    _, (params, state) = _jax_model()
    p2, s2 = jax_numpy_from_state_dict(params_from_jax_numpy(params, state))
    for a, b in ((params, p2), (state, s2)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_state_dict_keys_match_reference():
    from treelearn_tpu_torch.model import TreeLearn

    path = osp.join(osp.dirname(__file__), "fixtures",
                    "reference_state_dict_keys.txt")
    with open(path) as f:
        ref = {line.strip() for line in f if line.strip()}
    assert len(ref) == 414
    assert set(TreeLearn().state_dict()) == ref


def test_pth_checkpoint_loads(tmp_path):
    """A reference-layout .pth (spconv 5-D conv weights) loads into the port
    and reproduces the source parameters."""
    from treelearn_tpu.model.checkpoint import export_torch_state_dict
    from treelearn_tpu_torch.model import (TreeLearn, load_checkpoint,
                                           params_from_jax_numpy)

    _, (params, state) = _jax_model()
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in export_torch_state_dict(params, state).items()}
    path = str(tmp_path / "w.pth")
    torch.save({"net": ref_sd, "epoch": 3}, path)
    model = TreeLearn(**CFG)
    assert load_checkpoint(path, model, strict=True) == 4
    want = params_from_jax_numpy(params, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _crop(seed=1):
    from treelearn_tpu.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=2, extent=6, points_per_tree=300,
                                    ground_points=800, seed=seed)
    xyz = data[:, :3].astype(np.float32)
    xyz -= xyz.mean(0)
    n, cap = len(xyz), 4096
    coords = np.zeros((cap, 3), np.float32)
    coords[:n] = xyz
    feats = np.zeros((cap, 1), np.float32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return coords, feats, np.zeros(cap, np.int32), valid, n


def test_forward_matches_jax():
    """Logits, offsets and backbone features against the jitted
    TreeLearn.apply(fast_conv=False) in f32: rtol 1e-4, atol 1e-4 (summation
    order over 27 offsets and several levels differs)."""
    from treelearn_tpu_torch.model import TreeLearn

    jm, (params, state) = _jax_model()
    coords, feats, bids, valid, n = _crop()
    fwd = jax.jit(lambda p, s, *a: jm.apply(
        p, s, *a, batch_size=1, voxel_capacity=4096, fast_conv=False)[0])
    want = fwd(params, state, *(jnp.asarray(a) for a in
                                (coords, feats, bids, valid)))
    model = TreeLearn(**CFG).init(0).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in
                      (coords, feats, bids, valid)), batch_size=1)
    for k in ("semantic_prediction_logits", "offset_predictions",
              "backbone_feats"):
        np.testing.assert_allclose(got[k].numpy()[:n],
                                   np.asarray(want[k])[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert got["n_voxels_per_level"] == [
        int(x) for x in np.asarray(want["n_voxels_per_level"])]
    assert got["rule_nnz_per_level"] == [
        int(x) for x in np.asarray(want["rule_nnz_per_level"])]


def test_forward_bf16_runs_and_tracks_f32():
    """bf16 compute (the pipeline's fp16: True) stays close to f32."""
    from treelearn_tpu_torch.model import TreeLearn

    coords, feats, bids, valid, n = _crop(seed=2)
    model = TreeLearn(**CFG).init(0).eval()
    args = [torch.from_numpy(a) for a in (coords, feats, bids, valid)]
    with torch.no_grad():
        f32 = model(*args, batch_size=1)["backbone_feats"]
        b16 = model(*args, batch_size=1,
                    compute_dtype=torch.bfloat16)["backbone_feats"]
    assert b16.dtype == torch.float32 and torch.isfinite(b16).all()
    assert float((b16 - f32).abs().max()) <= 0.1 * float(f32.abs().max())


def test_batchnorm_refuses_training_mode():
    """A frozen BatchNorm (``fixed_modules``) refuses training-mode batch
    statistics: in train() it normalises with its running statistics and
    leaves them alone, as apply_bn(frozen=True) does; an unfrozen one takes
    the batch's."""
    from treelearn_tpu.model.blocks import apply_bn
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.blocks import BatchNorm

    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (50, 4)).astype(np.float32)
    p = {"weight": rng.normal(size=4).astype(np.float32),
         "bias": rng.normal(size=4).astype(np.float32)}
    s = {"running_mean": rng.normal(size=4).astype(np.float32),
         "running_var": rng.uniform(0.5, 2, 4).astype(np.float32)}
    bn = BatchNorm(4)
    bn.load_state_dict({**{k: torch.from_numpy(v) for k, v in {**p, **s}.items()},
                        "num_batches_tracked": torch.tensor(0)})
    bn.frozen = True
    bn.train()
    got = bn(torch.from_numpy(x))
    want, _ = apply_bn(p, s, jnp.asarray(x), jnp.ones(50, bool),
                       training=True, frozen=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(bn.running_mean, torch.from_numpy(s["running_mean"]))
    assert int(bn.num_batches_tracked) == 0
    bn.frozen = False
    assert float(bn(torch.from_numpy(x)).mean().abs()) < 5.0
    assert int(bn.num_batches_tracked) == 1
    model = TreeLearn(**CFG, fixed_modules=["unet"])
    assert all(m.frozen for m in model.unet.modules()
               if isinstance(m, BatchNorm))
    assert not model.output_layer["0"].frozen
