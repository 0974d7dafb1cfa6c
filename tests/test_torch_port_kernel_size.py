"""Kernel sizes other than 3 in the port (CPU), as the JAX package builds
them: the probe rulebook for any odd k, the SIMT routes for K = k^3 != 27,
``init(seed)``, the forward, and the plain dW and dx at K = 125 against
JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

# channels 8, 2 levels, k = 5.  The JAX forward takes a level capacity that
# is no multiple of its conv tile (4000): at a multiple it would build the
# banded windows of its 27-offset Pallas conv (pallas_conv.py:139 asserts
# k^3 = 27) even with fast_conv=False; the rule conv it then runs takes any
# K.
CFG = dict(channels=8, num_blocks=2, kernel_size=5,
           spatial_shape=[128, 128, 64], voxel_size=0.1)
JAX_CAPACITY = 4000


def _grid_pair(seed=0, n=700, ss=(14, 12, 10), batch=2):
    from treelearn_tpu.ops.sparse import grid_from_sorted_keys as jgrid
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys

    rng = np.random.default_rng(seed)
    space = int(np.prod(ss))
    keys = np.unique(np.concatenate([
        b * space + rng.choice(space, n, replace=False)
        for b in range(batch)])).astype(np.int32)
    return (grid_from_sorted_keys(torch.from_numpy(keys), ss),
            jgrid(jnp.asarray(keys), jnp.asarray(ss, jnp.int32),
                  len(keys)))


def test_init_bit_identical_to_jax_k5():
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu_torch.model import TreeLearn, params_from_jax_numpy

    want = params_from_jax_numpy(*JaxTreeLearn(**CFG).init(0))
    got = TreeLearn(**CFG).init(0).state_dict()
    assert set(got) == set(want)
    assert got["input_conv.0.weight"].shape == (125, 4, 8)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("k", [1, 3, 5])
def test_probe_rulebook_matches_jax(k):
    from treelearn_tpu.ops.sparse import build_subm_rulebook as jbsr
    from treelearn_tpu_torch.model.network import level_rule

    g, jg = _grid_pair(seed=k)
    got = level_rule(g, k)
    assert got.shape == (k ** 3, g.n_active)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbsr(jg, k)))


def test_forward_k5_matches_jax():
    """Logits, offsets and backbone features against the jitted JAX apply
    (fast_conv=False) in float32: rtol 1e-4, atol 1e-4, as
    test_torch_port_model.py holds k = 3 (summation order over 125 offsets
    and two levels differs); voxel and rule counts equal."""
    from treelearn_tpu.data.synthetic import make_synthetic_forest
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu_torch.model import TreeLearn

    data, _ = make_synthetic_forest(n_trees=2, extent=6, points_per_tree=300,
                                    ground_points=800, seed=1)
    xyz = data[:, :3].astype(np.float32)
    xyz -= xyz.mean(0)
    n, cap = len(xyz), 4096
    coords = np.zeros((cap, 3), np.float32)
    coords[:n] = xyz
    arrays = (coords, np.zeros((cap, 1), np.float32), np.zeros(cap, np.int32),
              np.arange(cap) < n)
    jm = JaxTreeLearn(**CFG)
    params, state = jm.init(0)
    fwd = jax.jit(lambda p, s, *a: jm.apply(
        p, s, *a, batch_size=1, voxel_capacity=JAX_CAPACITY,
        fast_conv=False)[0])
    want = fwd(params, state, *(jnp.asarray(a) for a in arrays))
    model = TreeLearn(**CFG).init(0).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in arrays), batch_size=1)
    for key in ("semantic_prediction_logits", "offset_predictions",
                "backbone_feats"):
        np.testing.assert_allclose(got[key].numpy()[:n],
                                   np.asarray(want[key])[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert got["n_voxels_per_level"] == [
        int(x) for x in np.asarray(want["n_voxels_per_level"])]
    assert got["rule_nnz_per_level"] == [
        int(x) for x in np.asarray(want["rule_nnz_per_level"])]


def test_plain_dw_k125_matches_jax_autodiff():
    """The plain dW at K = 125 (the reference of the SIMT dW kernel)
    against JAX's autodiff weight gradient of its rule conv: rtol 1e-4."""
    from treelearn_tpu.ops.sparse import build_subm_rulebook as jbsr
    from treelearn_tpu.ops.sparse import subm_conv as jconv
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw

    g, jg = _grid_pair(seed=7)
    rule = jbsr(jg, 5)
    v = g.n_active
    rng = np.random.default_rng(3)
    x = rng.standard_normal((v, 6)).astype(np.float32)
    w = (rng.standard_normal((125, 6, 10)) * 0.1).astype(np.float32)
    gout = rng.standard_normal((v, 10)).astype(np.float32)
    live = jnp.ones(v, bool)
    want = jax.grad(lambda w_: jnp.sum(
        jconv(jnp.asarray(x), w_, rule, live) * gout))(jnp.asarray(w))
    got = subm_conv_dw(torch.from_numpy(x), torch.from_numpy(gout),
                       torch.from_numpy(np.array(rule)))
    assert got.shape == (125, 6, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_conv_fn_k125_grads_match_plain_autograd():
    """``SubmConvFn`` at K = 125 on the CPU: dx (the conv with mirrored
    weights) and dW against autograd through the plain conv, float32,
    1e-5 of each gradient's max."""
    from treelearn_tpu_torch.model.network import level_rule
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import SubmConvFn

    g, _ = _grid_pair(seed=9)
    rule = level_rule(g, 5)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(g.n_active, 5, generator=gen, requires_grad=True)
    w = (torch.randn(125, 5, 7, generator=gen) * 0.1).requires_grad_()
    gout = torch.randn(g.n_active, 7, generator=gen)
    dx, dw = torch.autograd.grad((SubmConvFn.apply(x, w, rule) * gout).sum(),
                                 (x, w))
    rdx, rdw = torch.autograd.grad((plain(x, w, rule) * gout).sum(), (x, w))
    for got, want in ((dx, rdx), (dw, rdw)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k125_routes_to_tensor_cores(dtype):
    """K = 125 takes the tensor-core conv and dW of its dtype (the offset
    count is a launch argument of all four kernels): 3xTF32 in float32,
    the 4 -> 32 input conv padded to 8 channels; wgmma in bf16, the input
    conv padded to 32 as at K = 27.  K = 27 keeps its routes."""
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, dw_plan,
                                                   tensor_core_pad)

    f32 = dtype == torch.float32
    for cin, cout, v in ((4, 32, 420575), (32, 32, 420575), (64, 96, 9961)):
        pad = tensor_core_pad(cin, cout, v, dtype, 125)
        assert pad == (0 if cin != 4 else 4 if f32 else 28)
        route = "tf32x3" if f32 else "wgmma"
        assert conv_plan(cin + pad, cout, v, dtype, 125).route == route
        assert dw_plan(cin + pad, cout, v, dtype, 125).route == route
        assert conv_plan(cin, cout, v, dtype, 27) == conv_plan(cin, cout, v,
                                                                dtype)
        assert dw_plan(cin, cout, v, dtype, 27) == dw_plan(cin, cout, v,
                                                            dtype)
        n = dw_plan(cin + pad, cout, v, dtype, 125).n_chunks
        assert n * 125 * (cin + pad) * cout * 4 <= 64 << 20 or n == 1
    assert conv_plan(32, 32, 420575, torch.bfloat16).route == "wgmma"
    assert tensor_core_pad(4, 32, 420575, torch.bfloat16) == 28


def test_train_step_k5_cpu():
    """One float32 training step of a k = 5 model on the CPU: a finite
    loss, a gradient on every conv weight."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    rng = np.random.default_rng(0)
    n = 800
    batch = {"coords": rng.uniform(-2, 2, (n, 3)).astype(np.float32),
             "input_feats": np.zeros((n, 1), np.float32),
             "batch_ids": np.zeros(n, np.int32), "valid": np.ones(n, bool),
             "masks_sem": np.ones(n, bool), "masks_off": np.ones(n, bool),
             "semantic_labels": rng.integers(0, 2, n).astype(np.int64),
             "offset_labels": rng.normal(0, 1, (n, 3)).astype(np.float32)}
    model = TreeLearn(**CFG).init(0)
    opt, _ = build_optimizer(model.parameters(), {"type": "AdamW",
                                                  "lr": 1e-3})
    step = make_train_step(model, opt, batch_size=1,
                           compute_dtype=torch.float32, device="cpu")
    loss, _ = step(batch)
    assert np.isfinite(float(loss))
    w = model.unet.blocks["block0"].conv_branch["2"].weight
    assert w.shape == (125, 8, 8) and w.grad is not None
