"""The bf16 tensor-core routes of kernels 2 and 3 at any odd kernel size up
to 7 and at widths that are no multiple of 32 (csrc/subm_conv_wgmma.cu,
csrc/subm_conv_dw_wgmma.cu), as far as the CPU reaches: the launch plans of
the conv, its dx and its weight gradient, the packed weight images with a
16-channel tail slice, the JAX package's Pallas conv at such widths (in
interpret mode) against the port's plain conv, and the forward of a
``channels: 16`` model against the jitted JAX apply.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_port_bf16_routes.py
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

BF = torch.bfloat16
WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 48), (48, 16), (24, 40),
          (224, 112), (672, 336)]
KS = [27, 125, 343]
# level sizes of the full-width plot and of a training crop, ragged edges
VS = [1, 63, 136, 2341, 42437, 420575]


def _check_conv_plan(cin, cout, v, k):
    """The plan the wrapper launches for a bf16 conv of this shape (after
    its zero pads): the wgmma kernel, a block width it instantiates, the
    epilogue tile inside the ring, the block inside the card's shared
    memory."""
    from treelearn_tpu_torch.ops.subm_conv import (BF16_BN, SMEM_LIMIT,
                                                   conv_plan, cout_pad,
                                                   plan_smem_bytes,
                                                   tensor_core_pad)

    cin_p = cin + tensor_core_pad(cin, cout, v, BF, k)
    cout_p = cout + cout_pad(cout, BF, k)
    assert cin_p % 8 == 0 and cout_p % 8 == 0
    p = conv_plan(cin_p, cout_p, v, BF, k)
    assert p.route == "wgmma", (cin, cout, v, k)
    assert p.bn in BF16_BN and p.n_splits * p.bn == cout_p
    assert (p.bm, p.producers) in ((64, 128), (64, 256), (128, 128))
    assert p.bm == 64 or p.bn == 32
    assert 2 <= p.stages <= 4
    assert p.bm * (p.bn + 8) * 2 <= p.stages * (p.bm + p.bn) * 64
    assert p.smem_bytes == plan_smem_bytes(p.bm, p.bn, p.stages, k)
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.smem_bytes >= k * p.bm * 4 + p.stages * (p.bm + p.bn) * 64


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_bf16_conv_and_dx_plans_take_wgmma(cin, cout, k):
    """Every bf16 conv and its dx (the conv with Cin and Cout swapped) at
    K = 27, 125, 343 and these widths takes the tensor-core route at every
    level size, inside a block's shared memory; beyond K = 343 the plain
    version takes it."""
    from treelearn_tpu_torch.ops.subm_conv import conv_plan

    for v in VS:
        _check_conv_plan(cin, cout, v, k)
        _check_conv_plan(cout, cin, v, k)
    assert conv_plan(cin + cin % 8, cout, 1000, BF, 729).route == "plain"


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_bf16_dw_plans_take_wgmma(cin, cout, k):
    """Every bf16 weight gradient of these shapes takes the tensor-core
    route: 32-channel slabs of Cout covering it (the last one may reach
    past Cout), shared memory inside a block's limit, partials under the
    cap, chunks of whole ring slots that cover every row once."""
    from treelearn_tpu_torch.ops.subm_conv import (DW_PARTIAL_BYTES, MAX_BN,
                                                   SMEM_LIMIT, cout_pad,
                                                   dw_plan, dw_smem_bytes,
                                                   tensor_core_pad)

    for v in VS:
        cin_p = cin + tensor_core_pad(cin, cout, v, BF, k)
        cout_p = cout + cout_pad(cout, BF, k)
        p = dw_plan(cin_p, cout_p, v, BF, k)
        assert p.route == "wgmma", (cin, cout, v, k)
        assert p.bn % 32 == 0 and 32 <= p.bn <= MAX_BN
        assert (p.n_splits - 1) * p.bn < cout_p <= p.n_splits * p.bn
        assert p.smem_bytes == dw_smem_bytes(p.bn, p.producers, p.stages)
        assert p.smem_bytes <= SMEM_LIMIT
        assert p.rows_per_chunk % (p.producers // 4) == 0
        assert (p.n_chunks - 1) * p.rows_per_chunk < v
        assert p.n_chunks * p.rows_per_chunk >= v
        if p.n_chunks > 1:
            assert p.n_chunks * k * cin_p * cout_p * 4 <= DW_PARTIAL_BYTES


@pytest.mark.parametrize("cin,cout", [(4, 20), (12, 36), (36, 12), (100, 60)])
def test_float32_odd_widths_pad_onto_tf32x3(cin, cout):
    """float32 widths that are no multiple of 8 are zero-padded, in Cin and
    in Cout, onto the 3xTF32 conv and dW; the unpadded shape's plan is the
    plain version, which the wrappers never reach with it."""
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, cout_pad,
                                                   dw_plan, tensor_core_pad)

    f32 = torch.float32
    for k in (27, 125):
        for v in VS:
            cin_p = cin + tensor_core_pad(cin, cout, v, f32, k)
            cout_p = cout + cout_pad(cout, f32, k)
            assert cin_p == -(-cin // 8) * 8 and cout_p == -(-cout // 8) * 8
            assert conv_plan(cin_p, cout_p, v, f32, k).route == "tf32x3"
            assert dw_plan(cin_p, cout_p, v, f32, k).route == "tf32x3"
            assert conv_plan(cin, cout, v, f32, k).route == "plain"


def _unpack(packed, k, cin, cout, bn):
    """Read the packed images back into (K, kpad, Cout), element by element
    from the layout the kernel's descriptors expect: row n of the image of
    (k, j) is output channel j * bn + n; in a 32-channel slice s its
    16-byte chunk at position p holds input channels
    32 s + 8 (p ^ ((n >> 1) & 3)) .. + 8, in the 16-channel tail at position
    p channels 32 s + 8 (p ^ ((n >> 2) & 1)) .. + 8."""
    from treelearn_tpu_torch.ops.subm_conv import k_slices

    n_slices, tail, kpad = k_slices(cin)
    img = packed.float().numpy().reshape(k, cout // bn, bn * kpad)
    w = np.zeros((k, kpad, cout), np.float32)
    for s in range(n_slices):
        width = 16 if tail and s == n_slices - 1 else 32
        tile = img[:, :, 32 * s * bn:(32 * s + width) * bn].reshape(
            k, cout // bn, bn, width // 8, 8)
        for n in range(bn):
            for p in range(width // 8):
                c = p ^ (((n >> 1) & 3) if width == 32 else ((n >> 2) & 1))
                ch = 32 * s + 8 * c
                # (k, j, 8 channels) -> (k, 8 channels, j)
                w[:, ch:ch + 8, n::bn] = tile[:, :, n, p].transpose(0, 2, 1)
    return torch.from_numpy(w).to(BF)


@pytest.mark.parametrize("k", [27, 125])
@pytest.mark.parametrize("cin,cout,bn", [
    (24, 16, 8), (16, 48, 24), (48, 48, 48), (112, 224, 112)])
def test_pack_weight_unpacks_to_the_weight(cin, cout, bn, k):
    """The packed images read back by the layout's definition give W with
    zero channels past Cin: 24 channels fill one slice but its last chunk,
    16 one tail slice, 48 and 112 full slices and a tail.  The mirrored
    images unpack to W.flip(0).transpose(1, 2) and equal the pack of the
    mirrored tensor."""
    from treelearn_tpu_torch.ops.subm_conv import (k_slices, mirrored,
                                                   pack_weight)

    rng = np.random.default_rng(cin + cout + k)
    w = torch.from_numpy(rng.normal(size=(k, cin, cout)).astype(
        np.float32)).to(BF)
    kpad = k_slices(cin)[2]
    packed = pack_weight(w, bn)
    assert packed.is_contiguous() and packed.numel() == k * cout * kpad
    got = _unpack(packed, k, cin, cout, bn)
    assert torch.equal(got[:, :cin], w)
    assert not got[:, cin:].any()
    wm = mirrored(w)
    bn_m = bn if cin % bn == 0 else 8
    packed_m = pack_weight(w, bn_m, mirror=True)
    assert torch.equal(packed_m, pack_weight(wm, bn_m))
    got_m = _unpack(packed_m, k, cout, cin, bn_m)
    assert torch.equal(got_m[:, :cout], w.flip(0).transpose(1, 2))
    assert not got_m[:, cout:].any()


def _jax_grid(n=300, shape=(12, 12, 24), cap=512, seed=5):
    from treelearn_tpu.ops.sparse import grid_from_coords

    rng = np.random.default_rng(seed)
    coords = set()
    while len(coords) < n:
        coords.add((0, rng.integers(0, shape[0]), rng.integers(0, shape[1]),
                    rng.integers(0, shape[2])))
    coords = np.array(sorted(coords), np.int32)
    return grid_from_coords(jnp.asarray(coords), shape, capacity=cap)[0]


@pytest.mark.parametrize("cin", [16, 48])
def test_pallas_banded_conv_at_narrow_widths_matches_port(monkeypatch, cin):
    """The JAX package's Pallas conv (``subm_conv_banded``, interpret mode,
    which pads Cin to 32 / 64 lanes) and the port's plain conv on the same
    seed-0 bf16 feats, weights and rule: within 2e-2 of max |out| (the
    kernel sums the bf16 products in float32 in another order, then rounds
    to bf16)."""
    import treelearn_tpu.ops.pallas_conv as pc
    from treelearn_tpu.ops.sparse import build_subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv

    monkeypatch.setattr(pc, "_INTERPRET", True)
    cout = 16 if cin == 48 else 48
    grid = _jax_grid()
    n_live = int(grid.n_active)
    rule = np.array(build_subm_rulebook(grid, 3))
    rng = np.random.default_rng(0)
    feats = np.zeros((512, cin), np.float32)
    feats[:n_live] = rng.normal(size=(n_live, cin))
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    want = pc.subm_conv_banded(jnp.asarray(feats, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(rule), grid.live_mask, tile=256,
                               window=512)
    want = np.asarray(want, np.float32)
    got = subm_conv(torch.from_numpy(feats).to(BF),
                    torch.from_numpy(w).to(BF), torch.from_numpy(rule),
                    n_live)
    assert got.shape == (512, cout) and got.dtype == BF
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert not got[n_live:].any()


def test_channels16_forward_matches_jax():
    """A ``channels: 16`` model (levels 16, 32, 48; decoder 2C -> C convs of
    32..96 input channels) with the JAX weights carried over: logits,
    offsets and backbone features against the jitted
    ``TreeLearn.apply(fast_conv=False)`` in float32 within rtol 1e-4, atol
    1e-4, as tests/test_torch_port_model.py holds the channels 8 model."""
    from treelearn_tpu.data.synthetic import make_synthetic_forest
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu_torch.model import TreeLearn, params_from_jax_numpy

    cfg = dict(channels=16, num_blocks=3, spatial_shape=[128, 128, 64],
               voxel_size=0.1)
    jm = JaxTreeLearn(**cfg)
    params, state = jm.init(0)
    data, _ = make_synthetic_forest(n_trees=2, extent=6, points_per_tree=300,
                                    ground_points=800, seed=1)
    xyz = data[:, :3].astype(np.float32)
    xyz -= xyz.mean(0)
    n, cap = len(xyz), 4096
    coords = np.zeros((cap, 3), np.float32)
    coords[:n] = xyz
    feats = np.zeros((cap, 1), np.float32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    bids = np.zeros(cap, np.int32)
    fwd = jax.jit(lambda p, s, *a: jm.apply(
        p, s, *a, batch_size=1, voxel_capacity=cap, fast_conv=False)[0])
    want = fwd(params, state, *(jnp.asarray(a) for a in
                                (coords, feats, bids, valid)))
    model = TreeLearn(**cfg)
    model.load_state_dict(params_from_jax_numpy(params, state))
    model.eval()
    assert model.state_dict()["input_conv.0.weight"].shape == (27, 4, 16)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in
                      (coords, feats, bids, valid)), batch_size=1)
    for key in ("semantic_prediction_logits", "offset_predictions",
                "backbone_feats"):
        np.testing.assert_allclose(got[key].numpy()[:n],
                                   np.asarray(want[key])[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert got["n_voxels_per_level"].tolist() == [
        int(x) for x in np.asarray(want["n_voxels_per_level"])]
