"""The 3xTF32 float32 route of kernels 2 and 3 (csrc/subm_conv_tf32.cu,
csrc/subm_conv_dw_tf32.cu) as far as the CPU reaches: the hi/lo split the
kernels take every float32 operand apart with, the plain twins of their
arithmetic (ops/subm_conv.py:subm_conv_tf32x3_plain,
subm_conv_dw_tf32x3_plain) against float64 and against the JAX model, the
launch plans of every float32 shape of the repository's model, the packed
hi/lo weight images, and the bf16 plans, which this route leaves alone.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_port_tf32.py
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CHANNELS = [32 * (i + 1) for i in range(7)]
# forward: the 4 -> 32 input conv, C -> C at every level, decoder 2C -> C;
# dx swaps Cin and Cout (the input conv has none: its input needs no
# gradient); dW has the forward shapes
FORWARD_SHAPES = ([(4, 32)] + [(c, c) for c in CHANNELS]
                  + [(2 * c, c) for c in CHANNELS[:-1]])
DX_SHAPES = [(cout, cin) for cin, cout in FORWARD_SHAPES[1:]]
# the full-width plot's voxels per level (chip_smoke.py's plot), and the
# span of a BENCH_RECIPE training crop's levels (57,993 voxels at level 0
# down to a few dozen), with ragged edges
PLOT_VOXELS = [420575, 176561, 42437, 9961, 2341, 561, 136]
CROP_VOXELS = [57993, 24000, 6100, 1500, 380, 95, 30, 1]


# ---- the split

def _bits(t):
    return t.contiguous().view(torch.int32)


def _check_split(x):
    from treelearn_tpu_torch.ops.subm_conv import tf32_split

    hi, lo = tf32_split(x)
    # TF32 keeps 10 mantissa bits: the 13 below are zero in both parts
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    x64 = x.double()
    err = (hi.double() + lo.double() - x64).abs()
    # within 2^-22 |x|; where lo falls below the normal range, within half
    # the spacing of TF32 subnormals (2^-137)
    limit = torch.maximum(2.0 ** -22 * x64.abs(),
                          torch.full_like(x64, 2.0 ** -137))
    assert bool((err <= limit).all()), (x[err > limit], err[err > limit])
    # hi is x rounded to the nearest TF32 value: within half its spacing
    ulp_hi = torch.ldexp(torch.ones_like(x64),
                         torch.frexp(x64)[1] - 11).clamp(min=2.0 ** -136)
    assert bool(((hi.double() - x64).abs() <= 0.5 * ulp_hi).all())


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False,
                          min_value=float(np.float32(-3.0e38)),
                          max_value=float(np.float32(3.0e38))),
                min_size=1, max_size=64))
def test_tf32_split_on_hypothesis_floats(values):
    """Any float32 of either sign, tiny, huge or subnormal (|x| <= 3e38: a
    value that rounds past the largest finite one has no finite split)."""
    _check_split(torch.tensor(values, dtype=torch.float32))


def test_tf32_split_edges():
    """Signs, ties (exactly half a TF32 spacing: away from zero), a carry
    into the exponent, the smallest normal and subnormal numbers, zero."""
    from treelearn_tpu_torch.ops.subm_conv import tf32_split

    tie = 1.0 + 2.0 ** -11          # halfway between two TF32 values
    carry = 2.0 - 2.0 ** -23        # all mantissa bits set: rounds to 2
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, tie, -tie, carry, -carry,
                         1.17549435e-38, 1e-40, -1e-45, 3.0e38, -3.0e38,
                         0.1, -7.3e-12], dtype=torch.float32)
    _check_split(vals)
    hi, lo = tf32_split(vals)
    assert float(hi[4]) == 1.0 + 2.0 ** -10 and float(hi[5]) == -(
        1.0 + 2.0 ** -10)
    assert float(hi[6]) == 2.0 and float(lo[6]) == -(2.0 ** -23)


# ---- the plain twins against float64

def _conv64(x, w, rule):
    x, w, rule = x.double().numpy(), w.double().numpy(), rule.numpy()
    out = np.zeros((rule.shape[1], w.shape[2]))
    for k in range(rule.shape[0]):
        m = rule[k] >= 0
        out[m] += x[rule[k][m]] @ w[k]
    return torch.from_numpy(out)


def _dw64(x, g, rule):
    x, g, rule = x.double().numpy(), g.double().numpy(), rule.numpy()
    out = np.zeros((rule.shape[0], x.shape[1], g.shape[1]))
    for k in range(rule.shape[0]):
        m = rule[k] >= 0
        out[k] = x[rule[k][m]].T @ g[m]
    return torch.from_numpy(out)


def _case(cin, cout, k, v=300, seed=0):
    rng = np.random.default_rng(seed + 1000 * cin + k)
    x = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    rule = rng.integers(0, v, (k, v)).astype(np.int32)
    rule[rng.random((k, v)) > 0.4] = -1
    return tuple(map(torch.from_numpy, (x, w, g, rule)))


def _err(got, want):
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("k", [27, 125])
@pytest.mark.parametrize("cin,cout", [(4, 32), (8, 32), (32, 32), (32, 64),
                                      (224, 224)])
def test_tf32x3_twins_match_float64(cin, cout, k):
    """The conv, its dx (the conv with the mirrored weights) and dW in the
    kernels' 3xTF32 arithmetic against float64 on random sparse rules: no
    more than 2x the error of the plain float32 versions (products of TF32
    values are exact in float32, so what 3xTF32 adds is the split's 2^-22
    and the dropped lo * lo term; measured at most 1.3x)."""
    from treelearn_tpu_torch.ops.sparse import subm_conv, subm_conv_dw
    from treelearn_tpu_torch.ops.subm_conv import (mirrored,
                                                   subm_conv_dw_tf32x3_plain,
                                                   subm_conv_tf32x3_plain)

    x, w, g, rule = _case(cin, cout, k)
    want = _conv64(x, w, rule)
    assert _err(subm_conv_tf32x3_plain(x, w, rule), want) <= 2 * _err(
        subm_conv(x, w, rule), want)
    wm = mirrored(w)
    want = _conv64(g, wm, rule)
    assert _err(subm_conv_tf32x3_plain(g, wm, rule), want) <= 2 * _err(
        subm_conv(g, wm, rule), want)
    want = _dw64(x, g, rule)
    got = subm_conv_dw_tf32x3_plain(x, g, rule)
    assert got.shape == (k, cin, cout)
    assert _err(got, want) <= 2 * _err(subm_conv_dw(x, g, rule), want)


def test_tf32x3_twin_n_live_and_empty_rule():
    """Rows at or past n_live are zero; an all -1 rule gives zeros."""
    from treelearn_tpu_torch.ops.subm_conv import (subm_conv_dw_tf32x3_plain,
                                                   subm_conv_tf32x3_plain)

    x, w, g, rule = _case(8, 16, 27, v=100)
    out = subm_conv_tf32x3_plain(x, w, rule, n_live=60)
    assert (out[60:] == 0).all() and bool(out[:60].abs().max() > 0)
    empty = torch.full_like(rule, -1)
    assert (subm_conv_tf32x3_plain(x, w, empty) == 0).all()
    assert (subm_conv_dw_tf32x3_plain(x, g, empty) == 0).all()


# ---- the slice as a whole: the JAX model with the port's conv on the twin

def test_forward_with_tf32x3_twin_matches_jax(monkeypatch):
    """The port's float32 forward with every subm conv through the 3xTF32
    twin against the jitted JAX TreeLearn.apply(fast_conv=False) in float32
    at channels 8 and 3 levels: rtol 1e-4, atol 1e-4, the tolerance of the
    port's own parity test (tests/test_torch_port_model.py)."""
    from treelearn_tpu.data.synthetic import make_synthetic_forest
    from treelearn_tpu.model import TreeLearn as JaxTreeLearn
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.ops import subm_conv as sc

    cfg = dict(channels=8, num_blocks=3, spatial_shape=[128, 128, 64],
               voxel_size=0.1)
    calls = []

    def twin(feats, weight, rule, n_live=None):
        calls.append(weight.shape)
        return sc.subm_conv_tf32x3_plain(feats, weight, rule, n_live)

    monkeypatch.setattr(sc, "subm_conv", twin)
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
    jm = JaxTreeLearn(**cfg)
    params, state = jm.init(0)
    fwd = jax.jit(lambda p, s, *a: jm.apply(
        p, s, *a, batch_size=1, voxel_capacity=cap, fast_conv=False)[0])
    want = fwd(params, state, *(jnp.asarray(a) for a in
                                (coords, feats, bids, valid)))
    model = TreeLearn(**cfg).init(0).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in
                      (coords, feats, bids, valid)), batch_size=1)
    assert len(calls) >= 1 + 2 * 3 * 2   # input conv + 2 convs a block
    for k in ("semantic_prediction_logits", "offset_predictions",
              "backbone_feats"):
        np.testing.assert_allclose(got[k].numpy()[:n],
                                   np.asarray(want[k])[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_conv_fn_grads_with_tf32x3_twins(monkeypatch):
    """SubmConvFn with its forward, dx and dW on the twins against autograd
    through the plain conv in float64: within 1e-5 of each one's max."""
    from treelearn_tpu_torch.ops import subm_conv as sc

    monkeypatch.setattr(sc, "subm_conv", sc.subm_conv_tf32x3_plain)
    monkeypatch.setattr(sc, "subm_conv_dx", lambda g, w, r: (
        sc.subm_conv_tf32x3_plain(g, sc.mirrored(w), r)))
    monkeypatch.setattr(sc, "subm_conv_dw", sc.subm_conv_dw_tf32x3_plain)
    from treelearn_tpu_torch.ops.sparse import (build_subm_rulebook,
                                                grid_from_sorted_keys)

    # dx is the mirrored conv on a submanifold rule only
    rng = np.random.default_rng(8)
    keys = np.unique(rng.choice(12 * 12 * 8, 400, replace=False))
    grid = grid_from_sorted_keys(torch.from_numpy(keys.astype(np.int32)),
                                 (12, 12, 8))
    rule = build_subm_rulebook(grid, 3)
    v = grid.n_active
    x, w, g, _ = _case(16, 24, 27, v=v)
    xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad((sc.SubmConvFn.apply(xx, ww, rule)
                                  * g).sum(), (xx, ww))
    x64, w64 = (x.double().requires_grad_(True),
                w.double().requires_grad_(True))
    out = torch.zeros((rule.shape[1], w.shape[2]), dtype=torch.float64)
    for k in range(rule.shape[0]):
        m = rule[k] >= 0
        out = out.index_add(0, torch.nonzero(m).squeeze(1),
                            x64[rule[k][m].long()] @ w64[k])
    rdx, rdw = torch.autograd.grad((out * g.double()).sum(), (x64, w64))
    for got, want in ((dx, rdx), (dw, rdw)):
        assert _err(got, want) <= 1e-5 * float(want.abs().max())


# ---- the plans

def _check_conv_plan(cin, cout, v, k=27):
    from treelearn_tpu_torch.ops.subm_conv import (SMEM_LIMIT, TF32_BN,
                                                   conv_plan,
                                                   plan_smem_bytes_tf32,
                                                   tensor_core_pad)

    pad = tensor_core_pad(cin, cout, v, torch.float32, k)
    assert pad == (4 if cin == 4 else 0)
    p = conv_plan(cin + pad, cout, v, torch.float32, k)
    assert p.route == "tf32x3"
    assert p.bm == 64 and p.producers == 128
    assert p.bn in TF32_BN and p.n_splits * p.bn == cout
    assert p.bk in (8, 16, 32) and (cin + pad) % p.bk == 0
    assert 2 <= p.stages <= 3
    assert p.smem_bytes == plan_smem_bytes_tf32(p.bn, p.bk, p.stages, k)
    assert p.smem_bytes <= SMEM_LIMIT
    return p


def _check_dw_plan(cin, cout, v, k=27):
    from treelearn_tpu_torch.ops.subm_conv import (DW_PARTIAL_BYTES,
                                                   DW_TF32_ROWS, SMEM_LIMIT,
                                                   TF32_BN, dw_plan,
                                                   dw_smem_bytes_tf32,
                                                   tensor_core_pad)

    pad = tensor_core_pad(cin, cout, v, torch.float32, k)
    p = dw_plan(cin + pad, cout, v, torch.float32, k)
    assert p.route == "tf32x3"
    assert p.bn in TF32_BN and p.n_splits * p.bn == cout
    assert p.smem_bytes == dw_smem_bytes_tf32(p.bn, p.stages)
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.rows_per_chunk % DW_TF32_ROWS == 0
    assert (p.n_chunks - 1) * p.rows_per_chunk < max(v, 1)
    assert p.n_chunks * p.rows_per_chunk >= v
    if p.n_chunks > 1:
        assert p.n_chunks * k * (cin + pad) * cout * 4 <= DW_PARTIAL_BYTES
    return p


@pytest.mark.parametrize("cin,cout", FORWARD_SHAPES)
def test_float32_forward_and_dw_plans_take_tf32x3(cin, cout):
    """Every float32 forward conv and weight gradient of the repository's
    model (channels 32, 7 levels) at every level size of the plot and of a
    training crop: the 3xTF32 route inside a block's shared memory, the
    input conv padded to 8 channels."""
    for v in PLOT_VOXELS + CROP_VOXELS:
        _check_conv_plan(cin, cout, v)
        _check_dw_plan(cin, cout, v)


@pytest.mark.parametrize("cin,cout", DX_SHAPES)
def test_float32_dx_plans_take_tf32x3(cin, cout):
    """Every dx conv (Cin and Cout of the forward swapped) likewise; the
    dx of a 4-channel input would stay on the SIMT kernel (4 output
    channels), and the model never asks for it."""
    from treelearn_tpu_torch.ops.subm_conv import conv_plan

    for v in PLOT_VOXELS + CROP_VOXELS:
        _check_conv_plan(cin, cout, v)
    assert conv_plan(32, 4, 1000, torch.float32).route == "simt"


@pytest.mark.parametrize("k", [125, 343])
def test_large_kernel_sizes_fit(k):
    """kernel_size 5 (K = 125, the shapes of chip_smoke's k5 model: channels
    32, 2 levels) and 7 (K = 343, the largest rule tile the kernel takes)
    fit a block; beyond that the SIMT kernel keeps the conv."""
    from treelearn_tpu_torch.ops.subm_conv import TF32_MAX_OFFSETS, conv_plan

    for cin, cout in ((4, 32), (32, 32), (32, 64), (64, 64), (128, 64),
                      (224, 224)):
        for v in (1, 3000, 420575):
            _check_conv_plan(cin, cout, v, k)
            _check_dw_plan(cin, cout, v, k)
            if cin != 4:
                _check_conv_plan(cout, cin, v, k)
    assert TF32_MAX_OFFSETS == 343
    assert conv_plan(32, 32, 1000, torch.float32, 729).route == "simt"


def _bf16_conv_plan_before(cin, cout, v, k):
    """kernel 2's bf16 plan as the repository had it before the 3xTF32
    route (the reference this route must leave alone)."""
    if k != 27 or cin == 0 or cout == 0 or cin % 32 or cout % 32:
        return ("simt", 64, 64, -(-cout // 64), 32, 1, 0, 0)
    n = 1
    while cout % n or (cout // n) % 32 or cout // n > 256:
        n += 1
    bm, bn = 64, cout // n
    if -(-v // 64) < 32:
        bn = 32
    elif bn == 32 and v >= 65536:
        bm = 128
    blocks = -(-v // bm) * (cout // bn)
    producers = 256 if blocks <= 132 else 128
    smem = 1024 + 4 * (bm + bn) * 32 * 2 + 128 + 27 * bm * 4 + 256
    return ("wgmma", bm, bn, cout // bn, 32, 4, producers, smem)


def test_bf16_plans_unchanged():
    """Every bf16 conv, dx and dW plan of the model's shapes at K = 27
    (widths in multiples of 32) is what it was before the float32 route;
    the rest (odd widths, K = 125, the 4 -> 32 input conv) now takes the
    bf16 tensor-core routes, the input conv padded to 32 channels at any
    row count."""
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, dw_plan,
                                                   dw_plan_wgmma,
                                                   tensor_core_pad)

    bf = torch.bfloat16
    shapes = set(FORWARD_SHAPES + DX_SHAPES + [(16, 24), (32, 40), (8, 32)])
    for cin, cout in sorted(shapes):
        for v in PLOT_VOXELS + CROP_VOXELS:
            for k in (27, 125):
                pad = tensor_core_pad(cin, cout, v, bf, k)
                assert pad == (32 - cin if cin % 8 else 0)
                tc = k == 27 and not cin % 32 and not cout % 32
                if tc:
                    assert tuple(conv_plan(cin, cout, v, bf, k)) == \
                        _bf16_conv_plan_before(cin, cout, v, k)
                    assert dw_plan(cin, cout, v, bf, k) == \
                        dw_plan_wgmma(cin, cout, v)
                assert conv_plan(cin + pad, cout, v, bf, k).route == "wgmma"
                assert dw_plan(cin + pad, cout, v, bf, k).route == "wgmma"


# ---- the packed weight images

def _unpack_tf32(packed):
    """(K, n_splits, n_slices, 2, sk / 8, bn, 8) -> hi and lo (K, Cin,
    Cout), element by element from the layout the kernel's descriptors
    read: row n of k8 tile (k, j, s, h, kk) is output channel j * bn + n,
    and its 16-byte chunk at position p holds input channels s * sk + 8 kk
    + 4 (p ^ ((n >> 2) & 1)) .. + 4."""
    p = packed.numpy()
    k, n_splits, n_slices, _, ksteps, bn, _ = p.shape
    sk = 8 * ksteps
    out = np.zeros((2, k, n_slices * sk, n_splits * bn), np.float32)
    for n in range(bn):
        for pos in range(2):
            c = pos ^ ((n >> 2) & 1)
            for s in range(n_slices):
                for kk in range(ksteps):
                    ch = s * sk + 8 * kk + 4 * c
                    # (h, k, j, 4 channels) -> (h, k, 4 channels, j)
                    out[:, :, ch:ch + 4, n::bn] = p[
                        :, :, s, :, kk, n, 4 * pos:4 * pos + 4].transpose(
                            2, 0, 3, 1)
    return torch.from_numpy(out[0]), torch.from_numpy(out[1])


@pytest.mark.parametrize("cin,cout,bn,sk,k", [
    (8, 32, 32, 8, 27), (16, 24, 24, 16, 27), (32, 64, 64, 32, 27),
    (64, 32, 32, 32, 27), (224, 224, 112, 32, 27), (192, 384, 128, 32, 27),
    (32, 64, 32, 32, 125)])
def test_pack_weight_tf32_unpacks_to_the_weight(cin, cout, bn, sk, k):
    """The hi and lo images read back by the layout's definition are
    tf32_split(W) exactly (hi + lo within 2^-22 |W|); the mirrored images
    unpack to the split of W.flip(0).transpose(1, 2) and equal the pack of
    the mirrored tensor."""
    from treelearn_tpu_torch.ops.subm_conv import (mirrored, pack_weight_tf32,
                                                   tf32_split)

    rng = np.random.default_rng(cin + cout + k)
    w = torch.from_numpy(rng.normal(size=(k, cin, cout)).astype(np.float32))
    packed = pack_weight_tf32(w, bn, sk)
    assert packed.shape == (k, cout // bn, cin // sk, 2, sk // 8, bn, 8)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    hi, lo = _unpack_tf32(packed)
    want_hi, want_lo = tf32_split(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert float(((hi.double() + lo.double()) - w.double()).abs().max()) <= (
        2.0 ** -22 * float(w.abs().max()))
    wm = w.flip(0).transpose(1, 2)
    bn_m = bn if cin % bn == 0 else 8
    sk_m = 32 if cout % 32 == 0 else 8
    packed_m = pack_weight_tf32(w, bn_m, sk_m, mirror=True)
    assert torch.equal(packed_m, pack_weight_tf32(mirrored(w), bn_m, sk_m))
    hi_m, lo_m = _unpack_tf32(packed_m)
    want_hi, want_lo = tf32_split(wm)
    assert torch.equal(hi_m, want_hi) and torch.equal(lo_m, want_lo)


def test_cpu_float32_routes_take_the_plain_versions(monkeypatch):
    """float32 CPU tensors never reach the kernel library: the conv, its dx
    and dW are the plain versions, bit for bit, and no launch is counted;
    the tf32 pack of a CPU weight is the torch pack."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (mirrored, pack_weight_tf32,
                                                   subm_conv, subm_conv_dw,
                                                   subm_conv_dx)

    def no_library():
        raise AssertionError("the CPU route must not build the kernels")

    monkeypatch.setattr(_cuda, "library", no_library)
    before = dict(_cuda.LAUNCHES)
    for cin, cout, k in ((4, 32, 27), (32, 64, 27), (8, 16, 125)):
        x, w, g, rule = _case(cin, cout, k, v=120)
        assert torch.equal(subm_conv(x, w, rule, n_live=100),
                           plain(x, w, rule, 100))
        assert torch.equal(subm_conv_dx(g, w, rule),
                           plain(g, mirrored(w), rule))
        assert torch.equal(subm_conv_dw(x, g, rule), plain_dw(x, g, rule))
    assert pack_weight_tf32(torch.zeros(27, 8, 8), 8, 8).shape == (
        27, 1, 1, 2, 1, 8, 8)
    assert _cuda.LAUNCHES == before
