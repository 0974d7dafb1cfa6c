"""treelearn_tpu_torch ops vs the JAX package on the same numpy inputs (CPU).

Hashing, voxelization, the rulebook (kernel 1's plain version), the
submanifold conv (kernel 2's plain version) and the down/inverse convs.
Where the JAX function is a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _keys_case(seed, ss, n, batch=1, boundary_heavy=False):
    """Sorted unique int32 keys (as tests/test_pallas_rd.py:_case)."""
    rng = np.random.default_rng(seed)
    space = int(np.prod(ss))
    keys = []
    for b in range(batch):
        if boundary_heavy:
            x = rng.choice([0, 1, ss[0] - 1], n)
            y = rng.integers(0, ss[1], n)
            z = rng.choice([0, 1, ss[2] - 2, ss[2] - 1], n)
            k = ((b * ss[0] + x) * ss[1] + y) * ss[2] + z
        else:
            k = b * space + rng.choice(space, n, replace=False)
        keys.append(k.astype(np.int64))
    return np.unique(np.concatenate(keys)).astype(np.int32)


def _points(seed, n=3000, extent=4.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.5
    return pts


def test_encode_decode_match_jax():
    from treelearn_tpu.ops import hashing as jh
    from treelearn_tpu_torch.ops import hashing as ph

    rng = np.random.default_rng(0)
    ss = (20, 24, 16)
    coords = np.stack([rng.integers(0, 3, 500), rng.integers(-2, 22, 500),
                       rng.integers(-2, 26, 500), rng.integers(-2, 18, 500)],
                      1).astype(np.int32)
    kj = np.asarray(jh.encode_keys(jnp.asarray(coords), ss))
    kp = ph.encode_keys(torch.from_numpy(coords), ss).numpy()
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_array_equal(
        ph.decode_keys(torch.from_numpy(kp), ss).numpy(),
        np.asarray(jh.decode_keys(jnp.asarray(kj), ss)))
    assert ph.SENTINEL == int(jh.SENTINEL)


@pytest.mark.parametrize("use_coords,use_feats,batch", [
    (False, False, 1), (True, True, 2)])
def test_voxelize_matches_jax(use_coords, use_feats, batch):
    """Keys, pooled feats and v2p_map equal the jitted JAX voxelization
    exactly on live rows (the compiled forward is what the pipeline runs)."""
    from treelearn_tpu.ops.voxelize import voxelize_points as jvox
    from treelearn_tpu_torch.ops.voxelize import devoxelize, voxelize_points

    pts = _points(1)
    n = len(pts)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(n, 1)).astype(np.float32)
    bids = rng.integers(0, batch, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ss = (64, 64, 32)
    cap = 4096
    jv = jax.jit(lambda c, f, b, v: jvox(
        c, f, b, v, batch_size=batch, voxel_size=0.1, capacity=cap,
        spatial_shape=np.array(ss, np.int32), use_coords=use_coords,
        use_feats=use_feats))(pts, feats, bids, valid)
    pv = voxelize_points(torch.from_numpy(pts), torch.from_numpy(feats),
                         torch.from_numpy(bids), torch.from_numpy(valid),
                         batch_size=batch, voxel_size=0.1, spatial_shape=ss,
                         use_coords=use_coords, use_feats=use_feats)
    nv = int(jv.n_voxels)
    assert pv.n_voxels == nv
    np.testing.assert_array_equal(pv.voxel_keys.numpy(),
                                  np.asarray(jv.voxel_keys)[:nv])
    np.testing.assert_array_equal(pv.voxel_feats.numpy(),
                                  np.asarray(jv.voxel_feats)[:nv])
    np.testing.assert_array_equal(pv.v2p_map.numpy()[valid],
                                  np.asarray(jv.v2p_map)[valid])
    assert (pv.v2p_map.numpy()[~valid] == nv).all()
    x = torch.arange(nv * 2, dtype=torch.float32).reshape(nv, 2)
    back = devoxelize(x, pv.v2p_map).numpy()
    assert (back[~valid] == 0).all()
    np.testing.assert_array_equal(back[valid], x.numpy()[pv.v2p_map.numpy()[valid]])


def test_host_voxel_helpers_match_jax():
    from treelearn_tpu.ops import voxelize as jv
    from treelearn_tpu_torch.ops import voxelize as pv

    pts = _points(3, n=2000).astype(np.float64) * 3
    for a, b in zip(jv.voxel_downsample_trace_np(pts, 0.1),
                    pv.voxel_downsample_trace_np(pts, 0.1)):
        np.testing.assert_array_equal(a, b)
    ss = (128, 128, 64)
    assert (pv.level_voxel_counts_np(pts, 0.1, ss, 4)
            == jv.level_voxel_counts_np(pts, 0.1, ss, 4))


@pytest.mark.parametrize("seed,ss,batch,boundary", [
    (0, (20, 24, 16), 1, False),
    (1, (20, 24, 16), 1, True),
    (2, (12, 10, 8), 3, False),
    (3, (12, 10, 8), 2, True),
])
def test_rulebook_matches_jax(seed, ss, batch, boundary, monkeypatch):
    """The port's rule equals build_subm_rulebook exactly, and its band
    reduction (rule_spans) equals the interpret-mode Pallas rd kernel's on
    live rows, boundary-heavy grids included."""
    import treelearn_tpu.ops.pallas_rd as prd
    from treelearn_tpu.ops.pallas_conv import rule_spans
    from treelearn_tpu.ops.sparse import build_subm_rulebook as jbsr
    from treelearn_tpu.ops.sparse import grid_from_sorted_keys as jgrid
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys

    monkeypatch.setattr(prd, "_INTERPRET", True)
    keys = _keys_case(seed, ss, 600, batch=batch, boundary_heavy=boundary)
    n = len(keys)
    rule = subm_rulebook(grid_from_sorted_keys(torch.from_numpy(keys),
                                               ss)).numpy()
    v = 2048
    pad = np.full(v, np.iinfo(np.int32).max, np.int32)
    pad[:n] = keys
    g = jgrid(jnp.asarray(pad), jnp.asarray(np.array(ss, np.int32)),
              jnp.int32(n))
    jrule = np.asarray(jbsr(g, 3))
    np.testing.assert_array_equal(rule, jrule[:, :n])

    rule_pad = np.full((27, v), -1, np.int32)
    rule_pad[:, :n] = rule
    sp_port = rule_spans(jnp.asarray(rule_pad), 128, 512, v)
    sp_pallas = prd.build_spans_banded(jnp.asarray(pad), spatial_shape=ss,
                                       capacity=v, tile=128, window=512)
    np.testing.assert_array_equal(np.asarray(sp_port.rd)[:, :n],
                                  np.asarray(sp_pallas.rd)[:, :n])


def _conv_case(seed, cin, cout, n=400, ss=(12, 12, 24)):
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys

    rng = np.random.default_rng(seed)
    keys = _keys_case(seed, ss, n)
    rule = subm_rulebook(grid_from_sorted_keys(torch.from_numpy(keys), ss))
    feats = rng.normal(size=(len(keys), cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    return keys, rule.numpy(), feats, w


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 8), (16, 8)])
def test_subm_conv_f32_matches_jax(cin, cout):
    """f32 against the XLA subm_conv: rtol 1e-5, atol 1e-5 (summation order
    over the 27 offsets differs)."""
    from treelearn_tpu.ops.sparse import subm_conv as jconv
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    keys, rule, feats, w = _conv_case(cin, cin, cout)
    live = np.ones(len(keys), bool)
    want = np.asarray(jconv(jnp.asarray(feats), jnp.asarray(w),
                            jnp.asarray(rule), jnp.asarray(live)))
    got = subm_conv(torch.from_numpy(feats), torch.from_numpy(w),
                    torch.from_numpy(rule)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # rows past n_live are zero
    part = subm_conv(torch.from_numpy(feats), torch.from_numpy(w),
                     torch.from_numpy(rule), n_live=100).numpy()
    assert (part[100:] == 0).all()
    np.testing.assert_array_equal(part[:100], got[:100])


def test_subm_conv_bf16_matches_pallas_interpret(monkeypatch):
    """bf16 inputs against the interpret-mode Pallas subm_conv_banded
    (bf16 products, f32 sums): max error 2e-2 of the output's max magnitude,
    from the bf16 rounding of the inputs and of the output."""
    import treelearn_tpu.ops.pallas_conv as pc
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    monkeypatch.setattr(pc, "_INTERPRET", True)
    keys, rule, feats, w = _conv_case(5, 8, 8, n=300)
    n, v = len(keys), 512
    feats_pad = np.zeros((v, 8), np.float32)
    feats_pad[:n] = feats
    rule_pad = np.full((27, v), -1, np.int32)
    rule_pad[:, :n] = rule
    live = np.arange(v) < n
    want = np.asarray(pc.subm_conv_banded(
        jnp.asarray(feats_pad).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(rule_pad), jnp.asarray(live), tile=256, window=512),
        np.float32)[:n]
    got = subm_conv(torch.from_numpy(feats).bfloat16(), torch.from_numpy(w),
                    torch.from_numpy(rule)).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_down_inverse_conv_match_jax():
    """k=2 s=2 downsample rulebook, down conv and inverse conv against the
    JAX package in f32: rtol 1e-5."""
    from treelearn_tpu.ops import sparse as js
    from treelearn_tpu_torch.ops import sparse as ps

    ss = (13, 12, 10)  # odd x: the last x slice has no parent and drops
    keys = _keys_case(7, ss, 500, batch=2)
    n, v = len(keys), 1024
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    w_down = (rng.normal(size=(8, 8, 16)) * 0.2).astype(np.float32)
    w_up = (rng.normal(size=(8, 16, 8)) * 0.2).astype(np.float32)

    pad = np.full(v, np.iinfo(np.int32).max, np.int32)
    pad[:n] = keys
    jg = js.grid_from_sorted_keys(jnp.asarray(pad), np.array(ss, np.int32),
                                  jnp.int32(n))
    jrb = js.build_downsample(jg, 1024)
    fpad = np.zeros((v, 8), np.float32)
    fpad[:n] = feats
    jd = np.asarray(js.down_conv(jnp.asarray(fpad), jnp.asarray(w_down), jrb))
    ju = np.asarray(js.inverse_conv(jnp.asarray(jd), jnp.asarray(w_up), jrb,
                                    jg.live_mask))

    pg = ps.grid_from_sorted_keys(torch.from_numpy(keys), ss)
    prb = ps.build_downsample(pg)
    n_out = prb.out_grid.n_active
    assert n_out == int(jrb.out_grid.n_active)
    np.testing.assert_array_equal(prb.out_grid.keys.numpy(),
                                  np.asarray(jrb.out_grid.keys)[:n_out])
    np.testing.assert_array_equal(prb.parent_idx.numpy(),
                                  np.asarray(jrb.parent_idx)[:n])
    assert (prb.parent_idx.numpy() < 0).any()
    pd = ps.down_conv(torch.from_numpy(feats), torch.from_numpy(w_down), prb)
    np.testing.assert_allclose(pd.numpy(), jd[:n_out], rtol=1e-5, atol=1e-6)
    pu = ps.inverse_conv(pd, torch.from_numpy(w_up), prb)
    np.testing.assert_allclose(pu.numpy(), ju[:n], rtol=1e-5, atol=1e-6)


def test_down_conv_sums_corner_slots_without_atomics():
    """The down conv adds each parent's children through its 8 (parent,
    corner) slots, not an atomic ``index_add_``: no two kept children share
    a slot, the float32 result equals the float64 scatter-add within 1e-6
    of its max, and the bf16 one (inputs, products and sums rounded to
    bf16's 8 bits) within 2^-6 of it."""
    from treelearn_tpu_torch.ops import sparse as ps

    ss = (13, 12, 10)
    keys = _keys_case(7, ss, 500, batch=2)
    rb = ps.build_downsample(ps.grid_from_sorted_keys(torch.from_numpy(keys),
                                                      ss))
    keep = rb.parent_idx >= 0
    slot = rb.parent_idx[keep] * 8 + rb.corner[keep]
    assert len(torch.unique(slot)) == int(keep.sum())
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(rng.normal(size=(len(keys), 8)))
    w = torch.from_numpy(rng.normal(size=(8, 8, 16)) * 0.2)
    wide = (feats @ w.permute(1, 0, 2).reshape(8, 128)).reshape(-1, 8, 16)
    contrib = wide[torch.arange(len(keys)), rb.corner]
    want = torch.zeros(rb.out_grid.n_active, 16, dtype=torch.float64)
    want.index_add_(0, rb.parent_idx[keep], contrib[keep])
    got = ps.down_conv(feats.float(), w.float(), rb).double()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    got16 = ps.down_conv(feats.bfloat16(), w.bfloat16(), rb).double()
    assert float((got16 - want).abs().max()) <= 2 ** -6 * float(
        want.abs().max())
