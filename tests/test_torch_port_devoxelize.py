"""devoxelize as an autograd function (ops/voxelize.py:DevoxelizeFn) on the
CPU: its forward and gradient against the gather it replaced
(``feats[v2p.clamp(0, V-1)]`` and ``where`` under autograd), the voxel ->
point CSR (``voxel_point_csr`` of a ``voxelize_points`` batch) against a
numpy construction, padded rows,
gradcheck and the backward's counter.  The CUDA kernels are held to the
plain versions on the card (tests/test_torch_port_cuda.py)."""

import numpy as np
import pytest
import torch

from treelearn_tpu_torch.data.dataset import collate_padded
from treelearn_tpu_torch.ops.hashing import SENTINEL
from treelearn_tpu_torch.ops.voxelize import (devoxelize,
                                              devoxelize_backward_plain,
                                              voxel_point_csr,
                                              voxelize_points)
from treelearn_tpu_torch.utils.trace import SpanTimer

VOXEL = 0.1


def _crop(rng, n_voxels, max_run):
    """Points in ``n_voxels`` distinct cells of a 0.1 m grid, 1 to
    ``max_run`` a cell (both ends drawn), shuffled.  Every point sits 0.01
    to 0.05 m past its cell's corner, measured from an anchor point at
    (0, 0, 0) that is the crop's min corner, so no point lies near a cell
    boundary."""
    cells = rng.choice(20 * 20 * 10, n_voxels, replace=False)
    ijk = np.stack(np.unravel_index(cells, (20, 20, 10)), 1)
    runs = rng.integers(1, max_run + 1, n_voxels)
    runs[:2] = (1, max_run)
    pts = np.repeat(ijk, runs, 0) * VOXEL + rng.uniform(
        0.01, 0.05, (runs.sum(), 3))
    pts = np.concatenate([np.zeros((1, 3)), pts])[rng.permutation(
        runs.sum() + 1)]
    return {"coords": (pts + 5.0).astype(np.float32),
            "input_feats": np.ones((len(pts), 1), np.float32)}


def _batch(case):
    """(VoxelizedBatch, valid) of one collated batch."""
    rng = np.random.default_rng(7)
    if case == "bucket":        # 2 crops padded to 16,384 rows, most padded
        samples, kw = [_crop(rng, 150, 40), _crop(rng, 120, 40)], {}
    elif case == "unpadded":    # one crop, no padded row
        samples = [_crop(rng, 60, 12)]
        kw = {"pad_to": sum(len(s["coords"]) for s in samples)}
    elif case == "few_padded":  # one small crop and 40 padded rows
        samples = [_crop(rng, 20, 6)]
        kw = {"pad_to": sum(len(s["coords"]) for s in samples) + 40}
    else:                       # "all_padded": every row padded, V = 0
        samples = [_crop(rng, 30, 5)]
        kw = {}
    b = collate_padded(samples, **kw)
    valid = b["valid"] & (case != "all_padded")
    vb = voxelize_points(
        torch.from_numpy(b["coords"]), torch.from_numpy(b["input_feats"]),
        torch.from_numpy(b["batch_ids"]), torch.from_numpy(valid),
        batch_size=len(samples), voxel_size=VOXEL,
        spatial_shape=(32, 32, 16))
    return vb, valid


def _old(feats, v2p):
    """The gather devoxelize was before its backward became a kernel."""
    v = feats.shape[0]
    if v == 0:
        return feats.new_zeros((v2p.shape[0], feats.shape[1]))
    out = feats[v2p.clamp(0, v - 1)]
    return torch.where((v2p < v)[:, None], out, torch.zeros_like(out))


def _grad(fn, feats, g):
    """(output, gradient of <output, g>) by autograd; the old gather of an
    empty voxel set has no graph, so its gradient is the empty zeros."""
    x = feats.detach().clone().requires_grad_(True)
    out = fn(x)
    if not out.requires_grad:
        return out, torch.zeros_like(x)
    (gx,) = torch.autograd.grad(out, x, g)
    return out.detach(), gx


@pytest.mark.parametrize("case", ["bucket", "unpadded", "all_padded"])
def test_devoxelize_equals_old_gather_bit_for_bit(case):
    vb, valid = _batch(case)
    rng = np.random.default_rng(1)
    v = vb.n_voxels
    feats = torch.from_numpy(rng.standard_normal((v, 32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (len(valid), 32)).astype(np.float32))
    if case == "bucket":
        _, v_start = voxel_point_csr(vb.order, vb.v2p_map, v)
        runs = np.diff(v_start.numpy())
        assert runs.min() == 1 and runs.max() == 40
        assert (~valid).sum() > valid.sum()
    out, gx = _grad(lambda x: devoxelize(x, vb), feats, g)
    want_out, want_gx = _grad(lambda x: _old(x, vb.v2p_map), feats, g)
    assert torch.equal(out, want_out)
    assert torch.equal(gx, want_gx)
    assert gx.shape == (v, 32)


@pytest.mark.parametrize("case", ["bucket", "unpadded", "all_padded"])
def test_voxel_point_csr_equals_numpy(case):
    """p_order is the stable argsort of the points' voxel keys (padded
    points keyed SENTINEL, so last) and v_start[v] the number of live
    points in voxels before v."""
    vb, valid = _batch(case)
    v2p = vb.v2p_map.numpy()
    v = vb.n_voxels
    keys = np.full(len(v2p), SENTINEL, np.int64)
    keys[valid] = vb.voxel_keys.numpy()[v2p[valid]]
    p_order, v_start = voxel_point_csr(vb.order, vb.v2p_map, v)
    assert p_order.dtype == torch.int32 and v_start.dtype == torch.int32
    np.testing.assert_array_equal(p_order.numpy(),
                                  np.argsort(keys, kind="stable"))
    counts = np.bincount(v2p[valid], minlength=v)
    np.testing.assert_array_equal(
        v_start.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert v_start.shape == (v + 1,) and v_start[-1] == valid.sum()


def test_padded_rows_contribute_nothing_to_the_gradient():
    vb, valid = _batch("bucket")
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal(
        (vb.n_voxels, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (len(valid), 16)).astype(np.float32))
    g_nan = g.clone()
    g_nan[torch.from_numpy(~valid)] = float("nan")
    g_zero = g.clone()
    g_zero[torch.from_numpy(~valid)] = 0.0
    fn = lambda x: devoxelize(x, vb)  # noqa: E731
    _, with_nan = _grad(fn, feats, g_nan)
    _, with_zero = _grad(fn, feats, g_zero)
    assert torch.isfinite(with_nan).all()
    assert torch.equal(with_nan, with_zero)
    # and the plain backward alone, in bf16: one rounding of the float32 sum
    gb = g_nan.to(torch.bfloat16)
    got = devoxelize_backward_plain(gb, vb.v2p_map, vb.n_voxels)
    want = torch.zeros((vb.n_voxels, 16)).index_add_(
        0, vb.v2p_map[torch.from_numpy(valid)],
        gb[torch.from_numpy(valid)].float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_devoxelize_gradcheck_float64():
    vb, valid = _batch("few_padded")
    assert (~valid).sum() == 40
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal(
        (vb.n_voxels, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: devoxelize(x, vb), (feats,), eps=1e-6, atol=1e-8)


def test_backward_counts_the_plain_route_once_a_call():
    vb, valid = _batch("unpadded")
    feats = torch.ones((vb.n_voxels, 8), requires_grad=True)
    with SpanTimer("cpu") as timer:
        for _ in range(3):
            devoxelize(feats, vb).sum().backward()
        with torch.no_grad():
            devoxelize(feats, vb)
    assert timer.counters() == {"devoxelize.bwd.plain": 3}
    # every point of a voxel adds one to its gradient
    _, v_start = voxel_point_csr(vb.order, vb.v2p_map, vb.n_voxels)
    assert torch.equal(feats.grad[:, 0], 3 * torch.diff(v_start).float())
