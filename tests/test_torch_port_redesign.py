"""The redesigned rulebook and subm-conv kernels of treelearn_tpu_torch, as far
as the CPU reaches: the band-form rulebook algorithm (the plain PyTorch twin
of csrc/rulebook.cu) against the 27-probe rulebook and the JAX package's
banded rd kernel in interpret mode; the launch plan of the tensor-core conv
for every shape of the forward and backward paths; the packed weight images;
and the CPU routing of both wrappers.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

torch.set_num_threads(1)

CHANNELS = [32 * (i + 1) for i in range(7)]
# forward: C -> C at every level, decoder 2C -> C; dx swaps the two
FORWARD_SHAPES = ([(c, c) for c in CHANNELS]
                  + [(2 * c, c) for c in CHANNELS[:-1]])
DX_SHAPES = [(cout, cin) for cin, cout in FORWARD_SHAPES]
LEVEL_VOXELS = [420575, 176561, 42437, 9961, 2341, 561, 136]


def _grid(keys, ss):
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys

    keys = np.unique(np.asarray(keys, np.int64)).astype(np.int32)
    return grid_from_sorted_keys(torch.from_numpy(keys), ss)


def _encode(b, x, y, z, ss):
    return ((b * ss[0] + x) * ss[1] + y) * ss[2] + z


@st.composite
def sparse_grids(draw):
    """Two-element batches with voxels on every face, the last x row of
    element 0 and the first of element 1, a dense 3x3x3 block, isolated
    voxels and a random rest."""
    ss = (draw(st.integers(3, 7)), draw(st.integers(3, 7)),
          draw(st.integers(3, 7)))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    keys = []
    for b in range(2):
        n = int(rng.integers(1, 40))
        xyz = np.stack([rng.integers(0, s, n) for s in ss], 1)
        # pin some voxels to each of the six faces
        for axis in range(3):
            for side in (0, ss[axis] - 1):
                face = xyz[rng.integers(0, n, 3)].copy()
                face[:, axis] = side
                xyz = np.concatenate([xyz, face])
        keys.append(_encode(b, xyz[:, 0], xyz[:, 1], xyz[:, 2], ss))
    # the batch seam
    y, z = int(rng.integers(0, ss[1])), int(rng.integers(0, ss[2]))
    keys.append(np.array([_encode(0, ss[0] - 1, y, z, ss),
                          _encode(1, 0, y, z, ss)]))
    if draw(st.booleans()):
        o = [int(rng.integers(0, s - 2)) for s in ss]
        bx, by, bz = np.meshgrid(*[np.arange(3) + a for a in o], indexing="ij")
        keys.append(_encode(int(rng.integers(0, 2)), bx.ravel(), by.ravel(),
                            bz.ravel(), ss))
    return np.concatenate(keys), ss


@settings(max_examples=60, deadline=None)
@given(sparse_grids())
def test_banded_rulebook_equals_probe_rulebook(case):
    from treelearn_tpu_torch.ops.sparse import (build_subm_rulebook,
                                                build_subm_rulebook_banded)

    keys, ss = case
    g = _grid(keys, ss)
    assert torch.equal(build_subm_rulebook_banded(g),
                       build_subm_rulebook(g, 3))


@pytest.mark.parametrize("keys,ss", [
    ([13], (3, 3, 3)),                        # one isolated voxel
    ([0, 26], (3, 3, 3)),                     # two opposite corners
    ([2, 3], (3, 3, 3)),                      # adjacent keys, not neighbors
    ([8, 9], (3, 3, 3)),                      # (0,2,2) and (1,0,0)
    ([26, 27], (3, 3, 3)),                    # batch seam, adjacent keys
    (list(range(54)), (3, 3, 3)),             # two dense elements
    ([0, 1, 2, 3], (1, 1, 4)),                # a single z column
    ([0, 1, 2, 3], (4, 1, 1)),                # sz = 1: no z neighbors at all
    ([], (3, 3, 3)),
])
def test_banded_rulebook_edge_cases(keys, ss):
    from treelearn_tpu_torch.ops.sparse import (build_subm_rulebook,
                                                build_subm_rulebook_banded)

    g = _grid(keys, ss)
    got = build_subm_rulebook_banded(g)
    assert got.dtype == torch.int32 and got.shape == (27, len(keys))
    if keys:
        assert torch.equal(got, build_subm_rulebook(g, 3))


@pytest.mark.parametrize("seed,ss,batch,boundary", [
    (0, (20, 24, 16), 1, False),
    (1, (20, 24, 16), 1, True),
    (2, (12, 10, 8), 3, False),
    (3, (12, 10, 8), 2, True),
])
def test_banded_rulebook_matches_pallas_rd(seed, ss, batch, boundary,
                                           monkeypatch):
    """The band-form rule equals the interpret-mode Pallas rd kernel's spans,
    decoded: rd = r0 * 64 + fields, two bits per dz holding 1 + the target's
    rank in the run that starts at slot r0 (0 = absent)."""
    import treelearn_tpu.ops.pallas_rd as prd
    from treelearn_tpu_torch.ops.sparse import build_subm_rulebook_banded

    monkeypatch.setattr(prd, "_INTERPRET", True)
    rng = np.random.default_rng(seed)
    space = int(np.prod(ss))
    keys = []
    for b in range(batch):
        if boundary:
            x = rng.choice([0, 1, ss[0] - 1], 600)
            y = rng.integers(0, ss[1], 600)
            z = rng.choice([0, 1, ss[2] - 2, ss[2] - 1], 600)
            keys.append(_encode(b, x, y, z, ss))
        else:
            keys.append(b * space + rng.choice(space, 600, replace=False))
    g = _grid(np.concatenate(keys), ss)
    n = g.n_active
    v = 2048
    pad = np.full(v, np.iinfo(np.int32).max, np.int32)
    pad[:n] = g.keys.numpy()
    rd = np.asarray(prd.build_spans_banded(
        jnp.asarray(pad), spatial_shape=ss, capacity=v, tile=128,
        window=512).rd)[:, :n]
    decoded = np.full((27, n), -1, np.int32)
    for band in range(9):
        r0 = rd[band] >> 6
        for dz in range(3):
            field = (rd[band] >> (2 * dz)) & 3
            hit = (rd[band] >= 0) & (field > 0)
            decoded[band * 3 + dz] = np.where(hit, r0 + field - 1, -1)
    np.testing.assert_array_equal(build_subm_rulebook_banded(g).numpy(),
                                  decoded)


@pytest.mark.parametrize("cin,cout", sorted(set(FORWARD_SHAPES + DX_SHAPES)))
def test_conv_plan_fits_the_card(cin, cout):
    """Every bf16 shape of the forward and dx paths at channels 32 x 7
    levels, at every level's voxel count: tensor-core route, the N splits
    cover Cout with an instruction width, BK divides Cin, the ring holds the
    epilogue's output tile, and the block fits the 232,448 bytes of dynamic
    shared memory a block may use."""
    from treelearn_tpu_torch.ops.subm_conv import SMEM_LIMIT, conv_plan

    assert SMEM_LIMIT == 232448
    for v in LEVEL_VOXELS + [1, 64, 8191, 8192]:
        p = conv_plan(cin, cout, v)
        assert p.route == "wgmma"
        assert p.bm in (64, 128)
        assert p.n_splits * p.bn == cout
        assert p.bn % 32 == 0 and 32 <= p.bn <= 256
        assert p.bk == 32 and cin % p.bk == 0
        assert 2 <= p.stages <= 8
        assert p.producers in (128, 256)
        assert 2 * p.bm + p.producers <= 1024   # threads of a block
        ring = p.stages * (p.bm + p.bn) * p.bk * 2
        assert p.bm * (p.bn + 8) * 2 <= ring
        assert (ring + 128 + 27 * p.bm * 4 + 1024 + 220 <= p.smem_bytes
                <= SMEM_LIMIT)
    big, small = conv_plan(cin, cout, 420575), conv_plan(cin, cout, 136)
    assert big.n_splits == (2 if cout > 256 else 1)
    assert big.bm == (128 if cout == 32 else 64)
    assert (small.bm, small.bn) == (64, 32)


@pytest.mark.parametrize("cin,cout,dtype", [
    (32, 32, torch.float32), (224, 224, torch.float32),
    (4, 32, torch.bfloat16), (4, 32, torch.float32),
    (16, 24, torch.bfloat16), (32, 40, torch.bfloat16)])
def test_conv_plan_routes_float32_and_odd_widths_to_simt(cin, cout, dtype):
    """Widths in multiples of 8 take the tensor-core route of their dtype
    (3xTF32 in float32, never the bf16 one; wgmma in bf16, 16 -> 24 and
    32 -> 40 since the bf16 kernel takes any multiple of 8); the plan of a
    width that is none (the unpadded 4 -> 32 input conv) is the SIMT
    kernel's, which the wrappers avoid by padding first."""
    from treelearn_tpu_torch.ops.subm_conv import conv_plan

    tc = cin % 8 == 0 and cout % 8 == 0
    want = ("simt" if not tc else "tf32x3" if dtype == torch.float32
            else "wgmma")
    assert conv_plan(cin, cout, 100000, dtype).route == want


def _unpack(packed):
    """Read a packed weight image back into (27, Cin, Cout), element by
    element from the layout the kernel's descriptors expect: row n of tile
    (k, j, s) is output channel j*bn + n, and its 16-byte chunk at position
    p holds input channels s*32 + 8*(p ^ ((n >> 1) & 3)) .. + 8."""
    packed = packed.float().numpy()
    k, n_splits, n_slices, bn, _ = packed.shape
    w = np.zeros((k, n_slices * 32, n_splits * bn), np.float32)
    for n in range(bn):
        for p in range(4):
            c = p ^ ((n >> 1) & 3)
            for s in range(n_slices):
                # (k, j, 8 channels) -> (k, 8 channels, j)
                w[:, 32 * s + 8 * c:32 * s + 8 * c + 8, n::bn] = (
                    packed[:, :, s, n, 8 * p:8 * p + 8].transpose(0, 2, 1))
    return torch.from_numpy(w).to(torch.bfloat16)


@pytest.mark.parametrize("cin,cout,bn", [
    (32, 64, 64), (64, 32, 32), (224, 224, 224), (224, 224, 32),
    (192, 384, 192)])
def test_pack_weight_unpacks_to_the_weight(cin, cout, bn):
    """The packed image read back by the layout's definition gives W: a
    silently transposed tile would put W[k, n, c] where W[k, c, n] belongs
    and fail for cin != cout.  The mirrored weights go through the same
    pack, from the mirrored tensor or straight from W."""
    from treelearn_tpu_torch.ops.subm_conv import mirrored, pack_weight

    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(
        np.float32)).to(torch.bfloat16)
    packed = pack_weight(w, bn)
    assert packed.shape == (27, cout // bn, cin // 32, bn, 32)
    assert packed.is_contiguous()
    assert torch.equal(_unpack(packed), w)
    wm = mirrored(w)
    assert wm.shape == (27, cout, cin)
    assert torch.equal(_unpack(pack_weight(wm, 32)),
                       w.flip(0).transpose(1, 2))
    assert torch.equal(pack_weight(w, 32, mirror=True), pack_weight(wm, 32))


def test_cpu_wrappers_take_the_plain_versions(monkeypatch):
    """On CPU tensors neither wrapper reaches the kernel library, whatever
    the dtype and width, and no launch is counted."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook
    from treelearn_tpu_torch.ops.sparse import build_subm_rulebook
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import subm_conv

    def no_library():
        raise AssertionError("the CPU route must not build the kernels")

    monkeypatch.setattr(_cuda, "library", no_library)
    before = dict(_cuda.LAUNCHES)
    rng = np.random.default_rng(0)
    g = _grid(rng.choice(20 * 20 * 10, 500, replace=False), (20, 20, 10))
    rule = subm_rulebook(g)
    assert torch.equal(rule, build_subm_rulebook(g, 3))
    for dtype, cin, cout in ((torch.bfloat16, 32, 64), (torch.float32, 4, 8)):
        x = torch.from_numpy(rng.normal(size=(g.n_active, cin)).astype(
            np.float32)).to(dtype)
        w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(
            np.float32))
        assert torch.equal(subm_conv(x, w, rule, n_live=400),
                           plain(x, w, rule, 400))
    assert _cuda.LAUNCHES == before


def test_cuda_only_entries_refuse_cpu_tensors():
    """The yardstick entries launch kernels and nothing else: a CPU tensor
    raises instead of taking a plain version."""
    from treelearn_tpu_torch.ops.rulebook import subm_rulebook_probes
    from treelearn_tpu_torch.ops.subm_conv import subm_conv_simt

    g = _grid([13, 14], (3, 3, 3))
    with pytest.raises(ValueError):
        subm_rulebook_probes(g)
    with pytest.raises(ValueError):
        subm_conv_simt(torch.zeros(2, 32), torch.zeros(27, 32, 32),
                       torch.zeros(27, 2, dtype=torch.int32))
