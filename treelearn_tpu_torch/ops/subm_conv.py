"""Submanifold sparse conv — kernel 2 of the port (the hottest one) — its
weight gradient — kernel 3 — and the autograd function over both.

Replaces the Pallas kernel ``subm_conv_banded`` (``_subm_kernel`` +
``_gather_bands``, treelearn_tpu/ops/pallas_conv.py:355,304,181).  The TPU
kernel reaches its neighbors through banded DMA windows of the sorted
features and one-hot MXU selects, with a span-overflow fallback; a GPU
gathers rows cheaply, so the CUDA kernels are plain gather-GEMMs over the
(K, V) rule from ops/rulebook.py, output-stationary with float32 sums in
registers.  No windows, so nothing can overflow.

* csrc/subm_conv_wgmma.cu, the bf16 route: a block owns 64 or 128 output
  voxels x up to 256 output channels (any multiple of 8) and multiplies on
  the tensor cores (``wgmma``), gathered rows and packed weight tiles
  arriving through a ``cp.async`` ring (:func:`conv_plan`,
  :func:`pack_weight`); Cin in 32-channel K slices and a 16-channel tail.
* csrc/subm_conv_tf32.cu, the float32 route (``"tf32x3"``): the same
  gather-GEMM on the tensor cores in TF32, each product taken as three
  (``hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b)``, :func:`tf32_split`), which
  keeps float32 accuracy; widths in multiples of 8 (:func:`conv_plan_tf32`,
  :func:`pack_weight_tf32`).
* Both take the offset count as an argument: K = k^3 for any odd kernel
  size up to 7 (``TF32_MAX_OFFSETS`` = 343), as the JAX package's rulebook
  conv takes any odd k.
* Other widths are zero-padded onto them, the output cut back
  (:func:`tensor_core_pad`, :func:`cout_pad`): Cin to a multiple of 8 (in
  bf16 a Cin below 32, the 4 -> 32 input conv, to 32), Cout to a multiple
  of 8.  Zero channels add exactly.
* K > 343 (kernel size 9 and up; no shipped config) has no conv kernel:
  the plan is ``"plain"`` and the wrappers run ops/sparse.py:subm_conv on
  the card's tensors, as model/network.py:level_rule builds the rule of
  any k other than 3 with the plain probe builder.  Its ``index_add_``
  adds each output row at most once per offset, so it is deterministic
  there too.  The dW kernels take any offset count; a dW width that is no
  multiple of 8 at K > 343 takes ops/sparse.py:subm_conv_dw likewise.

Kernel 3 replaces ``rule_conv_dw_banded`` (``_dw_kernel``,
pallas_conv.py:438,415): every route sums per-chunk partial weight
gradients and adds the chunks in order in a second pass, so dW is
deterministic (see the sources for why not atomics).

* csrc/subm_conv_dw_wgmma.cu, the bf16 route: ``dW[k] = X_k^T G`` on the
  tensor cores with the voxel rows as the reduction dimension, both
  operands MN-major straight from row-major rows in shared memory, M the
  flattened (offset, input channel) axis in 8-channel chunks, so any Cin
  in multiples of 8 and any offset count (:func:`dw_plan`).
* csrc/subm_conv_dw_tf32.cu, the float32 route: the same product in
  3xTF32, X_k^T from registers and G transposed into K-major hi and lo
  images by the consumers (:func:`dw_plan_tf32`).

:class:`SubmConvFn` is the counterpart of ``rule_conv_ad``
(pallas_conv.py:588-649): forward kernel 2; backward dx = kernel 2 on the
output gradient with weights ``W.flip(0).transpose(1, 2)`` over the same
rule (a submanifold rule is its own transpose under offset mirroring, and
``kernel_offsets`` is ordered so that ``flip(0)`` mirrors); dW = kernel 3.

Bound on the card: operations by the count (2 x Cin x Cout FLOPs per rule
entry, against Cin + Cout values moved per voxel; three TF32 products each
on the float32 route), but at 32..224 channels the tensor cores finish that
in microseconds, and what the tensor-core routes pay for is the gather of
feature rows through L2 (levels 0-1) and the length of one block's K loop
(the deepest levels).  The weight gradient is bound the same way: its
products take microseconds on the tensor cores, a launch pays for the
16-byte copies of the gathered rows and of g (once per offset and input
slice) and, below a few thousand rows, for the launch and the Python
wrapper around it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _cuda
from .sparse import subm_conv as subm_conv_plain
from .sparse import subm_conv_dw as subm_conv_dw_plain

_DTYPES = (torch.float32, torch.bfloat16)

SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
BK = 32               # input channels per K step of the wgmma kernel
MAX_BN = 256          # widest wgmma instruction
SMALL_V_TILES = 32    # fewer 64-row tiles than this: 32-channel blocks
ONE_WAVE_BLOCKS = 132  # a grid up to one block per SM: 8 producer warps
WIDE_ROWS_V = 65536   # from here on a 32-channel conv takes 128-row blocks
N_OFFSETS = 27        # offsets of a kernel_size 3 conv, the default
TF32_K = 8            # channels of one k8 step: widths must be multiples
                      # of it for either tensor-core route
BF16_BN = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
           256)       # the bf16 conv's block widths that are instantiated
TF32_BN = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128)  # its block
                      # widths: two float32 register sets (the slot's
                      # products, the running sum) cap them at 128
TF32_STAGES = 3       # ring depth of both 3xTF32 kernels
TF32_MAX_OFFSETS = 343  # kernel_size 7: the largest rule tile either
                        # tensor-core conv takes


class ConvPlan(NamedTuple):
    """What the launcher of kernel 2 uses for one shape."""

    route: str        # "wgmma", "tf32x3" or "plain" (tiling fields 0)
    bm: int           # output voxels per block
    bn: int           # output channels per block
    n_splits: int     # blocks along Cout (n_splits * bn == cout)
    bk: int           # input channels per K step (tf32x3: per ring slot)
    stages: int       # ring depth
    producers: int    # threads of a block that start the copies
    smem_bytes: int   # dynamic shared memory per block


def plan_smem_bytes(bm: int, bn: int, stages: int,
                    n_offsets: int = N_OFFSETS) -> int:
    """Dynamic shared memory of a wgmma block: alignment slack, the ring of
    A and B tiles, the mbarriers, the block's ``n_offsets`` x bm rule
    entries and its offset lists (2 n_offsets + 1 ints, 256 bytes at
    least)."""
    return (1024 + stages * (bm + bn) * BK * 2 + 128 + n_offsets * bm * 4
            + max(256, 4 * (2 * n_offsets + 1)))


def bf16_bn(cout: int) -> int:
    """Block width of the bf16 conv for ``cout`` output channels: a Cout in
    multiples of 32 is split into the fewest equal blocks of multiples of
    32 up to ``MAX_BN`` (384 -> 192; the split of every shipped width);
    any other multiple of 8 into the fewest equal blocks that
    :data:`BF16_BN` has (48 -> 48, 336 -> 112, 136 -> 8)."""
    n = 1
    if cout % 32 == 0:
        while cout % n or (cout // n) % 32 or cout // n > MAX_BN:
            n += 1
    else:
        while cout % n or cout // n not in BF16_BN:
            n += 1
    return cout // n


def tf32_bn(cout: int) -> int:
    """Block width of the 3xTF32 kernels for ``cout`` output channels: the
    whole Cout where :data:`TF32_BN` has it, else its largest even share
    there (224 -> 112, 384 -> 128, 136 -> 8)."""
    n = 1
    while cout % n or cout // n not in TF32_BN:
        n += 1
    return cout // n


def plan_smem_bytes_tf32(bn: int, sk: int, stages: int,
                         n_offsets: int) -> int:
    """Dynamic shared memory of a 3xTF32 conv block: alignment slack, the
    ring of A tiles (64 rows x ``sk`` float32) and hi and lo B images
    (2 x ``bn`` x ``sk`` float32), the mbarriers, the block's ``n_offsets``
    x 64 rule entries and its offset lists."""
    return (1024 + stages * (64 * sk + 2 * bn * sk) * 4 + 128
            + 4 * (64 * n_offsets + 2 * n_offsets + 1))


def conv_plan_tf32(cin: int, cout: int, v: int,
                   n_offsets: int = N_OFFSETS) -> ConvPlan:
    """The 3xTF32 plan of a float32 conv (``cin``, ``cout`` multiples of 8).
    A block owns 64 output voxels and :func:`tf32_bn` output channels; on a
    level with fewer than ``SMALL_V_TILES`` row tiles a Cout in multiples
    of 32 is split into 32-channel blocks to fill the card, as the bf16
    plan does.  A ring slot holds the widest slice of 32, 16 or 8 input
    channels that divides Cin (4, 2 or 1 k8 steps); ``TF32_STAGES`` slots,
    fewer (then narrower slices) where the rule tile of many offsets would
    not fit ``SMEM_LIMIT``."""
    bn = tf32_bn(cout)
    if -(-v // 64) < SMALL_V_TILES and cout % 32 == 0:
        bn = 32
    sk = 32 if cin % 32 == 0 else (16 if cin % 16 == 0 else 8)
    stages = TF32_STAGES
    while plan_smem_bytes_tf32(bn, sk, stages, n_offsets) > SMEM_LIMIT:
        if stages > 2:
            stages -= 1
        else:
            sk //= 2
    return ConvPlan("tf32x3", 64, bn, cout // bn, sk, stages, 128,
                    plan_smem_bytes_tf32(bn, sk, stages, n_offsets))


def conv_plan(cin: int, cout: int, v: int,
              dtype: torch.dtype = torch.bfloat16,
              n_offsets: int = N_OFFSETS) -> ConvPlan:
    """Static routing and tiling of kernel 2, from the shape alone.

    ``cin`` and ``cout`` multiples of 8 and at most ``TF32_MAX_OFFSETS``
    offsets: bf16 -> the wgmma kernel, float32 -> the 3xTF32 kernel
    (:func:`conv_plan_tf32`).  Anything else is ``"plain"``, the plain
    version: the wrappers zero-pad other widths onto the tensor cores first
    (:func:`tensor_core_pad`, :func:`cout_pad`), so only K > 343 reaches
    it.

    The wgmma kernel gives a block 64 output voxels (one consumer warpgroup
    beside the producer warpgroup) and the whole Cout, or the largest even
    share of it that fits the widest instruction (:func:`bf16_bn`), so each
    gathered row is read once or twice.  Three measured rules (H100, the
    shapes of chip_smoke.py's paths): with fewer than ``SMALL_V_TILES`` row
    tiles most of the card would idle, so small levels split Cout into
    32-channel blocks (16 or 8 where Cout is no multiple of 32); a
    32-channel conv over ``WIDE_ROWS_V`` voxels or more, where a block's
    fixed costs outweigh its products, takes 128 voxels a block; and a
    grid of at most ``ONE_WAVE_BLOCKS`` blocks, whose length is one block's
    K loop, gives each block 8 producer warps instead of 4 (larger grids
    lose more by the lower occupancy than they gain).  The block's rule
    tile grows with the offset count (88 KB at K = 343 and 64 rows): where
    the block would not fit ``SMEM_LIMIT`` it gives up ring slots, then
    rows.
    """
    if (cin <= 0 or cout <= 0 or cin % TF32_K or cout % TF32_K
            or n_offsets > TF32_MAX_OFFSETS or dtype not in _DTYPES):
        return ConvPlan("plain", 0, 0, 0, 0, 0, 0, 0)
    if dtype == torch.float32:
        return conv_plan_tf32(cin, cout, v, n_offsets)
    bm, bn = 64, bf16_bn(cout)
    if -(-v // 64) < SMALL_V_TILES:
        bn = 32 if cout % 32 == 0 else (16 if cout % 16 == 0 else 8)
    elif bn == 32 and v >= WIDE_ROWS_V:
        bm = 128
    stages = 4
    while plan_smem_bytes(bm, bn, stages, n_offsets) > SMEM_LIMIT:
        if stages > 2:
            stages -= 1
        elif bm == 128:
            bm = 64
        else:
            break
    blocks = -(-v // bm) * (cout // bn)
    producers = 256 if blocks <= ONE_WAVE_BLOCKS else 128
    return ConvPlan("wgmma", bm, bn, cout // bn, BK, stages, producers,
                    plan_smem_bytes(bm, bn, stages, n_offsets))


def tensor_core_pad(cin: int, cout: int, v: int, dtype: torch.dtype,
                    n_offsets: int = N_OFFSETS) -> int:
    """Zero input channels to append so that a conv whose Cin is no
    multiple of 8, or its weight gradient, takes the tensor-core route of
    its dtype; 0 where Cin already is one, or where the shape takes the
    plain version (K > ``TF32_MAX_OFFSETS``).  Zeros add exactly, so the
    result differs from the unpadded conv's by the order of its float32
    sums only.

    float32: to the next multiple of 8 (4 -> 8 for the input conv).  bf16:
    a Cin below one K slice to 32 (the 4 -> 32 input conv, whose plan,
    launches and bits this keeps), a wider one to the next multiple of 8.
    At any row count ``v``."""
    if (cin <= 0 or not cin % TF32_K or cout <= 0 or dtype not in _DTYPES
            or n_offsets > TF32_MAX_OFFSETS):
        return 0
    if dtype == torch.bfloat16 and cin < BK:
        return BK - cin
    return -cin % TF32_K


def cout_pad(cout: int, dtype: torch.dtype,
             n_offsets: int = N_OFFSETS) -> int:
    """Zero output channels to append so that a conv, or its weight
    gradient, whose Cout is no multiple of 8 takes the tensor-core route of
    its dtype (the extra columns of the output or of dW are cut off
    again); 0 where it is one or where the shape takes the plain version.
    """
    if cout <= 0 or dtype not in _DTYPES or n_offsets > TF32_MAX_OFFSETS:
        return 0
    return -cout % TF32_K


def k_slices(cin: int):
    """(slices, tail, kpad) of the bf16 conv's K loop over ``cin`` input
    channels: 32-channel slices, the last one 16 wide (``tail``) where
    ``cin % 32`` is 8 or 16; ``kpad`` channels a weight-image row, the
    channels past ``cin`` zero (a rest of 24 takes a full slice)."""
    n = -(-cin // BK)
    tail = bool(cin % BK) and cin % BK <= 16
    return n, tail, (n - 1) * BK + 16 if tail else n * BK


@functools.lru_cache(maxsize=None)
def _pack_index(cin: int, cout: int, bn: int, n_offsets: int) -> torch.Tensor:
    """For every 16-byte chunk of the packed images, the chunk of the
    (n_offsets, cout, kpad) transposed, zero-padded weight it holds (see
    :func:`pack_weight`)."""
    n_slices, tail, kpad = k_slices(cin)
    full, n_splits = n_slices - tail, cout // bn
    k = torch.arange(n_offsets).view(-1, 1, 1, 1)
    j = torch.arange(n_splits).view(1, -1, 1, 1)
    n = torch.arange(bn).view(1, 1, -1, 1)
    row = (k * cout + j * bn + n) * (kpad // 8)   # first chunk of a row
    s = torch.arange(full).view(1, 1, -1, 1, 1)
    p = torch.arange(4).view(1, 1, 1, 1, 4)
    parts = [(row.unsqueeze(2) + s * 4 + (p ^ ((n.unsqueeze(2) >> 1) & 3))
              ).reshape(n_offsets, n_splits, -1)]
    if tail:
        p = torch.arange(2).view(1, 1, 1, 2)
        parts.append((row + full * 4 + (p ^ ((n >> 2) & 1))).reshape(
            n_offsets, n_splits, -1))
    return torch.cat(parts, 2).reshape(-1)


def _packed_view(packed: torch.Tensor, k: int, cin: int, cout: int,
                 bn: int) -> torch.Tensor:
    n_slices, tail, kpad = k_slices(cin)
    if tail:
        return packed.view(k, cout // bn, bn * kpad)
    return packed.view(k, cout // bn, n_slices, bn, BK)


def pack_weight(weight: torch.Tensor, bn: int,
                mirror: bool = False) -> torch.Tensor:
    """(K, Cin, Cout) -> the shared-memory images of the wgmma kernel's B
    tiles: for offset k and column split j one image of ``bn`` rows (output
    channels) x kpad input channels (:func:`k_slices`), one tile per K
    slice s, K-major.  A 32-channel slice's tile has 64-byte rows in the
    64-byte swizzle: the 16-byte chunk c of row n lies at chunk position
    ``c ^ ((n >> 1) & 3)``; the 16-channel tail's tile 32-byte rows in the
    32-byte swizzle, chunk c at ``c ^ ((n >> 2) & 1)``.  Channels past Cin
    are zeros.  The conv kernel copies a tile linearly into shared memory.
    Shape (K, Cout / bn, Cin / 32, bn, 32) where every slice is full, else
    (K, Cout / bn, bn * kpad).

    With ``mirror`` the images are those of :func:`mirrored` ``(weight)``,
    the weights of the conv's input gradient, read straight from ``weight``.
    CPU tensors are packed with torch ops (the plain version); CUDA tensors
    by the pack kernel of csrc/subm_conv_wgmma.cu (bf16 only)."""
    if not weight.is_cuda:
        w = mirrored(weight) if mirror else weight
        k, cin, cout = w.shape
        kpad = k_slices(cin)[2]
        t = F.pad(w.transpose(1, 2), (0, kpad - cin)).contiguous().view(-1, 8)
        return _packed_view(t[_pack_index(cin, cout, bn, k)], k, cin, cout,
                            bn)
    _cuda.require(weight, "pack_weight weight", torch.bfloat16, 3)
    k, cin, cout = weight.shape
    if mirror:
        cin, cout = cout, cin
    if cin <= 0 or cin % 8 or bn % 8 or cout % bn:
        raise ValueError(f"pack_weight: weight {tuple(weight.shape)}, bn {bn}")
    return _pack_cuda(weight, cin, cout, bn, k, mirror,
                      _cuda.stream_ptr(weight))


def _pack_cuda(weight, cin, cout, bn, n_offsets, mirror, stream):
    """The pack kernel on a checked bf16 CUDA weight; (cin, cout) are the
    conv's, i.e. swapped against ``weight``'s with ``mirror``."""
    packed = torch.empty(n_offsets * cout * k_slices(cin)[2],
                         dtype=weight.dtype, device=weight.device)
    code = _cuda.library().tl_pack_weight(
        weight.data_ptr(), packed.data_ptr(), cin, cout, bn, n_offsets,
        int(mirror), stream)
    _cuda.check(code, "tl_pack_weight")
    return _packed_view(packed, n_offsets, cin, cout, bn)


def tf32_split(x: torch.Tensor):
    """float32 ``x`` -> (hi, lo) float32: ``hi`` is x rounded to TF32 (10
    mantissa bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``),
    ``lo`` the same rounding of ``x - hi`` (exact in float32), so
    ``hi + lo = x`` within 2^-22 |x| (2^-137 where ``lo`` falls below the
    normal range).  The bit operations of the 3xTF32 kernels, on the host."""
    x = x.float().contiguous()

    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def pack_weight_tf32(weight: torch.Tensor, bn: int, sk: int,
                     mirror: bool = False) -> torch.Tensor:
    """(K, Cin, Cout) float32 -> the B images of the 3xTF32 conv kernel,
    (K, Cout / bn, Cin / sk, 2, sk / 8, bn, 8): for offset k, column split
    j, slice s of ``sk`` input channels and image h (0: hi, 1: lo of
    :func:`tf32_split`) one tile per k8 step of ``bn`` rows (output
    channels) x 8 input channels, K-major, 32 bytes a row, in the 32-byte
    swizzle: the 16-byte chunk c of row n lies at chunk position
    ``c ^ ((n >> 2) & 1)``.  The kernel copies a slice's images linearly.

    With ``mirror`` the images are those of :func:`mirrored` ``(weight)``.
    CPU tensors are packed with torch ops (the plain version); CUDA tensors
    by the pack kernel of csrc/subm_conv_tf32.cu."""
    if weight.is_cuda:
        _cuda.require(weight, "pack_weight_tf32 weight", torch.float32, 3)
        k, cin, cout = weight.shape
        if mirror:
            cin, cout = cout, cin
        return _pack_tf32_cuda(weight, cin, cout, bn, sk, k, mirror,
                               _cuda.stream_ptr(weight))
    w = mirrored(weight) if mirror else weight
    k, cin, cout = w.shape
    hi, lo = tf32_split(w)
    t = torch.stack([hi, lo]).view(2, k, cin // sk, sk // 8, 2, 4,
                                   cout // bn, bn)
    # -> (k, split, slice, image, k8 step, n, chunk, 4)
    t = t.permute(1, 6, 2, 0, 3, 7, 4, 5)
    swap = ((torch.arange(bn) >> 2) & 1).bool().view(bn, 1, 1)
    t = torch.where(swap, t.flip(-2), t)
    return t.reshape(k, cout // bn, cin // sk, 2, sk // 8, bn, 8).contiguous()


def _pack_tf32_cuda(weight, cin, cout, bn, sk, n_offsets, mirror, stream):
    """The tf32 pack kernel on a float32 CUDA weight; (cin, cout) are the
    conv's, i.e. swapped against ``weight``'s with ``mirror``."""
    if cin % sk or cout % bn or bn % TF32_K:
        raise ValueError(f"pack_weight_tf32: weight {tuple(weight.shape)}, "
                         f"bn {bn}, sk {sk}")
    packed = torch.empty((n_offsets, cout // bn, cin // sk, 2, sk // 8, bn,
                          8), dtype=torch.float32, device=weight.device)
    code = _cuda.library().tl_pack_weight_tf32(
        weight.data_ptr(), packed.data_ptr(), cin, cout, bn, sk, n_offsets,
        int(mirror), stream)
    _cuda.check(code, "tl_pack_weight_tf32")
    return packed


def _conv_cuda(feats, weight, rule, n_live, mirror=False):
    """The CUDA routes of :func:`subm_conv`; with ``mirror`` the conv with
    ``mirrored(weight)``."""
    _cuda.require(feats, "subm_conv feats", _DTYPES, 2)
    w = weight.to(feats.dtype).contiguous()
    _cuda.require(w, "subm_conv weight", _DTYPES, 3)
    _cuda.require(rule, "subm_conv rule", torch.int32, 2)
    k, cin, cout = w.shape
    if mirror:
        cin, cout = cout, cin
    if rule.shape[0] != k or cin != feats.shape[1]:
        raise ValueError(f"subm_conv: shapes feats {tuple(feats.shape)}, "
                         f"weight {tuple(w.shape)}, rule {tuple(rule.shape)}")
    v_out = rule.shape[1]
    n_live = v_out if n_live is None else int(n_live)
    if v_out == 0:
        return torch.empty((0, cout), dtype=feats.dtype, device=feats.device)
    if not mirror:
        _cuda.record("subm_conv", feats=feats, weight=w, rule=rule)
    pad_in = tensor_core_pad(cin, cout, v_out, feats.dtype, k)
    pad_out = cout_pad(cout, feats.dtype, k)
    if not (pad_in or pad_out):
        return _conv_launch(feats, w, rule, n_live, cout, mirror)
    # zero channels onto the tensor-core routes, the output cut back
    if mirror:
        w = mirrored(w)
    out = _conv_launch(F.pad(feats, (0, pad_in)),
                       F.pad(w, (0, pad_out, 0, pad_in)), rule, n_live,
                       cout + pad_out)
    return out[:, :cout].contiguous() if pad_out else out


def _conv_launch(feats, w, rule, n_live, cout, mirror=False):
    """Launch kernel 2 on checked inputs under the plan of their shape, or
    run the plain version where the plan is ``"plain"``."""
    k, cin = w.shape[0], feats.shape[1]
    v_out = rule.shape[1]
    plan = conv_plan(cin, cout, v_out, feats.dtype, k)
    if plan.route == "plain":
        return subm_conv_plain(feats, mirrored(w) if mirror else w, rule,
                               n_live)
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=feats.device)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(feats)
    if plan.route == "tf32x3":
        wpack = _pack_tf32_cuda(w, cin, cout, plan.bn, plan.bk, k, mirror,
                                stream)
        code = lib.tl_subm_conv_tf32(
            feats.data_ptr(), wpack.data_ptr(), rule.data_ptr(),
            out.data_ptr(), v_out, n_live, cin, cout, k, plan.bn, plan.bk,
            plan.stages, plan.smem_bytes, stream)
        _cuda.check(code, "tl_subm_conv_tf32")
        _cuda.LAUNCHES["subm_conv_tf32"] += 1
        return out
    wpack = _pack_cuda(w, cin, cout, plan.bn, k, mirror, stream)
    code = lib.tl_subm_conv_wgmma(
        feats.data_ptr(), wpack.data_ptr(), rule.data_ptr(), out.data_ptr(),
        v_out, n_live, cin, cout, k, plan.bm, plan.bn, plan.stages,
        plan.producers, plan.smem_bytes, stream)
    _cuda.check(code, "tl_subm_conv_wgmma")
    _cuda.LAUNCHES["subm_conv_wgmma"] += 1
    return out


def subm_conv(feats: torch.Tensor, weight: torch.Tensor, rule: torch.Tensor,
              n_live=None) -> torch.Tensor:
    """feats (V_in, Cin), weight (K, Cin, Cout), rule (K, V_out) int32 ->
    (V_out, Cout) in feats' dtype, float32 accumulation; rows at or past
    ``n_live`` (default V_out) are zero.  K = k^3 for kernel size k: 27 on
    every shipped config.

    Routing, by device, dtype and shape only (:func:`conv_plan`):

    * CPU tensors -> the plain version (ops/sparse.py:subm_conv);
    * CUDA, bf16, K <= 343 -> csrc/subm_conv_wgmma.cu (counted as
      ``subm_conv_wgmma``);
    * CUDA, float32, K <= 343 -> csrc/subm_conv_tf32.cu (counted as
      ``subm_conv_tf32``);
    * widths that are no multiple of 8 are zero-padded onto those routes
      first, the output cut back (:func:`tensor_core_pad`,
      :func:`cout_pad`: the 4 -> 32 input conv to 32 input channels in
      bf16, to 8 in float32);
    * CUDA, K > 343 -> the plain version on the card's tensors (not
      counted).

    A kernel that fails to build or launch raises; no route gives way to
    another.
    """
    if not feats.is_cuda:
        return subm_conv_plain(feats, weight, rule, n_live)
    return _conv_cuda(feats, weight, rule, n_live)


def subm_conv_dx(grad: torch.Tensor, weight: torch.Tensor,
                 rule: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`subm_conv`: grad (V, Cout) and the forward
    weight (K, Cin, Cout) -> (V, Cin), the conv of ``grad`` with
    :func:`mirrored` ``(weight)`` over the same rule, routed as
    :func:`subm_conv` routes a conv of that shape.  On the tensor-core
    routes the mirrored tiles are packed straight from ``weight``."""
    if not grad.is_cuda:
        return subm_conv_plain(grad, mirrored(weight), rule)
    return _conv_cuda(grad, weight, rule, None, mirror=True)


DW_PARTIAL_BYTES = 64 << 20   # cap on kernel 3's per-chunk partials
DW_WGMMA_BLOCKS = 528         # blocks in flight the dW plans aim for: 4 an SM
DW_WGMMA_MIN_ROWS = 256       # fewer rows than this are not worth a chunk
DW_WGMMA_STAGES = 4           # ring depth
DW_WGMMA_PRODUCERS = 128      # producer threads; a ring slot holds a quarter
                              # as many rows


class DwPlan(NamedTuple):
    """What the launcher of kernel 3 uses for one shape."""

    route: str           # "wgmma", "tf32x3" or "plain" (one chunk)
    bn: int              # output channels per block
    n_splits: int        # blocks along Cout (n_splits * bn >= cout)
    producers: int       # wgmma: producer threads, 4 per row of a ring slot
    stages: int          # wgmma: ring depth
    n_chunks: int        # row chunks, one partial each
    rows_per_chunk: int  # n_chunks * rows_per_chunk >= v
    smem_bytes: int      # wgmma: dynamic shared memory per block


def dw_smem_bytes(bn: int, producers: int, stages: int) -> int:
    """Dynamic shared memory of a wgmma dW block: alignment slack, the ring
    of (2 + bn / 32) slabs of producers / 4 rows x 64 bytes, the mbarriers
    and the producer warps' flags."""
    return 1024 + stages * (2 + bn // 32) * (producers // 4) * 64 + 128 + 256


def dw_plan_wgmma(cin: int, cout: int, v: int,
                  producers: int = DW_WGMMA_PRODUCERS,
                  stages: int = DW_WGMMA_STAGES,
                  target_blocks: int = DW_WGMMA_BLOCKS,
                  n_offsets: int = N_OFFSETS) -> DwPlan:
    """The tensor-core plan of a (cin, cout, v) weight gradient under
    explicit tunables (tools/conv_tune.py sweeps them; :func:`dw_plan` uses
    the defaults).  A block sums 64 rows of dW's flattened (offset, input
    channel) axis, ``n_offsets * cin`` long (two 32-row slabs), against
    ``bn`` output channels over one row chunk; ``bn`` is a multiple of 32
    (Cout in multiples of 32 split as the conv splits it; another Cout in
    the fewest 256-or-narrower blocks, the last reaching past Cout, its
    extra columns zero and not written).  Chunks are cut so that about
    ``target_blocks`` blocks run, none shorter than ``DW_WGMMA_MIN_ROWS``
    rows and the partials under ``DW_PARTIAL_BYTES``, and hold whole ring
    slots.

    The defaults are what ``tools/conv_tune.py --only dw`` measured on the
    H100 at the training shapes: 4 producer warps (32-row slots) beat 8 at
    every level with more than one chunk, 4 ring slots beat 2 by 10-30 % and
    8 bring nothing more, and four blocks an SM is within 10 % of the best
    block target at every shape (the decoder's 2C -> C convs would take
    twice as many, 96 -> 96 and 192 -> 96 half)."""
    if cout % 32 == 0:
        bn = bf16_bn(cout)
        n = cout // bn
    else:
        n = -(-cout // MAX_BN)
        bn = -(-cout // (32 * n)) * 32
    rows = producers // 4
    while stages > 2 and dw_smem_bytes(bn, producers, stages) > SMEM_LIMIT:
        stages -= 1
    n_chunks, rows_per_chunk = _cut_chunks(
        v, -(-(n_offsets * cin) // 64) * n, n_offsets * cin * cout, rows,
        target_blocks)
    return DwPlan("wgmma", bn, n, producers, stages, n_chunks,
                  rows_per_chunk, dw_smem_bytes(bn, producers, stages))


def _cut_chunks(v: int, per_chunk: int, dw_size: int, rows: int,
                target_blocks: int = DW_WGMMA_BLOCKS):
    """(n_chunks, rows_per_chunk) of a tensor-core dW plan whose grid has
    ``per_chunk`` blocks a chunk: about ``target_blocks`` blocks, no chunk
    shorter than ``DW_WGMMA_MIN_ROWS`` rows, the partials (``dw_size``
    float32 a chunk) under ``DW_PARTIAL_BYTES``, chunks of whole ring slots
    of ``rows`` rows."""
    by_mem = max(1, DW_PARTIAL_BYTES // (dw_size * 4))
    want = max(1, min(-(-target_blocks // per_chunk),
                      v // DW_WGMMA_MIN_ROWS, by_mem))
    rows_per_chunk = -(-(-(-max(v, 1) // want)) // rows) * rows
    return -(-max(v, 1) // rows_per_chunk), rows_per_chunk


DW_TF32_ROWS = 32      # rows of a ring slot of the 3xTF32 dW kernel


def dw_smem_bytes_tf32(bn: int, stages: int) -> int:
    """Dynamic shared memory of a 3xTF32 dW block: alignment slack, the hi
    and lo images of a slot's g rows (2 x ``bn`` x ``DW_TF32_ROWS``
    float32), the ring of x slabs (``DW_TF32_ROWS`` x 64 float32) and g rows
    (``DW_TF32_ROWS`` x ``bn``), the mbarriers."""
    rows = DW_TF32_ROWS
    return 1024 + 2 * rows * bn * 4 + stages * rows * (64 + bn) * 4 + 128


def dw_plan_tf32(cin: int, cout: int, v: int,
                 n_offsets: int = N_OFFSETS) -> DwPlan:
    """The 3xTF32 plan of a float32 weight gradient (``cin``, ``cout``
    multiples of 8).  A block sums 64 rows of dW's flattened (offset,
    input channel) axis (8 groups of 8 channels) against :func:`tf32_bn`
    output channels over one row chunk; chunks are cut as for the bf16
    route (:func:`_cut_chunks`), in whole ring slots of ``DW_TF32_ROWS``
    rows."""
    bn = tf32_bn(cout)
    stages = TF32_STAGES
    while stages > 2 and dw_smem_bytes_tf32(bn, stages) > SMEM_LIMIT:
        stages -= 1
    n = cout // bn
    n_chunks, rows_per_chunk = _cut_chunks(
        v, -(-(n_offsets * cin) // 64) * n, n_offsets * cin * cout,
        DW_TF32_ROWS)
    return DwPlan("tf32x3", bn, n, 128, stages, n_chunks, rows_per_chunk,
                  dw_smem_bytes_tf32(bn, stages))


@functools.lru_cache(maxsize=None)
def dw_plan(cin: int, cout: int, v: int,
            dtype: torch.dtype = torch.bfloat16,
            n_offsets: int = N_OFFSETS) -> DwPlan:
    """Static routing and tiling of kernel 3, from the shape alone.

    ``cin`` and ``cout`` multiples of 8, any offset count: bf16 -> the
    wgmma kernel (csrc/subm_conv_dw_wgmma.cu, :func:`dw_plan_wgmma`),
    float32 -> the 3xTF32 kernel (csrc/subm_conv_dw_tf32.cu,
    :func:`dw_plan_tf32`).  Other widths are ``"plain"``, the plain
    version: the wrapper zero-pads them first, as it does for the conv, so
    only K > 343 keeps one."""
    if (cin <= 0 or cout <= 0 or cin % TF32_K or cout % TF32_K
            or dtype not in _DTYPES):
        return DwPlan("plain", 0, 0, 0, 0, 1, max(v, 1), 0)
    if dtype == torch.float32:
        return dw_plan_tf32(cin, cout, v, n_offsets)
    return dw_plan_wgmma(cin, cout, v, n_offsets=n_offsets)


def _dw_cuda(x, g, rule):
    """The CUDA routes of :func:`subm_conv_dw`."""
    _cuda.require(x, "subm_conv_dw x", _DTYPES, 2)
    _cuda.require(g, "subm_conv_dw g", x.dtype, 2)
    _cuda.require(rule, "subm_conv_dw rule", torch.int32, 2)
    v, cin = x.shape
    cout = g.shape[1]
    k = rule.shape[0]
    if rule.shape != (k, v) or g.shape[0] != v:
        raise ValueError(f"subm_conv_dw: shapes x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)}, rule {tuple(rule.shape)}")
    if v == 0:
        return torch.zeros((k, cin, cout), dtype=torch.float32,
                           device=x.device)
    _cuda.record("subm_conv_dw", x=x, g=g, rule=rule)
    pad_in = tensor_core_pad(cin, cout, v, x.dtype, k)
    pad_out = cout_pad(cout, x.dtype, k)
    if pad_in or pad_out:
        # dW of the padded conv; its first cin x cout entries are the answer
        return _dw_launch(F.pad(x, (0, pad_in)), F.pad(g, (0, pad_out)),
                          rule, dw_plan(cin + pad_in, cout + pad_out, v,
                                        x.dtype, k))[:, :cin, :cout
                                                     ].contiguous()
    return _dw_launch(x, g, rule, dw_plan(cin, cout, v, x.dtype, k))


def _dw_launch(x, g, rule, plan):
    """Launch kernel 3 on checked inputs under ``plan``, or run the plain
    version where the plan is ``"plain"``."""
    if plan.route == "plain":
        return subm_conv_dw_plain(x, g, rule)
    v, cin = x.shape
    cout = g.shape[1]
    k = rule.shape[0]
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(x)
    # one chunk writes dW itself: no partials
    partial = dw if plan.n_chunks == 1 else torch.empty(
        (plan.n_chunks, k, cin, cout), dtype=torch.float32, device=x.device)
    if plan.route == "tf32x3":
        code = lib.tl_subm_conv_dw_tf32(
            x.data_ptr(), g.data_ptr(), rule.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), v, cin, cout, k, plan.bn, plan.stages,
            plan.n_chunks, plan.rows_per_chunk, plan.smem_bytes, stream)
        _cuda.check(code, "tl_subm_conv_dw_tf32")
        _cuda.LAUNCHES["subm_conv_dw_tf32"] += 1
        return dw
    code = lib.tl_subm_conv_dw_wgmma(
        x.data_ptr(), g.data_ptr(), rule.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), v, cin, cout, k, plan.bn, plan.producers, plan.stages,
        plan.n_chunks, plan.rows_per_chunk, plan.smem_bytes, stream)
    _cuda.check(code, "tl_subm_conv_dw_wgmma")
    _cuda.LAUNCHES["subm_conv_dw_wgmma"] += 1
    return dw


def subm_conv_dw(x: torch.Tensor, g: torch.Tensor,
                 rule: torch.Tensor) -> torch.Tensor:
    """x (V, Cin), g (V, Cout) in one working type, rule (K, V) int32 ->
    (K, Cin, Cout) float32 weight gradient (K = 27 at kernel size 3).

    Routing, by device, dtype and shape only (:func:`dw_plan`):

    * CPU tensors -> the plain version (ops/sparse.py:subm_conv_dw);
    * CUDA, bf16 -> csrc/subm_conv_dw_wgmma.cu (counted as
      ``subm_conv_dw_wgmma``);
    * CUDA, float32 -> csrc/subm_conv_dw_tf32.cu (counted as
      ``subm_conv_dw_tf32``);
    * widths that are no multiple of 8 are zero-padded onto those routes
      first (x and g get zero columns, dW is cut back: the 4 -> 32 input
      conv's x to 32 channels in bf16, to 8 in float32);
    * CUDA, a width that is no multiple of 8 at K > 343 -> the plain
      version on the card's tensors (not counted).

    A kernel that fails to build or launch raises; no route gives way to
    another."""
    if not x.is_cuda:
        return subm_conv_dw_plain(x, g, rule)
    return _dw_cuda(x, g, rule)


def dw_chunked_plain(x: torch.Tensor, g: torch.Tensor, rule: torch.Tensor,
                     plan: DwPlan) -> torch.Tensor:
    """The two-pass sum of the dW kernels in PyTorch: the plain weight
    gradient of each row chunk of ``plan``, the chunks added in order."""
    dw = torch.zeros((rule.shape[0], x.shape[1], g.shape[1]),
                     dtype=torch.float32, device=x.device)
    for c in range(plan.n_chunks):
        lo = c * plan.rows_per_chunk
        hi = min(x.shape[0], lo + plan.rows_per_chunk)
        if hi > lo:
            dw += subm_conv_dw_plain(x, g[lo:hi], rule[:, lo:hi])
    return dw


def subm_conv_tf32x3_plain(feats: torch.Tensor, weight: torch.Tensor,
                           rule: torch.Tensor, n_live=None) -> torch.Tensor:
    """The arithmetic of csrc/subm_conv_tf32.cu in PyTorch: float32 feats
    and weights split into hi and lo (:func:`tf32_split`), each offset's
    product taken as lo(x) hi(W) + hi(x) lo(W) + hi(x) hi(W) (products of
    TF32 values are exact in float32), all sums in float32.  The twin the
    CPU tests hold the kernel's numerics with; no path runs it."""
    v_out, cout = rule.shape[1], weight.shape[2]
    xh, xl = tf32_split(feats)
    wh, wl = tf32_split(weight)
    acc = torch.zeros((v_out, cout), dtype=torch.float32, device=feats.device)
    for k in range(rule.shape[0]):
        idx = rule[k].long()
        rows = torch.nonzero(idx >= 0).squeeze(1)
        if rows.numel():
            ah, al = xh[idx[rows]], xl[idx[rows]]
            part = al @ wh[k]
            part = part + ah @ wl[k]
            part = part + ah @ wh[k]
            acc.index_add_(0, rows, part)
    if n_live is not None and n_live < v_out:
        acc[n_live:] = 0
    return acc


def subm_conv_dw_tf32x3_plain(x: torch.Tensor, g: torch.Tensor,
                              rule: torch.Tensor) -> torch.Tensor:
    """The arithmetic of csrc/subm_conv_dw_tf32.cu in PyTorch: both x and g
    split into hi and lo, ``dW[k] = lo(X_k)^T hi(G) + hi(X_k)^T lo(G) +
    hi(X_k)^T hi(G)``, float32 sums.  For the CPU tests only."""
    k_off, cin, cout = rule.shape[0], x.shape[1], g.shape[1]
    xh, xl = tf32_split(x)
    gh, gl = tf32_split(g)
    dw = torch.zeros((k_off, cin, cout), dtype=torch.float32, device=x.device)
    for k in range(k_off):
        idx = rule[k].long()
        rows = torch.nonzero(idx >= 0).squeeze(1)
        if rows.numel():
            ah, al = xh[idx[rows]].t(), xl[idx[rows]].t()
            part = al @ gh[rows]
            part = part + ah @ gl[rows]
            dw[k] = part + ah @ gh[rows]
    return dw


def mirrored(weight: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> (K, Cout, Cin): the weights whose conv over the
    same submanifold rule is the transpose of ``weight``'s (``flip(0)``
    mirrors the offsets of any odd kernel size)."""
    return weight.flip(0).transpose(1, 2).contiguous()


class SubmConvFn(torch.autograd.Function):
    """Differentiable submanifold conv.  ``weight`` is the float32 master
    copy; it is cast to the working type of ``feats`` inside, and its
    gradient comes back in float32."""

    @staticmethod
    def forward(ctx, feats, weight, rule):
        w = weight.to(feats.dtype)
        ctx.save_for_backward(feats, w, rule)
        return subm_conv(feats, w, rule)

    @staticmethod
    def backward(ctx, grad):
        feats, w, rule = ctx.saved_tensors
        grad = grad.to(feats.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            _cuda.record("subm_conv_dx", g=grad, weight=w, rule=rule)
            dx = subm_conv_dx(grad, w, rule)
        if ctx.needs_input_grad[1]:
            dw = subm_conv_dw(feats, grad, rule)
        return dx, dw, None
