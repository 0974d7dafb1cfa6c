"""Submanifold sparse conv — kernel 2 of the port (the hottest one) — its
weight gradient — kernel 3 — and the autograd function over both.

Replaces the Pallas kernel ``subm_conv_banded`` (``_subm_kernel`` +
``_gather_bands``, treelearn_tpu/ops/pallas_conv.py:355,304,181).  The TPU
kernel reaches its neighbors through banded DMA windows of the sorted
features and one-hot MXU selects, with a span-overflow fallback; a GPU
gathers rows cheaply, so both CUDA kernels are plain gather-GEMMs over the
(27, V) rule from ops/rulebook.py, output-stationary with float32 sums in
registers.  No windows, so nothing can overflow.

* csrc/subm_conv_wgmma.cu, the bf16 route: a block owns 64 or 128 output
  voxels x up to 256 output channels and multiplies on the tensor cores
  (``wgmma``), gathered rows and packed weight tiles arriving through a
  ``cp.async`` ring (:func:`conv_plan`, :func:`pack_weight`).
* csrc/subm_conv.cu, the float32 / odd-width route: 64 voxels x 64 channels
  per block on the float32 SIMT units.
* A bf16 conv with fewer than 32 input channels (the 4 -> 32 input conv)
  is zero-padded to 32 and takes the bf16 route, as is its weight gradient,
  wherever that is faster with the pad counted (:func:`tensor_core_pad`).
* A conv of another kernel size than 3 (K = k^3 offsets, any odd k, as the
  JAX package's rulebook conv takes) goes to the SIMT kernel in both
  dtypes, as does its weight gradient: the tensor-core sources are built
  for ``N_OFFSETS`` = 27 (their ring and rule tiles are sized by it).

Kernel 3 replaces ``rule_conv_dw_banded`` (``_dw_kernel``,
pallas_conv.py:438,415): both routes sum per-chunk partial weight gradients
and add the chunks in order in a second pass, so dW is deterministic (see
the sources for why not atomics).

* csrc/subm_conv_dw_wgmma.cu, the bf16 route: ``dW[k] = X_k^T G`` on the
  tensor cores with the voxel rows as the reduction dimension, both
  operands MN-major straight from row-major rows in shared memory
  (:func:`dw_plan`).
* csrc/subm_conv_dw.cu, the float32 / odd-width route: 64 x 64 channel
  tiles on the float32 SIMT units.

:class:`SubmConvFn` is the counterpart of ``rule_conv_ad``
(pallas_conv.py:588-649): forward kernel 2; backward dx = kernel 2 on the
output gradient with weights ``W.flip(0).transpose(1, 2)`` over the same
rule (a submanifold rule is its own transpose under offset mirroring, and
``kernel_offsets`` is ordered so that ``flip(0)`` mirrors); dW = kernel 3.

Bound on the card: operations by the count (2 x Cin x Cout FLOPs per rule
entry, against Cin + Cout values moved per voxel), but at 32..224 channels
the tensor cores finish that in microseconds, and what the bf16 route pays
for is the gather of feature rows through L2 (levels 0-1) and the length of
one block's K loop (the deepest levels).  The weight gradient is bound the
same way: its products take microseconds on the tensor cores, a launch pays
for the 16-byte copies of the gathered rows and of g (once per offset and
input slice) and, below a few thousand rows, for the launch and the Python
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
PAD_MIN_V = 32768     # from here on a narrow bf16 input is padded to BK
N_OFFSETS = 27        # offsets of a kernel_size 3 conv: the only count the
                      # tensor-core kernels take


class ConvPlan(NamedTuple):
    """What the launcher of kernel 2 uses for one shape."""

    route: str        # "wgmma" or "simt"
    bm: int           # output voxels per block
    bn: int           # output channels per block
    n_splits: int     # blocks along Cout (n_splits * bn == cout)
    bk: int           # input channels per K step
    stages: int       # ring depth
    producers: int    # threads of a block that start the copies
    smem_bytes: int   # dynamic shared memory per block


def plan_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of a wgmma block: alignment slack, the ring of
    A and B tiles, the mbarriers, the block's 27 x bm rule entries and its
    offset lists."""
    return 1024 + stages * (bm + bn) * BK * 2 + 128 + 27 * bm * 4 + 256


def conv_plan(cin: int, cout: int, v: int,
              dtype: torch.dtype = torch.bfloat16,
              n_offsets: int = N_OFFSETS) -> ConvPlan:
    """Static routing and tiling of kernel 2, from the shape alone.

    bf16 with ``cin`` and ``cout`` multiples of 32 and 27 offsets -> the
    wgmma kernel; float32, the 4 -> 32 input conv, other odd widths and
    kernel sizes other than 3 (``n_offsets`` != 27) -> the SIMT kernel.

    The wgmma kernel gives a block 64 output voxels (one consumer warpgroup
    beside the producer warpgroup) and the whole Cout, or the largest even
    share of it that fits the widest instruction (256; 384 -> 2 x 192), so
    each gathered row is read once or twice.  Three measured rules (H100,
    the shapes of chip_smoke.py's paths): with fewer than ``SMALL_V_TILES``
    row tiles most of the card would idle, so small levels split Cout into
    32-channel blocks; a 32-channel conv over ``WIDE_ROWS_V`` voxels or
    more, where a block's fixed costs outweigh its products, takes 128
    voxels a block; and a grid of at most ``ONE_WAVE_BLOCKS`` blocks, whose
    length is one block's K loop, gives each block 8 producer warps instead
    of 4 (larger grids lose more by the lower occupancy than they gain).
    """
    if (dtype != torch.bfloat16 or n_offsets != N_OFFSETS or cin == 0
            or cout == 0 or cin % BK or cout % 32):
        return ConvPlan("simt", 64, 64, -(-cout // 64), 32, 1, 0, 0)
    n = 1
    while cout % n or (cout // n) % 32 or cout // n > MAX_BN:
        n += 1
    bm, bn = 64, cout // n
    if -(-v // 64) < SMALL_V_TILES:
        bn = 32
    elif bn == 32 and v >= WIDE_ROWS_V:
        bm = 128
    stages = 4
    blocks = -(-v // bm) * (cout // bn)
    producers = 256 if blocks <= ONE_WAVE_BLOCKS else 128
    return ConvPlan("wgmma", bm, bn, cout // bn, BK, stages, producers,
                    plan_smem_bytes(bm, bn, stages))


def tensor_core_pad(cin: int, cout: int, v: int, dtype: torch.dtype,
                    n_offsets: int = N_OFFSETS) -> int:
    """Zero input channels to append so that a bf16 conv narrower than one K
    step (the 4 -> 32 input conv), or its weight gradient, takes the
    tensor-core route: ``32 - cin``, or 0 where the shape stays on the SIMT
    kernels.  Zeros add exactly, so the result differs from the unpadded
    conv's by the order of its float32 sums only.  Below ``PAD_MIN_V`` rows
    both routes cost a launch and the pad is two more: measured on the H100
    by chip_smoke.py (a clear gain from 65,536 rows up, a draw at 16,384, a
    loss below; see PERF.md).  Other kernel sizes than 3 stay on the SIMT
    kernels unpadded."""
    if (dtype != torch.bfloat16 or n_offsets != N_OFFSETS
            or not 0 < cin < BK or cout == 0 or cout % 32 or v < PAD_MIN_V):
        return 0
    return BK - cin


@functools.lru_cache(maxsize=None)
def _pack_index(cin: int, cout: int, bn: int) -> torch.Tensor:
    """For every 16-byte chunk of the packed image, the chunk of the
    (27, cout, cin) transposed weight it holds (see :func:`pack_weight`)."""
    n_splits, n_slices = cout // bn, cin // BK
    k = torch.arange(27).view(27, 1, 1, 1, 1)
    j = torch.arange(n_splits).view(1, n_splits, 1, 1, 1)
    s = torch.arange(n_slices).view(1, 1, n_slices, 1, 1)
    n = torch.arange(bn).view(1, 1, 1, bn, 1)
    p = torch.arange(4).view(1, 1, 1, 1, 4)
    chunk = p ^ ((n >> 1) & 3)
    idx = ((k * cout + j * bn + n) * (cin // 8) + s * 4 + chunk)
    return idx.reshape(-1)


def pack_weight(weight: torch.Tensor, bn: int,
                mirror: bool = False) -> torch.Tensor:
    """(27, Cin, Cout) -> the shared-memory images of the wgmma kernel's B
    tiles, (27, Cout / bn, Cin / 32, bn, 32): for offset k, column split j
    and K slice s one tile of ``bn`` rows (output channels) x 32 input
    channels, K-major, 64 bytes a row, in the 64-byte swizzle: the 16-byte
    chunk c of row n lies at chunk position ``c ^ ((n >> 1) & 3)``.  The
    conv kernel copies a tile linearly into shared memory.

    With ``mirror`` the images are those of :func:`mirrored` ``(weight)``,
    the weights of the conv's input gradient, read straight from ``weight``.
    CPU tensors are packed with torch ops (the plain version); CUDA tensors
    by the pack kernel of csrc/subm_conv_wgmma.cu (bf16 only)."""
    if not weight.is_cuda:
        w = mirrored(weight) if mirror else weight
        k, cin, cout = w.shape
        t = w.transpose(1, 2).contiguous().view(-1, 8)
        return t[_pack_index(cin, cout, bn)].view(
            k, cout // bn, cin // BK, bn, BK)
    _cuda.require(weight, "pack_weight weight", torch.bfloat16, 3)
    k, cin, cout = weight.shape
    if mirror:
        cin, cout = cout, cin
    if k != 27 or cin % BK or cout % bn:
        raise ValueError(f"pack_weight: weight {tuple(weight.shape)}, bn {bn}")
    return _pack_cuda(weight, cin, cout, bn, mirror,
                      _cuda.stream_ptr(weight))


def _pack_cuda(weight, cin, cout, bn, mirror, stream):
    """The pack kernel on a checked bf16 CUDA weight; (cin, cout) are the
    conv's, i.e. swapped against ``weight``'s with ``mirror``."""
    packed = torch.empty((27, cout // bn, cin // BK, bn, BK),
                         dtype=weight.dtype, device=weight.device)
    code = _cuda.library().tl_pack_weight(
        weight.data_ptr(), packed.data_ptr(), cin, cout, bn, int(mirror),
        stream)
    _cuda.check(code, "tl_pack_weight")
    return packed


def _conv_cuda(feats, weight, rule, n_live, force_simt=False, mirror=False):
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
    v_in, v_out = feats.shape[0], rule.shape[1]
    n_live = v_out if n_live is None else int(n_live)
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=feats.device)
    if v_out == 0:
        return out
    if not (force_simt or mirror):
        _cuda.record("subm_conv", feats=feats, weight=w, rule=rule)
        pad = tensor_core_pad(cin, cout, v_out, feats.dtype, k)
        if pad:
            feats = F.pad(feats, (0, pad))
            w = F.pad(w, (0, 0, 0, pad))
            cin += pad
    plan = conv_plan(cin, cout, v_out, feats.dtype, k)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(feats)
    if plan.route == "simt" or force_simt:
        if mirror:
            w = mirrored(w)
        fn = (lib.tl_subm_conv_f32 if feats.dtype == torch.float32
              else lib.tl_subm_conv_bf16)
        code = fn(feats.data_ptr(), w.data_ptr(), rule.data_ptr(),
                  out.data_ptr(), v_in, v_out, n_live, cin, cout, k, stream)
        _cuda.check(code, "tl_subm_conv")
        _cuda.LAUNCHES["subm_conv"] += 1
        return out
    wpack = _pack_cuda(w, cin, cout, plan.bn, mirror, stream)
    code = lib.tl_subm_conv_wgmma(
        feats.data_ptr(), wpack.data_ptr(), rule.data_ptr(), out.data_ptr(),
        v_out, n_live, cin, cout, plan.bm, plan.bn, plan.stages,
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

    Routing, by device and shape only (:func:`conv_plan`):

    * CPU tensors -> the plain version (ops/sparse.py:subm_conv);
    * CUDA, bf16, Cin and Cout multiples of 32 -> csrc/subm_conv_wgmma.cu
      (counted as ``subm_conv_wgmma``); so is the 4 -> 32 input conv over
      ``PAD_MIN_V`` voxels or more, zero-padded to 32 input channels
      (:func:`tensor_core_pad`);
    * CUDA, float32, any other width, or K != 27 -> csrc/subm_conv.cu
      (counted as ``subm_conv``).

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
    :func:`subm_conv` routes a conv of that shape.  On the tensor-core route
    the mirrored tiles are packed straight from ``weight``."""
    if not grad.is_cuda:
        return subm_conv_plain(grad, mirrored(weight), rule)
    return _conv_cuda(grad, weight, rule, None, mirror=True)


def subm_conv_simt(feats: torch.Tensor, weight: torch.Tensor,
                   rule: torch.Tensor, n_live=None,
                   mirror: bool = False) -> torch.Tensor:
    """:func:`subm_conv` (with ``mirror``: :func:`subm_conv_dx`) through
    csrc/subm_conv.cu whatever the shape: the yardstick the bf16 route is
    timed against on the card (chip_smoke.py, the card tests).  Nothing in
    the package calls it."""
    return _conv_cuda(feats, weight, rule, n_live, force_simt=True,
                      mirror=mirror)


DW_PARTIAL_BYTES = 64 << 20   # cap on kernel 3's per-chunk partials
DW_TARGET_BLOCKS = 2048       # blocks in flight the SIMT dW kernel aims for
DW_WGMMA_BLOCKS = 528         # the same for the tensor-core route: 4 an SM
DW_WGMMA_MIN_ROWS = 256       # fewer rows than this are not worth a chunk
DW_WGMMA_STAGES = 4           # ring depth
DW_WGMMA_PRODUCERS = 128      # producer threads; a ring slot holds a quarter
                              # as many rows


class DwPlan(NamedTuple):
    """What the launcher of kernel 3 uses for one shape."""

    route: str           # "wgmma" or "simt"
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


def dw_chunks(v: int, cin: int, cout: int, n_offsets: int = N_OFFSETS) -> int:
    """Row chunks of the SIMT dW kernel: enough blocks to fill the card, at
    least 256 rows a chunk, partials under ``DW_PARTIAL_BYTES``."""
    tiles = -(-cin // 64) * -(-cout // 64)
    want = -(-DW_TARGET_BLOCKS // (n_offsets * tiles))
    by_mem = max(1, DW_PARTIAL_BYTES // (n_offsets * cin * cout * 4))
    return max(1, min(want, -(-v // 256), by_mem))


def _dw_plan_simt(cin: int, cout: int, v: int,
                  n_offsets: int = N_OFFSETS) -> DwPlan:
    n = dw_chunks(v, cin, cout, n_offsets)
    return DwPlan("simt", 64, -(-cout // 64), 0, 1, n, -(-max(v, 1) // n), 0)


def dw_plan_wgmma(cin: int, cout: int, v: int,
                  producers: int = DW_WGMMA_PRODUCERS,
                  stages: int = DW_WGMMA_STAGES,
                  target_blocks: int = DW_WGMMA_BLOCKS) -> DwPlan:
    """The tensor-core plan of a (cin, cout, v) weight gradient under
    explicit tunables (tools/conv_tune.py sweeps them; :func:`dw_plan` uses
    the defaults).  A block sums two 32-channel slabs of the 27 * cin / 32
    (offset, input slice) slabs against ``bn`` output channels over one row
    chunk; chunks are cut so that about ``target_blocks`` blocks run, none
    shorter than ``DW_WGMMA_MIN_ROWS`` rows and the partials under
    ``DW_PARTIAL_BYTES``, and hold whole ring slots.

    The defaults are what ``tools/conv_tune.py --only dw`` measured on the
    H100 at the training shapes: 4 producer warps (32-row slots) beat 8 at
    every level with more than one chunk, 4 ring slots beat 2 by 10-30 % and
    8 bring nothing more, and four blocks an SM is within 10 % of the best
    block target at every shape (the decoder's 2C -> C convs would take
    twice as many, 96 -> 96 and 192 -> 96 half)."""
    n = 1
    while cout % n or (cout // n) % 32 or cout // n > MAX_BN:
        n += 1
    bn = cout // n
    rows = producers // 4
    while stages > 2 and dw_smem_bytes(bn, producers, stages) > SMEM_LIMIT:
        stages -= 1
    per_chunk = -(-(27 * (cin // 32)) // 2) * n
    by_mem = max(1, DW_PARTIAL_BYTES // (27 * cin * cout * 4))
    want = max(1, min(-(-target_blocks // per_chunk),
                      v // DW_WGMMA_MIN_ROWS, by_mem))
    rows_per_chunk = -(-(-(-max(v, 1) // want)) // rows) * rows
    n_chunks = -(-max(v, 1) // rows_per_chunk)
    return DwPlan("wgmma", bn, n, producers, stages, n_chunks,
                  rows_per_chunk, dw_smem_bytes(bn, producers, stages))


@functools.lru_cache(maxsize=None)
def dw_plan(cin: int, cout: int, v: int,
            dtype: torch.dtype = torch.bfloat16,
            n_offsets: int = N_OFFSETS) -> DwPlan:
    """Static routing and tiling of kernel 3, from the shape alone.

    bf16 with ``cin`` and ``cout`` multiples of 32 and 27 offsets -> the
    wgmma kernel (csrc/subm_conv_dw_wgmma.cu); float32, the 4 -> 32 input
    conv, other odd widths and kernel sizes other than 3 -> the SIMT kernel
    (csrc/subm_conv_dw.cu)."""
    if (dtype != torch.bfloat16 or n_offsets != N_OFFSETS or cin == 0
            or cout == 0 or cin % 32 or cout % 32):
        return _dw_plan_simt(cin, cout, v, n_offsets)
    return dw_plan_wgmma(cin, cout, v)


def _dw_cuda(x, g, rule, force_simt=False):
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
    if not force_simt:
        _cuda.record("subm_conv_dw", x=x, g=g, rule=rule)
        pad = tensor_core_pad(cin, cout, v, x.dtype, k)
        if pad:    # dW of the padded conv; its first cin rows are the answer
            return _dw_launch(F.pad(x, (0, pad)), g, rule, dw_plan(
                cin + pad, cout, v, x.dtype))[:, :cin].contiguous()
    return _dw_launch(x, g, rule, _dw_plan_simt(cin, cout, v, k) if force_simt
                      else dw_plan(cin, cout, v, x.dtype, k))


def _dw_launch(x, g, rule, plan):
    """Launch kernel 3 on checked inputs under ``plan``."""
    v, cin = x.shape
    cout = g.shape[1]
    k = rule.shape[0]
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(x)
    if plan.route == "simt":
        partial = torch.empty((plan.n_chunks, k, cin, cout),
                              dtype=torch.float32, device=x.device)
        fn = (lib.tl_subm_conv_dw_f32 if x.dtype == torch.float32
              else lib.tl_subm_conv_dw_bf16)
        code = fn(x.data_ptr(), g.data_ptr(), rule.data_ptr(),
                  partial.data_ptr(), dw.data_ptr(), v, cin, cout, k,
                  plan.n_chunks, stream)
        _cuda.check(code, "tl_subm_conv_dw")
        _cuda.LAUNCHES["subm_conv_dw"] += 1
        return dw
    # one chunk writes dW itself: no partials
    partial = dw if plan.n_chunks == 1 else torch.empty(
        (plan.n_chunks, k, cin, cout), dtype=torch.float32, device=x.device)
    code = lib.tl_subm_conv_dw_wgmma(
        x.data_ptr(), g.data_ptr(), rule.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), v, cin, cout, plan.bn, plan.producers, plan.stages,
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
    * CUDA, bf16, Cin and Cout multiples of 32 ->
      csrc/subm_conv_dw_wgmma.cu (counted as ``subm_conv_dw_wgmma``); so is
      the 4 -> 32 input conv's over ``PAD_MIN_V`` rows or more, x zero-padded
      to 32 channels and dW cut back to its 4 rows
      (:func:`tensor_core_pad`);
    * CUDA, float32, any other width, or K != 27 -> csrc/subm_conv_dw.cu
      (counted as ``subm_conv_dw``).

    A kernel that fails to build or launch raises; no route gives way to
    another."""
    if not x.is_cuda:
        return subm_conv_dw_plain(x, g, rule)
    return _dw_cuda(x, g, rule)


def subm_conv_dw_simt(x: torch.Tensor, g: torch.Tensor,
                      rule: torch.Tensor) -> torch.Tensor:
    """:func:`subm_conv_dw` through csrc/subm_conv_dw.cu whatever the shape:
    the yardstick the bf16 route is timed against on the card
    (chip_smoke.py, the card tests).  Nothing in the package calls it."""
    return _dw_cuda(x, g, rule, force_simt=True)


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
