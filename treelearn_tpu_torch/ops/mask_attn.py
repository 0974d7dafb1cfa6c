"""Masked cross-attention of SPFormer's query decoder (``csrc/mask_attn.cu``).

The attention mask of a decoder layer is the previous prediction's mask
logits ``P`` (Q, K), closed where ``P < 0`` (``sigmoid(P) < 0.5``), every
row with no open key opened whole (``model/spformer.py:closed_mask``).
:func:`mask_pack` packs it once a prediction into :class:`MaskBits`: one
bit a (query, key) pair, 1 = open, each row ``words_of(K)`` int32 words
(bit ``k % 32`` of word ``k // 32`` is key ``k``; the bits past K are 0);
which rows had no open key (and were opened); one byte a (64-query, 64-key)
tile, 1 where the tile has an open pair; and ``stats`` (3,) int64 on the
device: the open pairs, the tiles with none, the tiles.

:func:`mask_attention` is ``softmax(scale q k^T | open) v`` per head of
width 32, for the batch's elements at once: ``q`` (B, Q, D) bf16 (each
element's queries), ``kv`` (V, 2 D) bf16 (the key/value projection of every
element's keys, keys in the first D columns), element b's keys the rows
``ranges[b]`` and its mask ``masks[b]``.  On a card it launches the kernels
(forward and, as its backward, dq / dk / dv) or raises; the CPU has
:func:`mask_attention_plain`, the same function in float32 from the bits.
The layer's CPU route (``model/spformer.py``) runs SDPA's math backend
under ``mask_bias`` of the unpacked closed mask, which the tests hold to
this plain version.

Launch counts: ``LAUNCHES["mask_attn_pack"]`` one a packed mask,
``["mask_attn_fwd"]`` / ``["mask_attn_bwd"]`` one an element (each launch of
the C entry points runs its few kernels in order).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _cuda

HEAD_DIM = 32           # the kernels' head width
TILE = 64               # queries of a query tile, keys of a key block
MAX_QUERIES = 512       # the backward holds a head's queries in shared memory
PACK_WORDS = 128        # words of a packing block's chunk of a row
# key splits of the forward and key ranges of the backward the kernels aim
# for: 7 query tiles x 8 heads x 36 blocks of a forward and 8 heads x 48
# blocks of a backward at the cell's 400 x ~200,000 (a key range at least 8
# blocks of 64 keys)
FWD_SPLITS = 36
BWD_RANGES = 48
MIN_BLOCKS = 8


class MaskBits(NamedTuple):
    """A packed attention mask (:func:`mask_pack`)."""

    bits: torch.Tensor        # (Q, words_of(K)) int32, 1 = open
    row_closed: torch.Tensor  # (Q,) bool: no key was open, so all opened
    tiles: torch.Tensor       # (ceil(Q / 64), ceil(K / 64)) uint8
    stats: torch.Tensor       # (3,) int64: open pairs, empty tiles, tiles
    keys: int                 # K


def words_of(keys: int) -> int:
    """Words of a packed row: K bits in whole 16-byte groups."""
    return 4 * -(-keys // 128)


def mask_pack_plain(p: torch.Tensor) -> MaskBits:
    """:class:`MaskBits` of mask logits ``p`` (Q, K) in plain PyTorch."""
    q, k = p.shape
    if q == 0 or k == 0:
        raise ValueError(f"mask_pack: empty mask logits {tuple(p.shape)}")
    open_ = ~(p < 0)
    row_closed = ~open_.any(-1)
    open_ = open_ | row_closed[:, None]
    w = words_of(k)
    padded = torch.zeros((q, w * 32), dtype=torch.int64, device=p.device)
    padded[:, :k] = open_.long()
    weight = torch.ones(32, dtype=torch.int64, device=p.device) << torch.arange(
        32, device=p.device)
    words = (padded.view(q, w, 32) * weight).sum(-1)
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    n_qt, n_kb = -(-q // TILE), -(-k // TILE)
    grid = torch.zeros((n_qt * TILE, n_kb * TILE), dtype=torch.bool,
                       device=p.device)
    grid[:q, :k] = open_
    tiles = grid.view(n_qt, TILE, n_kb, TILE).any(3).any(1).to(torch.uint8)
    stats = torch.stack([open_.sum(), (tiles == 0).sum(),
                         torch.tensor(tiles.numel(), device=p.device)]).long()
    return MaskBits(bits, row_closed, tiles, stats, k)


def mask_pack_cuda(p: torch.Tensor) -> MaskBits:
    """:func:`mask_pack_plain` on the card (``tl_mask_attn_pack``)."""
    _cuda.require(p, "mask_pack p", torch.float32, 2)
    q, k = p.shape
    if q == 0 or k == 0:
        raise ValueError(f"mask_pack: empty mask logits {tuple(p.shape)}")
    w = words_of(k)
    dev = p.device
    bits = torch.empty((q, w), dtype=torch.int32, device=dev)
    tiles = torch.empty((-(-q // TILE), -(-k // TILE)), dtype=torch.uint8,
                        device=dev)
    row_closed = torch.empty(q, dtype=torch.uint8, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    scratch = torch.empty(q * (-(-w // PACK_WORDS) + 1), dtype=torch.int32,
                          device=dev)
    code = _cuda.library().tl_mask_attn_pack(
        p.data_ptr(), bits.data_ptr(), tiles.data_ptr(),
        row_closed.data_ptr(), stats.data_ptr(), scratch.data_ptr(), q, k, w,
        _cuda.stream_ptr(p))
    _cuda.check(code, "tl_mask_attn_pack")
    _cuda.LAUNCHES["mask_attn_pack"] += 1
    return MaskBits(bits, row_closed.view(torch.bool), tiles, stats, k)


def mask_pack(p: torch.Tensor) -> MaskBits:
    """The packed mask of mask logits ``p`` (Q, K) float32: the kernel on a
    card, the plain version on the CPU."""
    return mask_pack_cuda(p) if p.is_cuda else mask_pack_plain(p)


def unpack_open(m: MaskBits) -> torch.Tensor:
    """(Q, K) bool, True where the pair is open."""
    shifts = torch.arange(32, device=m.bits.device, dtype=torch.int32)
    bits = (m.bits[..., None] >> shifts) & 1
    return bits.view(m.bits.shape[0], -1)[:, :m.keys].bool()


def unpack_closed(m: MaskBits) -> torch.Tensor:
    """(Q, K) bool closed mask, the set of ``closed_mask``."""
    return ~unpack_open(m)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(L, D) -> (H, L, D / H)."""
    return x.view(x.shape[0], heads, -1).transpose(0, 1)


def mask_attention_plain(q: torch.Tensor, kv: torch.Tensor,
                         masks: Sequence[MaskBits], ranges: Sequence[tuple],
                         heads: int, scale: float) -> torch.Tensor:
    """:func:`mask_attention` in float32 with PyTorch's own operations
    (differentiable): (B, Q, D) float32."""
    d = q.shape[-1]
    outs = []
    for b, (s, e) in enumerate(ranges):
        qh = _heads(q[b].float(), heads)
        k = _heads(kv[s:e, :d].float(), heads)
        v = _heads(kv[s:e, d:].float(), heads)
        sc = (qh @ k.transpose(1, 2)) * scale
        sc = sc.masked_fill(~unpack_open(masks[b])[None], float("-inf"))
        o = torch.softmax(sc, -1) @ v
        outs.append(o.transpose(0, 1).reshape(-1, d))
    return torch.stack(outs)


def _check(q, kv, m: MaskBits, heads: int, what: str) -> None:
    _cuda.require(q, f"{what} q", torch.bfloat16, 2)
    _cuda.require(kv, f"{what} kv", torch.bfloat16, 2)
    nq, d = q.shape
    if d != heads * HEAD_DIM or kv.shape[1] != 2 * d:
        raise ValueError(f"{what}: heads of width {HEAD_DIM} only (q "
                         f"{tuple(q.shape)}, kv {tuple(kv.shape)}, {heads} "
                         "heads)")
    if not 0 < nq <= MAX_QUERIES:
        raise ValueError(f"{what}: 1 to {MAX_QUERIES} queries, got {nq}")
    if m.keys != kv.shape[0] or m.bits.shape != (nq, words_of(m.keys)):
        raise ValueError(f"{what}: mask of {m.bits.shape[0]} x {m.keys} for "
                         f"{nq} queries and {kv.shape[0]} keys")
    _cuda.require(m.bits, f"{what} bits", torch.int32, 2)
    _cuda.require(m.tiles, f"{what} tiles", torch.uint8, 2)


def _blocks(n_kb: int, parts: int) -> int:
    return max(MIN_BLOCKS, -(-n_kb // parts))


def mask_attention_fwd_cuda(q, kv, m: MaskBits, heads: int, scale: float,
                            out: torch.Tensor) -> torch.Tensor:
    """One element's forward (``tl_mask_attn_fwd``): writes ``out`` (Q, D)
    bf16 and returns the log2-domain LSE (H, Q) float32."""
    _check(q, kv, m, heads, "mask_attention")
    nq, k = q.shape[0], kv.shape[0]
    n_kb = -(-k // TILE)
    per = _blocks(n_kb, FWD_SPLITS)
    splits = -(-n_kb // per)
    o_part = q.new_empty((splits, heads, nq, HEAD_DIM), dtype=torch.float32)
    ml = q.new_empty((splits, heads, nq, 2), dtype=torch.float32)
    lse = q.new_empty((heads, nq), dtype=torch.float32)
    code = _cuda.library().tl_mask_attn_fwd(
        q.data_ptr(), kv.data_ptr(), m.bits.data_ptr(), m.tiles.data_ptr(),
        o_part.data_ptr(), ml.data_ptr(), out.data_ptr(), lse.data_ptr(), nq,
        k, m.bits.shape[1], heads, per, scale * math.log2(math.e),
        _cuda.stream_ptr(q))
    _cuda.check(code, "tl_mask_attn_fwd")
    _cuda.LAUNCHES["mask_attn_fwd"] += 1
    return lse


def mask_attention_bwd_cuda(q, kv, m: MaskBits, o, lse, dout, heads: int,
                            scale: float, dq: torch.Tensor,
                            dkv: torch.Tensor) -> None:
    """One element's backward (``tl_mask_attn_bwd``): writes dq (Q, D) and
    every row of dkv (K, 2 D), bf16."""
    _check(q, kv, m, heads, "mask_attention backward")
    _cuda.require(dout, "mask_attention dout", torch.bfloat16, 2)
    nq, k = q.shape[0], kv.shape[0]
    n_kb = -(-k // TILE)
    per = _blocks(n_kb, BWD_RANGES)
    n_ranges = -(-n_kb // per)
    delta = q.new_empty((heads, nq), dtype=torch.float32)
    dq_part = q.new_empty((n_ranges, heads, nq, HEAD_DIM), dtype=torch.float32)
    code = _cuda.library().tl_mask_attn_bwd(
        q.data_ptr(), kv.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), m.bits.data_ptr(), m.tiles.data_ptr(),
        delta.data_ptr(), dq_part.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
        nq, k, m.bits.shape[1], heads, per, scale * math.log2(math.e), scale,
        _cuda.stream_ptr(q))
    _cuda.check(code, "tl_mask_attn_bwd")
    _cuda.LAUNCHES["mask_attn_bwd"] += 1


class MaskAttentionFn(torch.autograd.Function):
    """:func:`mask_attention` on the card: one forward and, as the
    backward, one backward launch an element."""

    @staticmethod
    def forward(ctx, q, kv, masks, ranges, heads, scale):
        q, kv = q.contiguous(), kv.contiguous()
        out = torch.empty_like(q)
        lses = [mask_attention_fwd_cuda(q[b], kv[s:e], masks[b], heads,
                                        scale, out[b])
                for b, (s, e) in enumerate(ranges)]
        ctx.save_for_backward(q, kv, out, *lses)
        ctx.masks, ctx.ranges = masks, ranges
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        q, kv, out, *lses = ctx.saved_tensors
        grad = grad.contiguous()
        dq = torch.empty_like(q)
        covered = sum(e - s for s, e in ctx.ranges) == kv.shape[0]
        dkv = torch.empty_like(kv) if covered else torch.zeros_like(kv)
        for b, (s, e) in enumerate(ctx.ranges):
            mask_attention_bwd_cuda(q[b], kv[s:e], ctx.masks[b], out[b],
                                    lses[b], grad[b], ctx.heads, ctx.scale,
                                    dq[b], dkv[s:e])
        return dq, dkv, None, None, None, None


def mask_attention(q: torch.Tensor, kv: torch.Tensor,
                   masks: Sequence[MaskBits], ranges: Sequence[tuple],
                   heads: int, scale: float) -> torch.Tensor:
    """Masked cross-attention of the batch's elements on the card: q (B, Q,
    D), kv (V, 2 D) bf16, element b's keys the rows ``ranges[b]`` under
    ``masks[b]`` -> (B, Q, D) bf16.  CPU tensors raise: the CPU has
    :func:`mask_attention_plain`."""
    if not q.is_cuda:
        raise ValueError("mask_attention: the kernels take CUDA tensors; "
                         "the CPU has mask_attention_plain")
    if len(masks) != len(ranges) or q.shape[0] != len(ranges):
        raise ValueError(f"mask_attention: {q.shape[0]} query sets, "
                         f"{len(masks)} masks, {len(ranges)} key ranges")
    return MaskAttentionFn.apply(q, kv, list(masks), list(ranges), heads,
                                 scale)
