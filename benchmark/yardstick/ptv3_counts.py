"""Operations and bytes of a Point Transformer V3 training step, counted by
the benchmark from its own stages of the step's voxels (the training cell
``cells/train_ptv3.py:step_levels``), never from the program's counters.

A step's levels: ``tokens`` and ``nnz`` (the xCPE rule's (voxel, offset)
pairs) a stage, ``elems`` (the tokens of each batch element) a stage,
``stem_nnz`` (the k = 5 stem's pairs) and ``points``.  Attention: a stage's
patch size K = min(patch size, fewest tokens of an element), each element
padded to a multiple of K, so P patches of K rows; a block's attention
costs 4 P H K^2 d operations forward (q k^T and the product with v) and
10 P H K^2 d backward (the flash backward recomputes q k^T besides its four
products).  2 operations a multiply-add.
"""

from __future__ import annotations

from .counts import PEAK_BF16_FLOPS, PEAK_HBM_BPS, conv_least_s

STEM_OFFSETS = 125


def patches(elems, patch_size: int):
    """(P, K) of one stage from its tokens per batch element."""
    live = [int(n) for n in elems if int(n) > 0]
    if not live:
        return 0, 0
    k = min(int(patch_size), min(live))
    return sum(-(-n // k) for n in live), k


def blocks(ptv3: dict):
    """Every block of the model as (stage, channels, heads, patch size), the
    encoder's then the decoder's."""
    out = []
    for s, d in enumerate(ptv3["enc_depths"]):
        out += [(s, ptv3["enc_channels"][s], ptv3["enc_num_head"][s],
                 ptv3["enc_patch_size"][s])] * int(d)
    for s, d in enumerate(ptv3["dec_depths"]):
        out += [(s, ptv3["dec_channels"][s], ptv3["dec_num_head"][s],
                 ptv3["dec_patch_size"][s])] * int(d)
    return out


def attention_counts(lv: dict, ptv3: dict):
    """(forward operations, backward operations, forward bytes, backward
    bytes) of every block's patch attention in one step, bf16 operands:
    forward reads q, k, v and writes the output and the row statistics
    (float32 a row and head); backward reads q, k, v, the output, its
    gradient and the statistics and writes dq, dk, dv."""
    fo = bo = fb = bb = 0.0
    for s, c, h, patch in blocks(ptv3):
        p, k = patches(lv["elems"][s], patch)
        rows = p * k
        d = c // h
        fo += 4.0 * p * h * k * k * d
        bo += 10.0 * p * h * k * k * d
        fb += 4 * rows * c * 2 + rows * h * 4
        bb += 5 * rows * c * 2 + rows * h * 4 + 3 * rows * c * 2
    return fo, bo, fb, bb


def attention_least_s(lv: dict, ptv3: dict) -> float:
    """Least seconds of a step's attention, forward and backward each
    bounded by the larger of its operations over the bf16 peak and its
    bytes over HBM's."""
    fo, bo, fb, bb = attention_counts(lv, ptv3)
    return (max(fo / PEAK_BF16_FLOPS, fb / PEAK_HBM_BPS)
            + max(bo / PEAK_BF16_FLOPS, bb / PEAK_HBM_BPS))


def convs(lv: dict, ptv3: dict, in_channels: int = 4):
    """Every submanifold conv of one forward as (V, nnz, K, Cin, Cout): the
    stem, then each block's xCPE."""
    out = [(lv["tokens"][0], lv["stem_nnz"], STEM_OFFSETS, in_channels,
            ptv3["enc_channels"][0])]
    for s, c, _, _ in blocks(ptv3):
        out.append((lv["tokens"][s], lv["nnz"][s], 27, c, c))
    return out


def conv_least_s_step(lv: dict, ptv3: dict, in_channels: int = 4) -> float:
    """Least seconds of a step's kernel-2 work: every forward conv and the
    input gradient of every conv but the stem's."""
    cv = convs(lv, ptv3, in_channels)
    return (sum(conv_least_s(*c) for c in cv)
            + sum(conv_least_s(v, n, k, co, ci) for v, n, k, ci, co in cv[1:]))


def forward_flops(lv: dict, ptv3: dict, in_channels: int = 4,
                  head_classes=(2, 3)) -> float:
    """Useful operations of one forward: convs (2 nnz Cin Cout), linears
    (xCPE C^2, qkv 3 C^2, projection C^2, MLP 2 r C^2 a token), the patch
    attention, pooling (Cin Cout a token of the finer stage), unpooling
    (both projections) and TreeLearn's heads."""
    flops = sum(2.0 * n * ci * co for _, n, _, ci, co in convs(
        lv, ptv3, in_channels))
    r = float(ptv3.get("mlp_ratio", 4))
    for s, c, _, _ in blocks(ptv3):
        flops += 2.0 * lv["tokens"][s] * c * c * (5.0 + 2.0 * r)
    flops += attention_counts(lv, ptv3)[0]
    enc, dec = list(ptv3["enc_channels"]), list(ptv3["dec_channels"])
    for s in range(1, len(enc)):
        flops += 2.0 * lv["tokens"][s - 1] * enc[s - 1] * enc[s]
    chans = dec + [enc[-1]]
    for s in range(len(dec)):
        flops += 2.0 * lv["tokens"][s + 1] * chans[s + 1] * chans[s]
        flops += 2.0 * lv["tokens"][s] * enc[s] * chans[s]
    c = chans[0]
    flops += sum(2.0 * lv["points"] * (c * c + c * k) for k in head_classes)
    return flops


def train_step_flops(lv: dict, ptv3: dict, in_channels: int = 4) -> float:
    """Model operations of one training step: three times the forward's
    (each product's two gradients cost what it costs)."""
    return 3.0 * forward_flops(lv, ptv3, in_channels)
