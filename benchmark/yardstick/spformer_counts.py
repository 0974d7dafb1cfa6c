"""Operations and bytes of a training step of SPFormer's query decoder on
the U-Net, counted by the benchmark from its own topology of the step's
voxels (the training cell ``cells/train_spformer.py:step_levels``: the
U-Net's voxels and rule pairs a level, the points, the voxels of each
batch element, which are the decoder's keys) and from the open (query, key)
pairs of the masked cross-attentions, the program's
``spformer.open_pairs.l<l>`` counters, which the cell's ``open_gap`` holds
to the reference's own count.

Masked cross-attention of one layer over an element of K keys, Q queries
of width D in H heads: forward 4 D operations an open pair (the score and
the product with v), backward 10 D (the score again, and four products);
bytes (bf16 operands): forward reads q (Q D), k and v (K D each) and the
additive mask (Q K), writes o (Q D) and the row statistics (float32, Q H);
backward reads q, k, v, o, dO, the mask and the statistics and writes dq,
dk and dv.  2 operations a multiply-add.
"""

from __future__ import annotations

from .counts import PEAK_BF16_FLOPS, PEAK_HBM_BPS, analytic_model_flops

BF16 = 2


def attention_bytes(n_query: int, keys: int, d: int, heads: int):
    """(forward bytes, backward bytes) of one masked cross-attention."""
    qd, kd = n_query * d * BF16, keys * d * BF16
    mask, stats = n_query * keys * BF16, n_query * heads * 4
    fwd = qd + 2 * kd + mask + qd + stats
    bwd = 3 * qd + 2 * kd + mask + stats + qd + 2 * kd
    return fwd, bwd


def attention_least_s(levels, open_pairs, spf: dict) -> float:
    """Least seconds of the masked cross-attentions of the window's steps:
    per layer, forward and backward each the larger of its operations
    (over the window's open pairs of that layer) over the bf16 peak and
    its bytes (over every step's elements) over HBM's.  ``open_pairs``
    is [open pairs of layer 1, 2, ...] over the window."""
    q, d, h = int(spf["num_query"]), int(spf["d_model"]), int(spf["nhead"])
    fb = bb = 0.0
    for lv in levels:
        for k in lv["elems"]:
            f, b = attention_bytes(q, int(k), d, h)
            fb += f
            bb += b
    least = 0.0
    for n in open_pairs:
        least += max(4.0 * d * n / PEAK_BF16_FLOPS, fb / PEAK_HBM_BPS)
        least += max(10.0 * d * n / PEAK_BF16_FLOPS, bb / PEAK_HBM_BPS)
    return least


def decoder_dense_flops(lv: dict, spf: dict, in_channels: int) -> float:
    """Operations of one forward of the decoder apart from the masked
    attention's open pairs: the projections of the keys, values and mask
    features, every layer's query and key / value projections, output
    projection, self-attention and FFN, and every prediction's heads and
    dense mask product (Q D a key)."""
    q, d = int(spf["num_query"]), int(spf["d_model"])
    hid, n_layer = int(spf["hidden_dim"]), int(spf["num_layer"])
    v, b = float(sum(lv["elems"])), float(len(lv["elems"]))
    c = float(in_channels)
    flops = 2.0 * v * c * d + 2.0 * v * (c * d + d * d)
    per_layer = (2.0 * b * q * d * d + 2.0 * v * 2 * d * d
                 + 2.0 * b * q * d * d
                 + 2.0 * b * q * 3 * d * d + 4.0 * b * q * q * d
                 + 2.0 * b * q * d * d
                 + 2.0 * b * q * 2 * d * hid)
    flops += n_layer * per_layer
    per_pred = (2.0 * b * q * (d * d + 2 * d) + 2.0 * b * q * (d * d + d)
                + 2.0 * q * d * v)
    return flops + (n_layer + 1) * per_pred


def train_flops(levels, open_pairs, model: dict) -> float:
    """Model operations of the window's training steps: three times each
    step's forward (the U-Net's, yardstick/counts.py at its levels without
    point heads, and the decoder's), the masked attention counted over its
    open pairs."""
    spf = model["spformer"]
    ch, nb = int(model["channels"]), int(model["num_blocks"])
    fwd = 0.0
    for lv in levels:
        fwd += analytic_model_flops(lv["voxels"], lv["nnz"], 0, channels=ch,
                                    num_blocks=nb)
        fwd += decoder_dense_flops(lv, spf, ch)
    fwd += 4.0 * int(spf["d_model"]) * float(sum(open_pairs))
    return 3.0 * fwd


def open_pairs_of(counters: dict) -> list:
    """[open pairs of layer 1, 2, ...] from a window's counter totals."""
    out, layer = [], 1
    while f"spformer.open_pairs.l{layer}" in counters:
        out.append(int(counters[f"spformer.open_pairs.l{layer}"]))
        layer += 1
    return out
