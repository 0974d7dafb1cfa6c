"""Operations and bytes of the model's work, counted by the benchmark from
its own topology of the voxels (``reference/sparse.py``), never from the
program's counters, so a roofline reads the same work whatever implements a
kernel.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989 TFLOP/s
in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12


def analytic_model_flops(n_vox_per_level, rule_nnz_per_level, n_points: int,
                         channels: int = 32, num_blocks: int = 7,
                         block_reps: int = 2, in_channels: int = 4) -> float:
    """Useful FLOPs of one forward: frozen copy of the port's count
    (model/network.py:analytic_model_flops) with the exact gather counts.
    Down and inverse convs count one corner per fine voxel; 2 FLOPs a MAC."""
    v = [float(x) for x in n_vox_per_level]
    nnz = [float(x) for x in rule_nnz_per_level]
    chans = [channels * (i + 1) for i in range(num_blocks)]
    flops = nnz[0] * in_channels * chans[0] * 2
    for lvl, c in enumerate(chans):
        subm = 2 * block_reps * nnz[lvl] * c * c * 2
        if lvl < num_blocks - 1:
            subm += nnz[lvl] * (2 * c) * c * 2
            subm += (2 * block_reps - 1) * nnz[lvl] * c * c * 2
            c_next = chans[lvl + 1]
            subm += v[lvl] * c * c_next * 2
            subm += v[lvl] * c_next * c * 2
            subm += v[lvl] * (2 * c) * c * 2
        flops += subm
    heads = n_points * (channels * channels + channels * 2
                        + channels * channels + channels * 3) * 2
    return flops + heads


def input_conv_flops(rule_nnz_per_level, channels: int = 32,
                     in_channels: int = 4) -> float:
    return float(rule_nnz_per_level[0]) * in_channels * channels * 2


def train_step_flops(n_vox_per_level, rule_nnz_per_level, n_points: int,
                     **kw) -> float:
    """Forward, input gradient and weight gradient of one training step:
    each backward product costs what its forward product costs, and the
    input conv has no input gradient."""
    fwd = analytic_model_flops(n_vox_per_level, rule_nnz_per_level, n_points,
                               **kw)
    return 3.0 * fwd - input_conv_flops(
        rule_nnz_per_level, kw.get("channels", 32), kw.get("in_channels", 4))


def subm_convs(n_vox_per_level, rule_nnz_per_level, channels: int = 32,
               num_blocks: int = 7, block_reps: int = 2, in_channels: int = 4,
               n_offsets: int = 27):
    """Every submanifold conv of one forward as (V, nnz, K, Cin, Cout), in
    the model's order: the input conv, then per level the head blocks, the
    tail blocks (the first takes the skip concat, 2C channels)."""
    chans = [channels * (i + 1) for i in range(num_blocks)]
    out = [(n_vox_per_level[0], rule_nnz_per_level[0], n_offsets,
            in_channels, chans[0])]
    for lvl, c in enumerate(chans):
        v, nnz = n_vox_per_level[lvl], rule_nnz_per_level[lvl]
        out += [(v, nnz, n_offsets, c, c)] * (2 * block_reps)
        if lvl < num_blocks - 1:
            out.append((v, nnz, n_offsets, 2 * c, c))
            out += [(v, nnz, n_offsets, c, c)] * (2 * block_reps - 1)
    return out


def conv_least_s(v, nnz, k, cin, cout, elem: int = 2) -> float:
    """Least time of one conv (or input gradient, with Cin and Cout
    swapped): 2 nnz Cin Cout operations; bytes read once: the input rows,
    the weights, the (K, V) int32 rule; written once: the output rows."""
    flops = 2.0 * nnz * cin * cout
    nbytes = (v * cin * elem + k * cin * cout * elem + k * v * 4
              + v * cout * elem)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BPS)


def dw_least_s(v, nnz, k, cin, cout, elem: int = 2) -> float:
    """Least time of one weight gradient: 2 nnz Cin Cout operations; bytes:
    the input rows, the output gradient rows, the rule, and the float32
    (K, Cin, Cout) result written once."""
    flops = 2.0 * nnz * cin * cout
    nbytes = v * cin * elem + v * cout * elem + k * v * 4 + k * cin * cout * 4
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BPS)


def forward_conv_least_s(levels, **kw) -> float:
    return sum(conv_least_s(*c) for c in subm_convs(*levels, **kw))


def backward_least_s(levels, **kw):
    """(input gradients' least seconds, weight gradients' least seconds) of
    one training step: every conv but the input conv has an input
    gradient (Cout -> Cin); every conv has a weight gradient."""
    convs = subm_convs(*levels, **kw)
    dx = sum(conv_least_s(v, nnz, k, cout, cin)
             for v, nnz, k, cin, cout in convs[1:])
    dw = sum(dw_least_s(*c) for c in convs)
    return dx, dw
