"""The TreeLearn model as an ``nn.Module`` (port of
treelearn_tpu/model/network.py; reference tree_learn/model/tree_learn.py).

Input SubMConv3d (dim_coord + dim_feat -> channels, k=3) -> UBlock over
[channels * (i+1)] * num_blocks -> BN + ReLU -> per-point gather -> two MLPs
(semantic 2-way, offset 3-dim).  Same forward and output keys as
``TreeLearn.apply`` (network.py:210-385).

PyTorch runs eagerly, so every level works on its exact voxel count.  The
JAX package's static ``voxel_capacity`` / ``level_capacities`` padding, the
banded ``level_windows``, the ``fast_conv`` program variants, and the
``CapacityOverflow`` / ``SpansOverflow`` guards and retries exist only for
XLA's static shapes and the TPU conv's windows; they have no counterpart
here.  The rulebook and the submanifold convs go through the CUDA kernels of
ops/rulebook.py and ops/subm_conv.py on the card, and the convs through
``SubmConvFn``, so ``model.train()`` plus ``loss.backward()`` is the
training forward and backward (dx and dW kernels).  In training mode the
BatchNorms take batch statistics, except those of ``fixed_modules``, which
keep their running ones; the point-level MLP BatchNorms see only the
batch's ``valid`` rows, since the training loader pads its batches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.sparse import (build_downsample, build_subm_rulebook,
                          grid_from_sorted_keys)
from ..ops.rulebook import subm_rulebook
from ..ops.subm_conv import SubmConvFn
from ..ops.voxelize import devoxelize, voxelize_points
from ..utils.trace import span
from .blocks import (MLP, BatchNorm, LevelPlan, UBlock, Weight, init_bn,
                     init_mlp, init_subm_conv, init_ublock)
from .checkpoint import params_from_jax_numpy


def analytic_model_flops(n_vox_per_level, n_points: int, channels: int = 32,
                         num_blocks: int = 7, block_reps: int = 2,
                         kernel_size: int = 3, in_channels: int = 4,
                         rule_nnz_per_level=None) -> float:
    """Useful FLOPs of one forward pass from the per-level active-voxel
    counts (model output ``n_voxels_per_level``); the JAX package's
    function (treelearn_tpu/model/network.py:83-120), copied.

    The MFU numerator is computed analytically: no tool counts the FLOPs
    inside the hand-written kernels.  With ``rule_nnz_per_level`` (model
    output of the same name) the submanifold gather count is exact;
    otherwise the full k^3 footprint per voxel is assumed (a ~2-3x
    overcount on surface-like sparsity).  Down/inverse convs count one
    contributing corner per fine voxel (their useful MACs); 2 FLOPs per
    MAC.
    """
    k = kernel_size ** 3
    v = [float(x) for x in np.asarray(n_vox_per_level)]
    if rule_nnz_per_level is not None:
        nnz = [float(x) for x in np.asarray(rule_nnz_per_level)]
    else:
        nnz = [vi * k for vi in v]
    chans = [channels * (i + 1) for i in range(num_blocks)]
    flops = nnz[0] * in_channels * chans[0] * 2            # input conv
    for lvl, c in enumerate(chans):
        subm = 2 * block_reps * nnz[lvl] * c * c * 2       # head blocks
        if lvl < num_blocks - 1:
            subm += nnz[lvl] * (2 * c) * c * 2             # tail b0 conv1
            subm += (2 * block_reps - 1) * nnz[lvl] * c * c * 2
            c_next = chans[lvl + 1]
            subm += v[lvl] * c * c_next * 2                # down conv
            subm += v[lvl] * c_next * c * 2                # inverse conv
            subm += v[lvl] * (2 * c) * c * 2               # i_branch 1x1
        flops += subm
    heads = n_points * (channels * channels + channels * 2
                        + channels * channels + channels * 3) * 2
    return flops + heads


def level_rule(grid, kernel_size: int = 3):
    """(k^3, V) int32 subm rule of one level: kernel 1 on the card at
    k = 3; any other odd k takes the plain probe builder
    (ops/sparse.py:build_subm_rulebook), whose torch ops then run on the
    card as well.  The JAX package builds that case's rule outside any
    Pallas kernel too (XLA probes, treelearn_tpu/model/blocks.py:395-408),
    so there is no kernel of its to port for it."""
    if kernel_size == 3:
        return subm_rulebook(grid)
    return build_subm_rulebook(grid, kernel_size)


def build_level_plans(grid, num_levels: int, kernel_size: int = 3):
    """Rulebooks of every U-Net level, built once per batch: the level's
    (k^3, V) subm rule (:func:`level_rule`) and the downsample rulebook to
    the next level."""
    plans = []
    g = grid
    for lvl in range(num_levels):
        with span(f"plans.L{lvl}.rulebook"):
            rule = level_rule(g, kernel_size)
        if lvl < num_levels - 1:
            with span(f"plans.L{lvl}.downsample"):
                rb = build_downsample(g)
            plans.append(LevelPlan(grid=g, rule=rule, down=rb))
            g = rb.out_grid
        else:
            plans.append(LevelPlan(grid=g, rule=rule, down=None))
    return tuple(plans)


class TreeLearn(nn.Module):
    def __init__(self, channels: int = 32, num_blocks: int = 7,
                 kernel_size: int = 3, dim_coord: int = 3, dim_feat: int = 1,
                 fixed_modules: Sequence[str] = (), use_feats: bool = False,
                 use_coords: bool = False,
                 spatial_shape: Optional[Sequence[int]] = None,
                 max_num_points_per_voxel: int = 3, voxel_size: float = 0.1,
                 block_reps: int = 2, **kwargs):
        super().__init__()
        if kernel_size % 2 == 0 or kernel_size < 1:
            # the conv's input gradient mirrors the offsets (flip(0)), which
            # is the transpose only for a centred, odd kernel
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.channels = channels
        self.num_blocks = num_blocks
        self.kernel_size = kernel_size
        self.dim_coord = dim_coord
        self.dim_feat = dim_feat
        self.fixed_modules = tuple(fixed_modules)
        self.use_feats = use_feats
        self.use_coords = use_coords
        self.spatial_shape = (tuple(int(s) for s in spatial_shape)
                              if spatial_shape is not None else None)
        self.max_pts = max_num_points_per_voxel
        self.voxel_size = voxel_size
        self.block_reps = block_reps
        self.block_channels = [channels * (i + 1) for i in range(num_blocks)]
        self.in_channels = dim_coord + dim_feat

        self.input_conv = nn.ModuleDict(
            {"0": Weight(kernel_size ** 3, self.in_channels, channels)})
        self.unet = UBlock(self.block_channels, block_reps, kernel_size)
        self.output_layer = nn.ModuleDict({"0": BatchNorm(channels)})
        self.semantic_linear = MLP(channels, 2)
        self.offset_linear = MLP(channels, 3)
        for name in self.fixed_modules:
            for m in getattr(self, name).modules():
                if isinstance(m, BatchNorm):
                    m.frozen = True

    def init_numpy(self, seed):
        """(params, state) numpy trees from the JAX package's initializers
        (treelearn_tpu/model/network.py:175-206) — bit-identical for the
        same int seed or SeedSequence."""
        ss = (seed if isinstance(seed, np.random.SeedSequence)
              else np.random.SeedSequence(int(seed)))
        k0, k1, k2, k3 = ss.spawn(4)
        params, state = {}, {}
        params["input_conv"] = {"0": init_subm_conv(
            k0, self.kernel_size, self.in_channels, self.channels)}
        params["unet"], state["unet"] = init_ublock(
            k1, self.block_channels, self.block_reps, self.kernel_size)
        bn_p, bn_s = init_bn(self.channels)
        params["output_layer"] = {"0": bn_p}
        state["output_layer"] = {"0": bn_s}
        params["semantic_linear"], state["semantic_linear"] = init_mlp(
            k2, self.channels, 2)
        params["offset_linear"], state["offset_linear"] = init_mlp(
            k3, self.channels, 3)
        return params, state

    def init(self, seed):
        """Load the seed's parameters into this module; returns self."""
        self.load_state_dict(params_from_jax_numpy(*self.init_numpy(seed)))
        return self

    def forward(self, coords: torch.Tensor, input_feats: torch.Tensor,
                batch_ids: torch.Tensor, valid: torch.Tensor, *,
                batch_size: int, compute_dtype=torch.float32):
        """coords (N, 3) f32 metric, input_feats (N, F) f32, batch_ids (N,),
        valid (N,) bool -> dict with semantic_prediction_logits (N, 2),
        offset_predictions (N, 3), backbone_feats (N, channels) in float32,
        plus n_voxels, n_voxels_per_level and rule_nnz_per_level.

        Its parts run under named spans (utils/trace.py: voxelize, plans,
        unet.L<l>, heads, devoxelize, counts), which record only while a
        profiler or a span timer runs."""
        if self.spatial_shape is not None:
            key_space = batch_size * int(np.prod(self.spatial_shape))
            assert key_space < 2**31, (
                f"voxel key space {key_space} overflows int32 keys "
                f"(batch_size {batch_size} x spatial_shape "
                f"{self.spatial_shape})")
        with span("voxelize"):
            vb = voxelize_points(
                coords, input_feats, batch_ids, valid, batch_size=batch_size,
                voxel_size=self.voxel_size, max_pts=self.max_pts,
                spatial_shape=self.spatial_shape, use_coords=self.use_coords,
                use_feats=self.use_feats)
            grid0 = grid_from_sorted_keys(vb.voxel_keys, vb.spatial_shape)
        with span("plans"):
            plans = build_level_plans(grid0, self.num_blocks,
                                      self.kernel_size)

        with span("unet.L0"):
            x = vb.voxel_feats.to(compute_dtype)
            x = SubmConvFn.apply(x, self.input_conv["0"].weight,
                                 plans[0].rule)
        x = self.unet(x, plans, 0)
        with span("heads"):
            x = torch.relu(self.output_layer["0"](x))
        with span("devoxelize"):
            backbone_feats = devoxelize(x, vb.v2p_map)
        with span("heads"):
            sem = self.semantic_linear(backbone_feats, valid)
            off = self.offset_linear(backbone_feats, valid)
        with span("counts"):
            n_voxels_per_level = [p.grid.n_active for p in plans]
            rule_nnz_per_level = [int((p.rule >= 0).sum()) for p in plans]
        return {
            "semantic_prediction_logits": sem.float(),
            "offset_predictions": off.float(),
            "backbone_feats": backbone_feats.float(),
            "n_voxels": vb.n_voxels,
            "n_voxels_per_level": n_voxels_per_level,
            "rule_nnz_per_level": rule_nnz_per_level,
        }
