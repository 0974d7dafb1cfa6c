"""The TreeLearn model as an ``nn.Module`` (port of
treelearn_tpu/model/network.py; reference tree_learn/model/tree_learn.py).

Input SubMConv3d (dim_coord + dim_feat -> channels, k=3) -> UBlock over
[channels * (i+1)] * num_blocks -> BN + ReLU -> per-point gather -> two MLPs
(semantic 2-way, offset 3-dim).  Same forward and output keys as
``TreeLearn.apply`` (network.py:210-385).

``backbone="ptv3"`` puts Point Transformer V3 (model/ptv3.py, its keys in
``ptv3``) in the U-Net's place: voxelize -> PTv3 -> per-point gather -> the
same two heads, as wide as PTv3's output.  ``backbone="unet"`` (the
default) is the U-Net above; any other value raises.

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
from .ptv3 import PTv3
from .ptv3 import init_numpy as ptv3_init_numpy

BACKBONES = ("unet", "ptv3")


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
                 block_reps: int = 2, backbone: str = "unet",
                 ptv3: Optional[dict] = None, **kwargs):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; one of "
                             f"{BACKBONES}")
        self.backbone = backbone
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
        if backbone == "ptv3":
            self._init_ptv3(dict(ptv3 or {}))
            return
        if ptv3:
            raise ValueError("ptv3 keys given with backbone 'unet'")

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

    def _init_ptv3(self, cfg: dict):
        if self.fixed_modules:
            raise ValueError("fixed_modules is a U-Net option")
        c_in = int(cfg.pop("in_channels", self.in_channels))
        if c_in != self.in_channels:
            raise ValueError(f"ptv3 in_channels {c_in}: the voxel features "
                             f"have {self.in_channels}")
        self.ptv3 = PTv3(self.in_channels, **cfg)
        self.channels = self.ptv3.out_channels
        self.semantic_linear = MLP(self.channels, 2)
        self.offset_linear = MLP(self.channels, 3)

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
        """Load the seed's parameters into this module; returns self.  The
        PTv3 backbone takes the first child of the seed's sequence, the
        heads the next two."""
        if self.backbone == "ptv3":
            ss = (seed if isinstance(seed, np.random.SeedSequence)
                  else np.random.SeedSequence(int(seed)))
            k0, k1, k2 = ss.spawn(3)
            sd = {f"ptv3.{k}": torch.from_numpy(np.asarray(v))
                  for k, v in ptv3_init_numpy(self.ptv3, k0).items()}
            params, state = {}, {}
            params["semantic_linear"], state["semantic_linear"] = init_mlp(
                k1, self.channels, 2)
            params["offset_linear"], state["offset_linear"] = init_mlp(
                k2, self.channels, 3)
            sd.update(params_from_jax_numpy(params, state))
            self.load_state_dict(sd)
            return self
        self.load_state_dict(params_from_jax_numpy(*self.init_numpy(seed)))
        return self

    def forward(self, coords: torch.Tensor, input_feats: torch.Tensor,
                batch_ids: torch.Tensor, valid: torch.Tensor, *,
                batch_size: int, compute_dtype=torch.float32):
        """coords (N, 3) f32 metric, input_feats (N, F) f32, batch_ids (N,),
        valid (N,) bool -> dict with semantic_prediction_logits (N, 2),
        offset_predictions (N, 3), backbone_feats (N, channels) in float32,
        plus n_voxels and the (levels,) int32 tensors n_voxels_per_level
        and rule_nnz_per_level on the inputs' device.

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
        if self.backbone == "ptv3":
            return self._forward_ptv3(vb, grid0, valid, batch_size,
                                      compute_dtype, coords.device)
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
            # kept on the device: a host read here waits on the card once a
            # level; callers read them from the shipped meta
            # (pipeline/inference.py:level_counts)
            dev = coords.device
            n_voxels_per_level = torch.tensor(
                [p.grid.n_active for p in plans], dtype=torch.int32,
                pin_memory=dev.type == "cuda").to(dev, non_blocking=True)
            rule_nnz_per_level = torch.stack(
                [(p.rule >= 0).sum() for p in plans]).to(torch.int32)
        return {
            "semantic_prediction_logits": sem.float(),
            "offset_predictions": off.float(),
            "backbone_feats": backbone_feats.float(),
            "n_voxels": vb.n_voxels,
            "n_voxels_per_level": n_voxels_per_level,
            "rule_nnz_per_level": rule_nnz_per_level,
        }

    def _forward_ptv3(self, vb, grid0, valid, batch_size, compute_dtype, dev):
        """The forward's PTv3 branch: the same outputs, a level a stage
        (tokens, xCPE rule pairs)."""
        x, stages = self.ptv3(vb.voxel_feats, grid0, batch_size,
                              compute_dtype)
        with span("devoxelize"):
            backbone_feats = devoxelize(x.to(compute_dtype), vb.v2p_map)
        with span("heads"):
            sem = self.semantic_linear(backbone_feats, valid)
            off = self.offset_linear(backbone_feats, valid)
        with span("counts"):
            n_voxels_per_level = torch.tensor(
                [st.n for st in stages], dtype=torch.int32,
                pin_memory=dev.type == "cuda").to(dev, non_blocking=True)
            rule_nnz_per_level = torch.stack(
                [(st.rule >= 0).sum() for st in stages]).to(torch.int32)
        return {
            "semantic_prediction_logits": sem.float(),
            "offset_predictions": off.float(),
            "backbone_feats": backbone_feats.float(),
            "n_voxels": vb.n_voxels,
            "n_voxels_per_level": n_voxels_per_level,
            "rule_nnz_per_level": rule_nnz_per_level,
        }
