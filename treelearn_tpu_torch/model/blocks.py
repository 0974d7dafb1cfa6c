"""Model blocks as ``nn.Module``s: BatchNorm, MLP, ResidualBlock, UBlock
(port of treelearn_tpu/model/blocks.py).

Parity targets (reference tree_learn/model/blocks.py):
* ``MLP`` — Linear(C,C) + BN + ReLU + Linear(C,out)   (blocks.py:8-26)
* ``Custom1x1Subm3d`` — 1x1 sparse conv as a plain matmul (blocks.py:29-39)
* ``ResidualBlock`` — pre-activation BN-ReLU-SubMConv x2 + identity/1x1
  shortcut (blocks.py:42-79)
* ``UBlock`` — recursive U-Net level (blocks.py:81-149)

Every submanifold conv goes through ``SubmConvFn`` (ops/subm_conv.py), so
the model trains with the CUDA forward, dx and dW kernels on the card.  The
down/inverse convs stay plain PyTorch (a wide matmul, a corner select and
``index_add_`` / a gather), which autograd differentiates, as the JAX
package leaves them to XLA.

Submodule names reproduce the reference ``state_dict`` keys
(``unet.blocks.block0.conv_branch.2.weight``, ...).  Conv weights keep the
JAX package's layouts: submanifold (27, Cin, Cout) in kernel-offset order,
down/inverse (8, Cin, Cout), 1x1 shortcut (Cout, Cin).  The JAX package
scans the identity blocks of a level (blocks.py:254-309) only to keep its
TPU executable small; here they are a plain Python loop.

The numpy ``SeedSequence`` initializers are copied from the JAX package so
``TreeLearn.init(seed)`` gives bit-identical parameters in both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.sparse import DownsampleRulebook, SparseGrid, down_conv, inverse_conv
from ..ops.subm_conv import SubmConvFn
from ..utils.trace import span

BN_EPS = 1e-4       # reference tree_learn.py:34
BN_MOMENTUM = 0.1   # reference tree_learn.py:34


# ---------------------------------------------------------------------------
# numpy initializers (SeedSequence "keys": split = spawn, fold_in = spawn_key)
# ---------------------------------------------------------------------------

def init_bn(channels: int):
    params = {"weight": np.ones((channels,), np.float32),
              "bias": np.zeros((channels,), np.float32)}
    state = {"running_mean": np.zeros((channels,), np.float32),
             "running_var": np.ones((channels,), np.float32)}
    return params, state


def _split(key, num=2):
    return key.spawn(num)


def _fold_in(key, i: int):
    return np.random.SeedSequence(entropy=key.entropy,
                                  spawn_key=key.spawn_key + (int(i),))


def _kaiming_uniform(key, shape, fan_in):
    # torch's default conv/linear init: kaiming uniform with a=sqrt(5)
    bound = math.sqrt(6.0 / ((1 + 5.0) * fan_in)) * math.sqrt(2.0)
    rng = np.random.default_rng(key)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def init_subm_conv(key, kernel_size: int, c_in: int, c_out: int):
    k = kernel_size ** 3
    return {"weight": _kaiming_uniform(key, (k, c_in, c_out), c_in * k)}


def init_down_conv(key, c_in: int, c_out: int):
    return {"weight": _kaiming_uniform(key, (8, c_in, c_out), c_in * 8)}


def init_linear(key, c_in: int, c_out: int, xavier: bool = False,
                normal_std: Optional[float] = None):
    kw, kb = _split(key)
    if normal_std is not None:
        w = (np.random.default_rng(kw).normal(size=(c_out, c_in))
             * normal_std).astype(np.float32)
        b = np.zeros((c_out,), np.float32)
    elif xavier:
        bound = math.sqrt(6.0 / (c_in + c_out))
        w = np.random.default_rng(kw).uniform(
            -bound, bound, (c_out, c_in)).astype(np.float32)
        b = np.zeros((c_out,), np.float32)
    else:
        w = _kaiming_uniform(kw, (c_out, c_in), c_in)
        bound = 1.0 / math.sqrt(c_in)
        b = np.random.default_rng(kb).uniform(
            -bound, bound, (c_out,)).astype(np.float32)
    return {"weight": w, "bias": b}


def init_mlp(key, c_in: int, c_out: int):
    """Xavier on the hidden layer, N(0, 0.01) on the output (blocks.py:20-26)."""
    k0, k1 = _split(key)
    bn_p, bn_s = init_bn(c_in)
    params = {"0": init_linear(k0, c_in, c_in, xavier=True), "1": bn_p,
              "3": init_linear(k1, c_in, c_out, normal_std=0.01)}
    return params, {"1": bn_s}


def init_residual_block(key, c_in: int, c_out: int, kernel_size: int):
    k0, k1, k2 = _split(key, 3)
    bn0_p, bn0_s = init_bn(c_in)
    bn3_p, bn3_s = init_bn(c_out)
    params = {"conv_branch": {
        "0": bn0_p, "2": init_subm_conv(k0, kernel_size, c_in, c_out),
        "3": bn3_p, "5": init_subm_conv(k1, kernel_size, c_out, c_out)}}
    state = {"conv_branch": {"0": bn0_s, "3": bn3_s}}
    if c_in != c_out:
        params["i_branch"] = {"0": {"weight": _kaiming_uniform(
            k2, (c_out, c_in), c_in)}}
    return params, state


def init_ublock(key, n_planes: Sequence[int], block_reps: int,
                kernel_size: int):
    keys = _split(key, 6)
    params, state = {}, {}
    blocks_p, blocks_s = {}, {}
    for i in range(block_reps):
        bp, bs = init_residual_block(_fold_in(keys[0], i), n_planes[0],
                                     n_planes[0], kernel_size)
        blocks_p[f"block{i}"], blocks_s[f"block{i}"] = bp, bs
    params["blocks"], state["blocks"] = blocks_p, blocks_s
    if len(n_planes) > 1:
        bn_p, bn_s = init_bn(n_planes[0])
        params["conv"] = {"0": bn_p, "2": init_down_conv(keys[1], n_planes[0],
                                                         n_planes[1])}
        state["conv"] = {"0": bn_s}
        up, us = init_ublock(keys[2], n_planes[1:], block_reps, kernel_size)
        params["u"], state["u"] = up, us
        bn2_p, bn2_s = init_bn(n_planes[1])
        params["deconv"] = {"0": bn2_p, "2": init_down_conv(
            keys[3], n_planes[1], n_planes[0])}
        state["deconv"] = {"0": bn2_s}
        tail_p, tail_s = {}, {}
        for i in range(block_reps):
            bp, bs = init_residual_block(_fold_in(keys[4], i),
                                         n_planes[0] * (2 - i), n_planes[0],
                                         kernel_size)
            tail_p[f"block{i}"], tail_s[f"block{i}"] = bp, bs
        params["blocks_tail"], state["blocks_tail"] = tail_p, tail_s
    return params, state


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class LevelPlan(NamedTuple):
    """Sparse topology of one U-Net level, shared by all its blocks (the
    spconv ``indice_key`` cache made explicit)."""

    grid: SparseGrid
    rule: torch.Tensor                   # (k^3, V) int32 subm rule
    down: Optional[DownsampleRulebook]   # None at the deepest level


class Weight(nn.Module):
    """A bare weight tensor (sparse conv or 1x1 shortcut)."""

    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))


class BatchNorm(nn.Module):
    """BatchNorm1d over voxel/point rows with eps 1e-4 and momentum 0.1; the
    reference's buffers, and the JAX package's behavior (apply_bn,
    blocks.py:149-176): in training mode float32 statistics over the live
    rows only (``live``, default every row), the biased variance to
    normalise and the unbiased one into ``running_var``; in eval mode, or
    when ``frozen`` (``fixed_modules``), the running statistics.  Scale and
    shift are cast to the activation dtype, the inverse std computed in
    float32 first."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.frozen = False

    def forward(self, x, live: Optional[torch.Tensor] = None):
        if self.training and not self.frozen:
            if live is None:
                live = torch.ones(x.shape[0], dtype=torch.bool,
                                  device=x.device)
            xf = x.float()
            livef = live.float()[:, None]
            cnt = torch.clamp(livef.sum(), min=1.0)
            mean = (xf * livef).sum(0) / cnt
            var = (torch.square(xf - mean) * livef).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * unbiased)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + BN_EPS).to(x.dtype)
        return ((x - mean.to(x.dtype)) * inv
                * self.weight.to(x.dtype) + self.bias.to(x.dtype))


class Linear(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return x @ self.weight.t().to(x.dtype) + self.bias.to(x.dtype)


class MLP(nn.ModuleDict):
    """Linear -> BN -> ReLU -> Linear (torch Sequential indices 0, 1, 3)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__({"0": Linear(c_in, c_in), "1": BatchNorm(c_in),
                          "3": Linear(c_in, c_out)})

    def forward(self, x, live: Optional[torch.Tensor] = None):
        return self["3"](torch.relu(self["1"](self["0"](x), live)))


class ResidualBlock(nn.Module):
    """Pre-activation residual block (reference blocks.py:42-79)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size ** 3
        self.conv_branch = nn.ModuleDict({
            "0": BatchNorm(c_in), "2": Weight(k, c_in, c_out),
            "3": BatchNorm(c_out), "5": Weight(k, c_out, c_out)})
        self.i_branch = (nn.ModuleDict({"0": Weight(c_out, c_in)})
                         if c_in != c_out else None)

    def forward(self, x, rule):
        cb = self.conv_branch
        y = torch.relu(cb["0"](x))
        y = SubmConvFn.apply(y, cb["2"].weight, rule)
        y = torch.relu(cb["3"](y))
        y = SubmConvFn.apply(y, cb["5"].weight, rule)
        if self.i_branch is not None:
            shortcut = x @ self.i_branch["0"].weight.t().to(x.dtype)
        else:
            shortcut = x
        return y + shortcut


class UBlock(nn.Module):
    """Recursive U-Net level (reference blocks.py:81-149)."""

    def __init__(self, n_planes: Sequence[int], block_reps: int,
                 kernel_size: int = 3):
        super().__init__()
        c0 = n_planes[0]
        self.blocks = nn.ModuleDict({
            f"block{i}": ResidualBlock(c0, c0, kernel_size)
            for i in range(block_reps)})
        self.u = None
        if len(n_planes) > 1:
            c1 = n_planes[1]
            self.conv = nn.ModuleDict({"0": BatchNorm(c0),
                                       "2": Weight(8, c0, c1)})
            self.u = UBlock(n_planes[1:], block_reps, kernel_size)
            self.deconv = nn.ModuleDict({"0": BatchNorm(c1),
                                         "2": Weight(8, c1, c0)})
            self.blocks_tail = nn.ModuleDict({
                f"block{i}": ResidualBlock(c0 * (2 - i), c0, kernel_size)
                for i in range(block_reps)})

    def forward(self, x, plans, level: int = 0):
        """The level's own work runs under the span ``unet.L<level>`` (two
        spans of that name, around the recursion into the next level)."""
        plan = plans[level]
        with span(f"unet.L{level}"):
            for blk in self.blocks.values():
                x = blk(x, plan.rule)
            if self.u is None:
                return x
            identity = x
            y = torch.relu(self.conv["0"](x))
            y = down_conv(y, self.conv["2"].weight, plan.down)
        y = self.u(y, plans, level + 1)
        with span(f"unet.L{level}"):
            y = torch.relu(self.deconv["0"](y))
            y = inverse_conv(y, self.deconv["2"].weight, plan.down)
            x = torch.cat([identity, y], dim=1)
            for blk in self.blocks_tail.values():
                x = blk(x, plan.rule)
        return x
