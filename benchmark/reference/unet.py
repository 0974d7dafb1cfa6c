"""Plain forward of the TreeLearn network (github.com/ecker-lab/TreeLearn,
tree_learn/model/tree_learn.py and blocks.py) in float32 PyTorch: gathers
and matrix products per kernel offset, no kernels, no caches.

Input submanifold conv (4 -> C, k = 3) on a voxel feature of ones; a U-Net
of ``num_blocks`` levels with C (l + 1) channels, two pre-activation
residual blocks (BN, ReLU, conv, BN, ReLU, conv, plus the identity or a
1x1 shortcut) at the head and at the tail of each level, the tail's first
block taking the concatenated skip; stride-2 k = 2 down and inverse convs
between levels behind BN and ReLU; BN and ReLU, the voxel's feature on
each of its points, and two heads Linear(C, C), BN, ReLU, Linear(C, out).
BatchNorm uses eps 1e-4, batch statistics over the live rows in training
(biased variance) and the running statistics otherwise.

``quant="fp8"`` computes in float8 what the bf16 configuration computes in
bf16: every product's operands (:class:`Fp8Matmul`) and every op's output
(:class:`Fp8Round`) in e4m3, the gradients in e5m2, each under one scale
per tensor, products and BatchNorm statistics summed in float32.  It is the
control of the bf16 configuration.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

BN_EPS = 1e-4


def param_spec(channels: int = 32, num_blocks: int = 7, in_channels: int = 4,
               n_offsets: int = 27) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind, fan_in) for every parameter and buffer, under
    the reference's state_dict names."""
    spec = OrderedDict()

    def bn(pre, c):
        spec[f"{pre}.weight"] = ((c,), "bn_weight", c)
        spec[f"{pre}.bias"] = ((c,), "bn_bias", c)
        spec[f"{pre}.running_mean"] = ((c,), "bn_mean", c)
        spec[f"{pre}.running_var"] = ((c,), "bn_var", c)
        spec[f"{pre}.num_batches_tracked"] = ((), "count", 0)

    def res(pre, cin, cout):
        bn(f"{pre}.conv_branch.0", cin)
        spec[f"{pre}.conv_branch.2.weight"] = ((n_offsets, cin, cout), "conv",
                                               cin * n_offsets)
        bn(f"{pre}.conv_branch.3", cout)
        spec[f"{pre}.conv_branch.5.weight"] = ((n_offsets, cout, cout), "conv",
                                               cout * n_offsets)
        if cin != cout:
            spec[f"{pre}.i_branch.0.weight"] = ((cout, cin), "conv", cin)

    def ublock(pre, planes):
        c0 = planes[0]
        for i in range(2):
            res(f"{pre}.blocks.block{i}", c0, c0)
        if len(planes) > 1:
            c1 = planes[1]
            bn(f"{pre}.conv.0", c0)
            spec[f"{pre}.conv.2.weight"] = ((8, c0, c1), "conv", c0 * 8)
            ublock(f"{pre}.u", planes[1:])
            bn(f"{pre}.deconv.0", c1)
            spec[f"{pre}.deconv.2.weight"] = ((8, c1, c0), "conv", c1 * 8)
            for i in range(2):
                res(f"{pre}.blocks_tail.block{i}", c0 * (2 - i), c0)

    def mlp(pre, c, out):
        spec[f"{pre}.0.weight"] = ((c, c), "xavier", c + c)
        spec[f"{pre}.0.bias"] = ((c,), "bias", c)
        bn(f"{pre}.1", c)
        spec[f"{pre}.3.weight"] = ((out, c), "head", c)
        spec[f"{pre}.3.bias"] = ((out,), "bias", c)

    spec["input_conv.0.weight"] = ((n_offsets, in_channels, channels), "conv",
                                   in_channels * n_offsets)
    ublock("unet", [channels * (i + 1) for i in range(num_blocks)])
    bn("output_layer.0", channels)
    mlp("semantic_linear", channels, 2)
    mlp("offset_linear", channels, 3)
    return spec


def make_weights(seed: int, device, channels: int = 32, num_blocks: int = 7):
    """The network's parameters and BatchNorm buffers from ``seed``: one
    draw of uniform numbers on ``device`` by a seeded generator, cut into
    the leaves and scaled as each kind asks (kaiming-uniform convs,
    xavier hidden layers, 0.01-wide output layers, BatchNorm scales and
    statistics near 1 and 0)."""
    spec = param_spec(channels, num_blocks)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    total = sum(int(torch.Size(s).numel()) for s, kind, _ in spec.values()
                if kind != "count")
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, pos = OrderedDict(), 0
    for name, (shape, kind, fan) in spec.items():
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = int(torch.Size(shape).numel())
        x = u[pos:pos + n].reshape(shape)
        pos += n
        if kind == "conv":
            x = x * (2.0 / fan) ** 0.5
        elif kind == "xavier":
            x = x * (6.0 / fan) ** 0.5
        elif kind == "head":
            x = x * 0.01 * 3.0 ** 0.5
        elif kind == "bias":
            x = x * 0.01
        elif kind in ("bn_weight", "bn_var"):
            x = 1.0 + 0.2 * x
        else:   # bn_bias, bn_mean
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 type under one scale for the whole tensor."""
    amax = x.abs().max()
    top = torch.finfo(dtype).max
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(torch.float32) * scale


class Fp8Round(torch.autograd.Function):
    """A tensor stored in float8: e4m3 on the way forward, its gradient e5m2
    on the way back, each under one scale per tensor."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x.detach())

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Fp8Matmul(torch.autograd.Function):
    """x @ w with both operands in float8 e4m3 and, in the backward, the
    output gradient in float8 e5m2 (each under one scale per tensor), the
    products summed in float32: the float8 recipe one step below bf16."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x.detach()), fp8_round(w.detach())
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.t() @ gq


class Net:
    """The forward over one :class:`reference.sparse.Topology`."""

    def __init__(self, params: dict, topo, num_blocks: int, training: bool,
                 quant: str = "none"):
        self.p = params
        self.topo = topo
        self.L = num_blocks
        self.training = training
        self.fp8 = quant == "fp8"
        self._pairs = {}

    def mm(self, x, w):
        return Fp8Matmul.apply(x, w) if self.fp8 else x @ w

    def r(self, x):
        """An op's output as the precision under test stores it."""
        return Fp8Round.apply(x) if self.fp8 else x

    def bn(self, x, pre, live=None):
        p = self.p
        if self.training:
            if live is None:
                mean = x.mean(0)
                var = ((x - mean) ** 2).mean(0)
            else:
                lf = live.float()[:, None]
                cnt = lf.sum().clamp(min=1.0)
                mean = (x * lf).sum(0) / cnt
                var = (((x - mean) ** 2) * lf).sum(0) / cnt
        else:
            mean, var = p[f"{pre}.running_mean"], p[f"{pre}.running_var"]
        return self.r((x - mean) * torch.rsqrt(var + BN_EPS)
                      * p[f"{pre}.weight"] + p[f"{pre}.bias"])

    def pairs(self, key, mask_fn, n):
        """[(output rows, input rows)] of each of ``n`` offsets or corners,
        worked out once per level."""
        if key not in self._pairs:
            out = []
            for k in range(n):
                rows = torch.nonzero(mask_fn(k)).squeeze(1)
                out.append(rows)
            self._pairs[key] = out
        return self._pairs[key]

    def conv(self, x, w, rule):
        out = x.new_zeros((rule.shape[1], w.shape[2]))
        rows_k = self.pairs(("rule", id(rule)), lambda k: rule[k] >= 0,
                            rule.shape[0])
        for k, rows in enumerate(rows_k):
            if rows.numel():
                out = out.index_add(0, rows, self.mm(x[rule[k][rows]], w[k]))
        return self.r(out)

    def down(self, x, w, lv, n_out):
        out = x.new_zeros((n_out, w.shape[2]))
        rows_c = self.pairs(("corner", id(lv.parent)),
                            lambda c: (lv.parent >= 0) & (lv.corner == c), 8)
        for c, rows in enumerate(rows_c):
            if rows.numel():
                out = out.index_add(0, lv.parent[rows],
                                    self.mm(x[rows], w[c]))
        return self.r(out)

    def up(self, y, w, lv):
        out = y.new_zeros((lv.parent.shape[0], w.shape[2]))
        rows_c = self.pairs(("corner", id(lv.parent)),
                            lambda c: (lv.parent >= 0) & (lv.corner == c), 8)
        for c, rows in enumerate(rows_c):
            if rows.numel():
                out = out.index_copy(0, rows,
                                     self.mm(y[lv.parent[rows]], w[c]))
        return self.r(out)

    def res(self, x, pre, rule):
        p = self.p
        y = torch.relu(self.bn(x, f"{pre}.conv_branch.0"))
        y = self.conv(y, p[f"{pre}.conv_branch.2.weight"], rule)
        y = torch.relu(self.bn(y, f"{pre}.conv_branch.3"))
        y = self.conv(y, p[f"{pre}.conv_branch.5.weight"], rule)
        wi = p.get(f"{pre}.i_branch.0.weight")
        return self.r(y + (x if wi is None else self.r(self.mm(x, wi.t()))))

    def ublock(self, x, pre, lvl):
        lv = self.topo.levels[lvl]
        for i in range(2):
            x = self.res(x, f"{pre}.blocks.block{i}", lv.rule)
        if lvl == self.L - 1:
            return x
        p = self.p
        n_next = self.topo.levels[lvl + 1].keys.shape[0]
        y = torch.relu(self.bn(x, f"{pre}.conv.0"))
        y = self.down(y, p[f"{pre}.conv.2.weight"], lv, n_next)
        y = self.ublock(y, f"{pre}.u", lvl + 1)
        y = torch.relu(self.bn(y, f"{pre}.deconv.0"))
        y = self.up(y, p[f"{pre}.deconv.2.weight"], lv)
        x = torch.cat([x, y], 1)
        for i in range(2):
            x = self.res(x, f"{pre}.blocks_tail.block{i}", lv.rule)
        return x

    def mlp(self, x, pre, live):
        p = self.p
        h = self.r(self.mm(x, p[f"{pre}.0.weight"].t()) + p[f"{pre}.0.bias"])
        h = torch.relu(self.bn(h, f"{pre}.1", live))
        return self.r(self.mm(h, p[f"{pre}.3.weight"].t())
                      + p[f"{pre}.3.bias"])

    def forward(self, valid: torch.Tensor):
        """(semantic logits (N, 2), offsets (N, 3)) of every point; invalid
        points read zero features."""
        lv0 = self.topo.levels[0]
        x = torch.ones((lv0.keys.shape[0], 4), device=lv0.keys.device)
        x = self.conv(x, self.p["input_conv.0.weight"], lv0.rule)
        x = self.ublock(x, "unet", 0)
        x = torch.relu(self.bn(x, "output_layer.0"))
        v2p = self.topo.v2p
        feats = torch.where((v2p >= 0)[:, None], x[v2p.clamp(min=0)],
                            torch.zeros((), device=x.device))
        return (self.mlp(feats, "semantic_linear", valid),
                self.mlp(feats, "offset_linear", valid))
