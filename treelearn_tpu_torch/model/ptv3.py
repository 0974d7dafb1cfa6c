"""Point Transformer V3 as the port's second backbone (Wu et al., "Point
Transformer V3: Simpler, Faster, Stronger", CVPR 2024, arXiv:2312.10035;
Pointcept ``pointcept/models/point_transformer_v3/
point_transformer_v3m1_base.py``, widths of
``configs/scannet/semseg-pt-v3m1-0-base.py``).

The tokens are the model's voxels (ops/voxelize.py), kept in sorted-key
order at every stage so that the submanifold convs (kernels 1-3) read them
directly.  Layers, as Pointcept writes them:

* embedding: SubMConv3d k = 5 (no bias), BatchNorm (eps 1e-3, momentum
  0.01), GELU;
* block (pre-norm): ``x += LN(Linear(SubMConv3d_k3_bias(x)))`` (xCPE, one
  k = 3 rule a stage, shared by the stage's encoder and decoder blocks),
  ``x += DropPath(Attn(LN1(x)))``, ``x += DropPath(MLP(LN2(x)))`` with MLP
  Linear(C, 4C), GELU, Linear(4C, C); DropPath per token, its rates a
  linspace 0 -> ``drop_path`` over the encoder's blocks and over the
  decoder's, the decoder's reversed inside each stage;
* serialized attention: qkv = Linear(C, 3C), gathered in the block's order
  (block i of a stage takes order ``i % 4``), padded into patches of K =
  min(patch size, fewest tokens of a batch element) (ops/serialize.py;
  the rule of Pointcept's path without flash attention, whose flash path
  keeps K and runs a shorter element as one shorter patch), the
  pad rows repeating real rows of the element's previous patch, softmax
  attention in each patch (heads of C / H channels, scale ``d ** -0.5``),
  the pad rows dropped, scattered back, Linear(C, C);
* pooling (stride 2): the 2x2x2 parent cells, ``feat = segment_max(
  Linear(x))``, BatchNorm, GELU; a pooled stage's grid is ``grid >> 1`` in
  a spatial shape halved rounding up, so no token is dropped at the edge;
* unpooling: ``BN GELU(Linear(skip)) + BN GELU(Linear(x))[parent]``.

Every serialization (the embedding's and each pooling's) permutes the four
orders at random when ``shuffle_orders``, in training and in eval, as
Pointcept does; DropPath draws in training only.  Both draw from a
``torch.Generator`` the model owns, seeded from ``seed``; with
``record_draws`` set, each forward's draws are kept in ``draws`` in drawing
order (``("perm", list)``, and ``("keep", (N,) bool, (N, 4) (b, x, y, z))``
with the grid coordinates of the tokens the mask is in the order of), so
that a reference can follow the same forward.

Precision (as ``torch.autocast(bfloat16)`` would place it): convs, linears
and attention take ``compute_dtype`` inputs and sum in float32; LayerNorm,
BatchNorm, softmax statistics and the residual stream are float32.
Attention runs on ``scaled_dot_product_attention`` with one backend forced
(flash on a card in bf16 / fp16, memory-efficient on a card in float32, the
math backend on the CPU), so that a fallback raises instead of running.

Host reads, by design: the serialization depth (once a forward), the token
count of each pooled stage (the unique parent cells), and each stage's
tokens per batch element (the patch size K and the padding); the order
permutations are read with them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hashing import encode_keys, sort_unique
from ..ops.rulebook import subm_rulebook
from ..ops.serialize import ORDERS, depth_of, orders, patch_layout
from ..ops.sparse import SparseGrid, build_subm_rulebook, grid_from_sorted_keys
from ..ops.subm_conv import SubmConvFn
from ..utils.trace import count, span
from .blocks import _kaiming_uniform, _split

BN_EPS = 1e-3
BN_MOMENTUM = 0.01
LN_EPS = 1e-5
STEM_KERNEL = 5

# Pointcept's PT-v3m1 base, configs/scannet/semseg-pt-v3m1-0-base.py
PUBLISHED = {
    "order": ORDERS, "stride": (2, 2, 2, 2),
    "enc_depths": (2, 2, 2, 6, 2), "enc_channels": (32, 64, 128, 256, 512),
    "enc_num_head": (2, 4, 8, 16, 32),
    "enc_patch_size": (1024, 1024, 1024, 1024, 1024),
    "dec_depths": (2, 2, 2, 2), "dec_channels": (64, 64, 128, 256),
    "dec_num_head": (4, 4, 8, 16), "dec_patch_size": (1024, 1024, 1024, 1024),
    "mlp_ratio": 4, "qkv_bias": True, "qk_scale": None, "attn_drop": 0.0,
    "proj_drop": 0.0, "drop_path": 0.3, "shuffle_orders": True,
    "pre_norm": True, "enable_rpe": False, "enable_flash": True,
    "upcast_attention": False, "upcast_softmax": False, "cls_mode": False,
    "pdnorm_bn": False, "pdnorm_ln": False,
}
# published keys this port implements only at their published value
_FIXED = {"qk_scale": None, "attn_drop": 0.0, "proj_drop": 0.0,
          "pre_norm": True, "enable_rpe": False, "enable_flash": True,
          "upcast_attention": False, "upcast_softmax": False,
          "cls_mode": False, "pdnorm_bn": False, "pdnorm_ln": False}
# published keys with no effect here (Pointcept's other PDNorm switches)
_IGNORED = ("pdnorm_decouple", "pdnorm_adaptive", "pdnorm_affine",
            "pdnorm_conditions", "type")


def linear(x: torch.Tensor, m: nn.Linear, dtype) -> torch.Tensor:
    """``m(x)`` with input, weight and bias in ``dtype`` (float32 sums)."""
    return F.linear(x.to(dtype), m.weight.to(dtype),
                    None if m.bias is None else m.bias.to(dtype))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps)


def attention(q, k, v, scale: float) -> torch.Tensor:
    """Softmax attention of (P, H, K, d) patches on one forced backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not q.is_cuda:
        backend = SDPBackend.MATH
    elif q.dtype in (torch.float16, torch.bfloat16):
        backend = SDPBackend.FLASH_ATTENTION
    else:
        backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


class Stage:
    """The token set of one stage: its grid (rows in sorted-key order), the
    batch element and serialization of each token, the xCPE rule, and the
    patch layouts of its attention, built once and shared by the stage's
    encoder and decoder blocks.  ``perm`` (a device tensor) is the
    permutation of the model's orders this stage's serialization took."""

    def __init__(self, index: int, grid: SparseGrid, depth: int,
                 names: Sequence[str], n_elems: int,
                 cluster: Optional[torch.Tensor] = None, perm=None):
        self.index = index
        self.grid = grid
        self.batch = grid.coords[:, 0].long()
        self.depth = depth
        self.names = tuple(names)
        self.n_elems = n_elems
        self.cluster = cluster          # previous stage's token -> this one
        self.perm = perm
        self.order = self.inverse = None
        self.rule = None
        self._layouts: Dict[int, tuple] = {}
        self._gathers: Dict[tuple, tuple] = {}

    @property
    def n(self) -> int:
        return self.grid.n_active

    def serialize(self, permute):
        """Codes, orders and inverses, the orders permuted once more by
        ``permute`` (the permutations compose, as Pointcept's do)."""
        with span("ptv3.serialize"):
            self.perm = permute(self.perm)
            xyz = self.grid.coords[:, 1:].long()
            _, self.order, self.inverse = orders(xyz, self.batch, self.depth,
                                                 self.names, self.perm)

    def layout(self, patch_size: int):
        if patch_size not in self._layouts:
            counts = torch.bincount(self.batch,
                                    minlength=self.n_elems).tolist()
            lay = patch_layout(counts, patch_size, self.batch.device)
            s = self.index
            count(f"ptv3.tokens.s{s}", self.n)
            count(f"ptv3.pad_rows.s{s}", lay.pad_rows)
            count(f"ptv3.patches.s{s}", lay.n_pad // lay.k)
            self._layouts[patch_size] = lay
        return self._layouts[patch_size]

    def gathers(self, patch_size: int, order_index: int):
        """(padded row -> token, token -> padded row) of one order."""
        key = (patch_size, order_index)
        if key not in self._gathers:
            lay = self.layout(patch_size)
            self._gathers[key] = (self.order[order_index][lay.pad_src],
                                  lay.unpad[self.inverse[order_index]])
        return self._gathers[key]


class XCPE(nn.Module):
    """SubMConv3d k = 3 with bias, Linear, LayerNorm."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.ParameterDict({
            "weight": nn.Parameter(torch.zeros(27, c, c)),
            "bias": nn.Parameter(torch.zeros(c))})
        self.linear = nn.Linear(c, c)
        self.norm = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x, stage: Stage, dtype):
        h = SubmConvFn.apply(x.to(dtype).contiguous(), self.conv["weight"],
                             stage.rule)
        h = h + self.conv["bias"].to(h.dtype)
        return layer_norm(linear(h, self.linear, dtype), self.norm)


class SerializedAttention(nn.Module):
    def __init__(self, c: int, heads: int, patch_size: int, order_index: int,
                 qkv_bias: bool = True):
        super().__init__()
        if c % heads:
            raise ValueError(f"{c} channels do not split into {heads} heads")
        self.heads, self.patch_size = heads, int(patch_size)
        self.order_index = order_index
        self.scale = (c // heads) ** -0.5
        self.qkv = nn.Linear(c, 3 * c, bias=qkv_bias)
        self.proj = nn.Linear(c, c)

    def forward(self, x, stage: Stage, dtype):
        c = x.shape[1]
        h, d = self.heads, c // self.heads
        lay = stage.layout(self.patch_size)
        g_in, g_out = stage.gathers(self.patch_size,
                                    self.order_index % len(stage.names))
        qkv = linear(x, self.qkv, dtype)[g_in]
        q, k, v = qkv.view(lay.n_pad // lay.k, lay.k, 3, h, d).permute(
            2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, self.scale)
        o = o.transpose(1, 2).reshape(lay.n_pad, c)[g_out]
        return linear(o, self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, c: int, ratio: float):
        super().__init__()
        hidden = int(c * ratio)
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)

    def forward(self, x, dtype):
        return linear(F.gelu(linear(x, self.fc1, dtype)), self.fc2, dtype)


class Block(nn.Module):
    def __init__(self, c: int, heads: int, patch_size: int, order_index: int,
                 mlp_ratio: float, qkv_bias: bool, drop_path: float):
        super().__init__()
        self.cpe = XCPE(c)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = SerializedAttention(c, heads, patch_size, order_index,
                                        qkv_bias)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = Mlp(c, mlp_ratio)
        self.drop_path = float(drop_path)

    def forward(self, x, stage: Stage, dtype, keep):
        with span("ptv3.cpe"):
            x = x + self.cpe(x, stage, dtype)
        with span("ptv3.attn"):
            x = x + keep(self.attn(layer_norm(x, self.norm1), stage, dtype),
                         self.drop_path, stage)
        with span("ptv3.mlp"):
            x = x + keep(self.mlp(layer_norm(x, self.norm2), dtype),
                         self.drop_path, stage)
        return x


class Pooling(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.proj = nn.Linear(c_in, c_out)
        self.norm = nn.BatchNorm1d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x, stage: Stage, dtype):
        h = linear(x, self.proj, dtype)
        idx = stage.cluster[:, None].expand(-1, h.shape[1])
        pooled = h.new_zeros((stage.n, h.shape[1])).scatter_reduce(
            0, idx, h, "amax", include_self=False)
        return F.gelu(self.norm(pooled.float()))


class Unpooling(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_out: int):
        super().__init__()
        self.proj = nn.Linear(c_in, c_out)
        self.proj_norm = nn.BatchNorm1d(c_out, eps=BN_EPS,
                                        momentum=BN_MOMENTUM)
        self.skip = nn.Linear(c_skip, c_out)
        self.skip_norm = nn.BatchNorm1d(c_out, eps=BN_EPS,
                                        momentum=BN_MOMENTUM)

    def forward(self, x, skip, cluster, dtype):
        up = F.gelu(self.proj_norm(linear(x, self.proj, dtype).float()))
        return F.gelu(self.skip_norm(linear(skip, self.skip, dtype).float())
                      ) + up[cluster]


class Embedding(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.stem = nn.ParameterDict({"weight": nn.Parameter(
            torch.zeros(STEM_KERNEL ** 3, c_in, c_out))})
        self.norm = nn.BatchNorm1d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, feats, rule, dtype):
        h = SubmConvFn.apply(feats.to(dtype).contiguous(),
                             self.stem["weight"], rule)
        return F.gelu(self.norm(h.float()))


def drop_path_rates(depths: Sequence[int], rate: float) -> List[List[float]]:
    """Per stage, the DropPath rate of each block: a linspace 0 -> ``rate``
    over all blocks (as float32, as Pointcept computes it)."""
    r = [float(v) for v in torch.linspace(0, rate, int(sum(depths)))]
    out, pos = [], 0
    for d in depths:
        out.append(r[pos:pos + d])
        pos += d
    return out


class PTv3(nn.Module):
    """The encoder-decoder; ``forward`` maps voxel features on the voxel
    grid to ``dec_channels[0]`` float32 features a voxel."""

    def __init__(self, in_channels: int, order=ORDERS, stride=(2, 2, 2, 2),
                 enc_depths=(2, 2, 2, 6, 2),
                 enc_channels=(32, 64, 128, 256, 512),
                 enc_num_head=(2, 4, 8, 16, 32),
                 enc_patch_size=(1024, 1024, 1024, 1024, 1024),
                 dec_depths=(2, 2, 2, 2), dec_channels=(64, 64, 128, 256),
                 dec_num_head=(4, 4, 8, 16),
                 dec_patch_size=(1024, 1024, 1024, 1024), mlp_ratio=4,
                 qkv_bias=True, drop_path=0.3, shuffle_orders=True,
                 seed: int = 0, **fixed):
        super().__init__()
        for k, v in fixed.items():
            if k in _IGNORED:
                continue
            if k not in _FIXED:
                raise ValueError(f"ptv3: unknown key {k!r}")
            if v != _FIXED[k]:
                raise ValueError(f"ptv3: {k}={v!r} is not implemented "
                                 f"(only {_FIXED[k]!r})")
        n = len(enc_depths)
        if not (len(enc_channels) == len(enc_num_head) == len(enc_patch_size)
                == n and len(stride) == n - 1 and len(dec_depths) == n - 1
                and len(dec_channels) == len(dec_num_head)
                == len(dec_patch_size) == n - 1):
            raise ValueError("ptv3: stage lists of unequal length")
        if any(int(s) != 2 for s in stride):
            raise ValueError(f"ptv3: stride {stride}: only 2 is implemented")
        if any(o not in ORDERS for o in order):
            raise ValueError(f"ptv3: order {order}")
        self.order = tuple(order)
        self.shuffle_orders = bool(shuffle_orders)
        self.enc_channels = tuple(int(c) for c in enc_channels)
        self.dec_channels = tuple(int(c) for c in dec_channels)
        self.out_channels = (self.dec_channels[0] if self.dec_channels
                             else self.enc_channels[-1])
        self.seed = int(seed)
        self.record_draws = False
        self.draws: list = []
        self._gens: Dict[str, torch.Generator] = {}
        self._device = None

        self.embedding = Embedding(in_channels, self.enc_channels[0])
        enc_dp = drop_path_rates(enc_depths, drop_path)
        self.enc = nn.ModuleList()
        for s in range(n):
            stage = nn.Module()
            if s > 0:
                stage.down = Pooling(self.enc_channels[s - 1],
                                     self.enc_channels[s])
            stage.blocks = nn.ModuleList([
                Block(self.enc_channels[s], enc_num_head[s],
                      enc_patch_size[s], i, mlp_ratio, qkv_bias,
                      enc_dp[s][i]) for i in range(enc_depths[s])])
            self.enc.append(stage)
        dec_dp = [list(reversed(r)) for r in drop_path_rates(dec_depths,
                                                             drop_path)]
        chans = list(self.dec_channels) + [self.enc_channels[-1]]
        self.dec = nn.ModuleList()
        for s in range(n - 1):
            stage = nn.Module()
            stage.up = Unpooling(chans[s + 1], self.enc_channels[s],
                                 chans[s])
            stage.blocks = nn.ModuleList([
                Block(chans[s], dec_num_head[s], dec_patch_size[s], i,
                      mlp_ratio, qkv_bias, dec_dp[s][i])
                for i in range(dec_depths[s])])
            self.dec.append(stage)

    # -- randomness ---------------------------------------------------------

    def generator(self, device) -> torch.Generator:
        """The model's generator on ``device``, seeded from ``seed`` at its
        first use there."""
        key = str(torch.device(device))
        if key not in self._gens:
            g = torch.Generator(device=device)
            g.manual_seed(self.seed)
            self._gens[key] = g
        return self._gens[key]

    def _permute(self, prev):
        """``prev`` (a device permutation of the orders, or None for none)
        permuted once more by a draw; None without ``shuffle_orders``."""
        if not self.shuffle_orders:
            return prev
        g = self.generator(self._device)
        perm = torch.randperm(len(self.order), generator=g, device=g.device)
        if self.record_draws:
            self.draws.append(("perm", perm.tolist()))
        return perm if prev is None else prev[perm]

    def _keeper(self, device):
        def keep(h, rate, stage):
            if not self.training or rate <= 0.0:
                return h
            g = self.generator(device)
            mask = torch.empty((h.shape[0], 1), device=h.device).bernoulli_(
                1.0 - rate, generator=g)
            if self.record_draws:
                self.draws.append(("keep", mask[:, 0].bool(),
                                   stage.grid.coords))
            return h.float() * (mask / (1.0 - rate))
        return keep

    # -- structure ----------------------------------------------------------

    def _pool_stage(self, prev: Stage) -> Stage:
        """The next stage's tokens: the parent cells of ``prev``'s."""
        c = prev.grid.coords
        shape = tuple(-(-int(s) // 2) for s in prev.grid.spatial_shape)
        parent = torch.cat([c[:, :1], c[:, 1:] >> 1], 1)
        keys, cluster = sort_unique(encode_keys(parent, shape))
        grid = grid_from_sorted_keys(keys, shape)
        if prev.depth <= 1:
            raise ValueError("ptv3: more poolings than the grid's depth")
        st = Stage(prev.index + 1, grid, prev.depth - 1, prev.names,
                   prev.n_elems, cluster, prev.perm)
        st.serialize(self._permute)
        with span("ptv3.rulebook"):
            st.rule = subm_rulebook(grid)
        return st

    def forward(self, feats: torch.Tensor, grid: SparseGrid, n_elems: int,
                dtype=torch.float32):
        """feats (V, in_channels) on ``grid``'s V voxels -> ((V,
        out_channels) float32, [Stage] of every stage)."""
        if self.record_draws:
            self.draws = []
        self._device = feats.device
        keep = self._keeper(feats.device)
        with span("ptv3.embed"):
            with span("ptv3.serialize"):
                depth = depth_of(grid.coords[:, 1:])
            st = Stage(0, grid, depth, self.order, n_elems)
            st.serialize(self._permute)
            with span("ptv3.rulebook"):
                st.rule = subm_rulebook(grid)
                stem_rule = build_subm_rulebook(grid, STEM_KERNEL)
            x = self.embedding(feats, stem_rule, dtype)
        stages, skips = [st], []
        for s, enc in enumerate(self.enc):
            with span(f"ptv3.enc{s}"):
                if s > 0:
                    with span("ptv3.pool"):
                        st = self._pool_stage(stages[-1])
                        stages.append(st)
                        x = enc.down(x, st, dtype)
                for blk in enc.blocks:
                    x = blk(x, st, dtype, keep)
            skips.append(x)
        for s in reversed(range(len(self.dec))):
            dec = self.dec[s]
            with span(f"ptv3.dec{s}"):
                with span("ptv3.unpool"):
                    x = dec.up(x, skips[s], stages[s + 1].cluster, dtype)
                for blk in dec.blocks:
                    x = blk(x, stages[s], dtype, keep)
        return x, stages


# ---------------------------------------------------------------------------
# numpy initializer (SeedSequence, as the U-Net's)
# ---------------------------------------------------------------------------

def _fan_in(w: torch.Tensor) -> int:
    """Inputs a unit of a conv (K, Cin, Cout) or linear (Cout, Cin) sums."""
    return int(w.shape[0] * w.shape[1]) if w.dim() == 3 else int(w.shape[1])


def init_numpy(model: PTv3, seed) -> "Dict[str, np.ndarray]":
    """Parameters and BatchNorm buffers of ``model`` (names as its
    ``state_dict``) from a ``SeedSequence``: convs and linears as PyTorch
    and spconv initialise them (kaiming-uniform weights, biases uniform in
    +-1 / sqrt(fan_in)), LayerNorm and BatchNorm scales 1 and shifts 0, the
    running statistics 0 and 1.  One child sequence a tensor, in
    ``state_dict`` order."""
    ss = (seed if isinstance(seed, np.random.SeedSequence)
          else np.random.SeedSequence(int(seed)))
    sd = model.state_dict()
    # the fan-in of each conv and linear, by its module's name
    fan = {n.rsplit(".", 1)[0]: _fan_in(t) for n, t in sd.items()
           if n.endswith(".weight") and t.dim() >= 2}
    out = {}
    for key, (name, t) in zip(_split(ss, len(sd)), sd.items()):
        shape, owner = tuple(t.shape), name.rsplit(".", 1)[0]
        if name.endswith("num_batches_tracked"):
            out[name] = np.zeros((), np.int64)
        elif name.endswith("running_var"):
            out[name] = np.ones(shape, np.float32)
        elif t.dim() >= 2:
            out[name] = _kaiming_uniform(key, shape, fan[owner])
        elif name.endswith(".bias") and owner in fan:
            bound = 1.0 / math.sqrt(fan[owner])
            out[name] = np.random.default_rng(key).uniform(
                -bound, bound, shape).astype(np.float32)
        elif name.endswith(".weight"):
            out[name] = np.ones(shape, np.float32)
        else:       # norm shifts, running means
            out[name] = np.zeros(shape, np.float32)
    return out
