"""Plain Point Transformer V3 with TreeLearn's heads, in float32 PyTorch:
the benchmark's copy of the tests' reference (``tests/reference_ptv3.py``),
which the training cell ``train_ptv3`` holds the program to.  It imports
nothing of the port and no JAX.

What this copy adds, at the end: :class:`CardForward`, which computes the
attention in blocks of patches and recomputes each block in the backward
(``torch.utils.checkpoint``) so that the published widths at the cell's
size fit on the card, and computes in float8 with ``quant="fp8"`` (the
control: every product's operands e4m3 and its gradient e5m2 under one
scale a tensor, as ``reference/unet.py`` does for the U-Net; products,
normalisations and the residual stream float32); :func:`param_spec` and
:func:`make_weights` (the weights from the seed); :func:`train_steps`, the
first training steps as ``reference/training.py`` follows the U-Net's.

PTv3: Wu et al., "Point Transformer V3: Simpler, Faster, Stronger", CVPR
2024 (arXiv:2312.10035); Pointcept's ``point_transformer_v3m1_base.py`` and
``serialization/{default,z_order,hilbert}.py``.  Written from the equations
as Pointcept states them, literally where it can be:

* voxels: a point's voxel is floor((p - min of its batch element) *
  float32(1 / voxel_size)), clamped into the spatial shape; a voxel's
  feature is all ones (``use_feats`` and ``use_coords`` off; the only case
  written here); tokens are the voxels;
* serialization: ``depth`` = bit length of the largest grid coordinate;
  code = ``batch << 3 depth | enc(grid)``; z-order is OCNN's ``xyz2key``
  (a bit loop, x the most significant of each triple); Hilbert is the
  bit-array form of Skilling's algorithm that Pointcept's ``hilbert.py``
  carries (invert / exchange per bit and dimension, then Gray to binary
  over the interleaved bits); "-trans" swaps x and y; per order the argsort
  and its inverse, then the given permutation of the orders;
* pooling: clusters of ``code[0] >> 3``, ``feat = segment_max(proj(x))``,
  ``grid = grid[head] >> 1``, the codes ``>> 3`` of a cluster's head
  (carried, not encoded again), argsort, inverse, the given permutation,
  BatchNorm, GELU;
* attention: Pointcept's ``get_padding_and_inverse`` loop, with the patch
  size K = min(patch size, fewest tokens of a batch element), explicit
  ``softmax(q k^T d^-0.5) v`` per patch;
* xCPE and the stem: a plain gather conv over the submanifold neighbours
  (weights (k^3, Cin, Cout), offsets dx slowest, dz fastest);
* DropPath: the given keep masks (each with the (b, x, y, z) of its
  tokens, since the program may hold them in another order), scaled by
  1 / keep (timm's ``drop_path`` on an (N, C) tensor);
* heads: TreeLearn's MLP (Linear, BatchNorm eps 1e-4 over the valid points
  in training, ReLU, Linear) on each point's voxel feature, zero for
  invalid points.

Departures from Pointcept, and what is not verified:

* the Hilbert axis convention (x as Skilling's first axis, the most
  significant bit of each triple) follows the algorithm as written here;
  it is not checked against Pointcept's own codes, which are not at hand;
* ``depth`` is the bit length of the largest coordinate, as this port's
  specification states it (Pointcept may take that of the largest + 1);
* K = min(patch size, fewest tokens of an element) for every stage: the
  rule of Pointcept's non-flash path; its flash path keeps K = 1024 and
  leaves an element shorter than K as one shorter patch;
* the order permutations and keep masks are inputs (Pointcept draws them
  with ``torch.randperm`` and ``bernoulli_``);
* the pooled ``coord`` (a segment mean) is not computed: nothing reads it
  without relative position encoding;
* the residual stream and every operation are float32 here (the program
  under test runs bf16 operands where its precision says so).
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
STEM_K = 5
BN_EPS = 1e-3         # PTv3's BatchNorm
LN_EPS = 1e-5
HEAD_BN_EPS = 1e-4    # TreeLearn's heads
SEMANTIC_WEIGHT = 50.0


# -- serialization -----------------------------------------------------------

def xyz2key(x, y, z, depth):
    key = torch.zeros_like(x)
    for i in range(depth):
        mask = 1 << i
        key = (key | ((x & mask) << (2 * i + 2)) | ((y & mask) << (2 * i + 1))
               | ((z & mask) << (2 * i)))
    return key


def hilbert_encode(locs, num_bits):
    n = locs.shape[0]
    shifts = torch.arange(num_bits - 1, -1, -1, device=locs.device)
    gray = ((locs[:, :, None] >> shifts) & 1).bool()   # (N, 3, bits), MSB 1st
    for bit in range(num_bits):
        for dim in range(3):
            mask = gray[:, dim, bit].clone()
            gray[:, 0, bit + 1:] = gray[:, 0, bit + 1:] ^ mask[:, None]
            to_flip = (~mask[:, None]) & (gray[:, 0, bit + 1:]
                                          ^ gray[:, dim, bit + 1:])
            gray[:, dim, bit + 1:] = gray[:, dim, bit + 1:] ^ to_flip
            gray[:, 0, bit + 1:] = gray[:, 0, bit + 1:] ^ to_flip
    flat = gray.transpose(1, 2).reshape(n, 3 * num_bits)   # bit-major
    binary = torch.cumsum(flat.long(), 1) % 2               # Gray -> binary
    weights = 1 << torch.arange(3 * num_bits - 1, -1, -1, device=locs.device)
    return (binary * weights).sum(1)


def encode(grid, batch, depth, order):
    if order.endswith("-trans"):
        grid = grid[:, [1, 0, 2]]
    if order.startswith("z"):
        code = xyz2key(grid[:, 0], grid[:, 1], grid[:, 2], depth)
    else:
        code = hilbert_encode(grid, depth)
    return batch << (depth * 3) | code


def argsort_inverse(code):
    order = torch.argsort(code)
    inverse = torch.zeros_like(order).scatter_(
        1, order, torch.arange(code.shape[1], device=code.device).repeat(
            code.shape[0], 1))
    return order, inverse


# -- voxels and neighbours ---------------------------------------------------

KEY_BASE = 1 << 20


def key_of(batch, grid):
    """One int64 key a voxel, (batch, x, y, z) in order."""
    return ((batch * KEY_BASE + grid[:, 0]) * KEY_BASE + grid[:, 1]
            ) * KEY_BASE + grid[:, 2]


def voxelize(coords, batch_ids, valid, batch_size, voxel_size,
             spatial_shape=None):
    """(grid (V, 3), batch (V,), v2p (N,) with -1 for invalid points), the
    voxels sorted by (batch, x, y, z)."""
    c = coords.float()
    b = batch_ids.long()
    mins = torch.full((batch_size, 3), float("inf"), device=c.device)
    mins = mins.scatter_reduce(0, b[valid][:, None].expand(-1, 3), c[valid],
                               reduce="amin")
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    ijk = torch.floor((c - mins[b.clamp(0, batch_size - 1)]) * inv).long()
    if spatial_shape is not None:
        hi = torch.tensor(spatial_shape, device=c.device) - 1
        ijk = torch.minimum(ijk.clamp(min=0), hi)
    uk, inverse = torch.unique(key_of(b, ijk)[valid], sorted=True,
                               return_inverse=True)
    v2p = torch.full((c.shape[0],), -1, dtype=torch.long, device=c.device)
    v2p[valid] = inverse
    base = KEY_BASE
    z = uk % base
    y = (uk // base) % base
    x = (uk // base ** 2) % base
    return torch.stack([x, y, z], 1), uk // base ** 3, v2p


def neighbours(grid, batch, k):
    """(k^3, V): the row of the voxel at each offset of each voxel, or -1."""
    r = k // 2
    srt, idx = torch.sort(key_of(batch, grid))
    rows = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                g = grid + torch.tensor([dx, dy, dz], device=grid.device)
                ok = (g >= 0).all(1)
                q = key_of(batch, g)
                pos = torch.searchsorted(srt, q).clamp(max=len(srt) - 1)
                hit = ok & (srt[pos] == q)
                rows.append(torch.where(hit, idx[pos], -1))
    return torch.stack(rows)


def gather_conv(x, w, nb):
    out = x.new_zeros((x.shape[0], w.shape[2]))
    for k in range(nb.shape[0]):
        rows = torch.nonzero(nb[k] >= 0).squeeze(1)
        if rows.numel():
            out = out.index_add(0, rows, x[nb[k][rows]] @ w[k])
    return out


# -- layers ------------------------------------------------------------------

def lin(x, p, pre):
    y = x @ p[f"{pre}.weight"].t()
    b = p.get(f"{pre}.bias")
    return y if b is None else y + b


def ln(x, p, pre):
    return F.layer_norm(x, (x.shape[1],), p[f"{pre}.weight"],
                        p[f"{pre}.bias"], LN_EPS)


def bn(x, p, pre, training, eps=BN_EPS, live=None):
    if training:
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
    return ((x - mean) / torch.sqrt(var + eps) * p[f"{pre}.weight"]
            + p[f"{pre}.bias"])


def padding_and_inverse(batch, patch_size):
    """Pointcept's ``get_padding_and_inverse`` with K = min(patch size,
    fewest tokens of an element): (pad, unpad, K)."""
    bincount = torch.bincount(batch)
    k = int(min(patch_size, int(bincount[bincount > 0].min())))
    offset = torch.cumsum(bincount, 0)
    bincount_pad = torch.div(bincount + k - 1, k, rounding_mode="trunc") * k
    mask_pad = bincount > k
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    _offset = F.pad(offset, (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, 0), (1, 0))
    pad = torch.arange(int(_offset_pad[-1]), device=batch.device)
    unpad = torch.arange(int(_offset[-1]), device=batch.device)
    for i in range(len(offset)):
        unpad[_offset[i]:_offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != bincount_pad[i]:
            r = int(bincount[i] % k)
            e = int(_offset_pad[i + 1])
            pad[e - k + r:e] = pad[e - 2 * k + r:e - k].clone()
        pad[_offset_pad[i]:_offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
    return pad, unpad, k


def patch_attention(q, k, v, scale):
    """softmax(q k^T scale) v over (P, H, K, d) patches."""
    attn = torch.softmax((q * scale) @ k.transpose(-2, -1), -1)
    return attn @ v


class Forward:
    """One forward of PTv3 + TreeLearn's heads over given parameters (the
    port's ``state_dict`` names), configuration (Pointcept's keys) and
    draws (``[("perm", list), ("keep", (N,) bool), ...]`` in the order the
    forward consumes them)."""

    def __init__(self, params, cfg, draws, training):
        self.p = params
        self.cfg = cfg
        self.draws = list(draws)
        self.training = training

    def lin(self, x, pre):
        return lin(x, self.p, pre)

    def conv(self, x, w, nb):
        return gather_conv(x, w, nb)

    def draw(self, kind):
        got, *val = self.draws.pop(0)
        assert got == kind, (got, kind)
        return val

    def keep_mask(self, st):
        """The next keep mask, given in the order of its (b, x, y, z)
        coordinates, in the order of this stage's tokens."""
        mask, bxyz = self.draw("keep")
        bxyz = bxyz.long()
        ours = key_of(st["batch"], st["grid"])
        srt, idx = torch.sort(key_of(bxyz[:, 0], bxyz[:, 1:]))
        pos = torch.searchsorted(srt, ours)
        assert torch.equal(srt[pos], ours)
        return mask[idx[pos]]

    def serialize(self, st, codes):
        order, inverse = argsort_inverse(codes)
        if self.cfg.get("shuffle_orders", True):
            perm = torch.tensor(self.draw("perm")[0], device=codes.device)
            codes, order, inverse = codes[perm], order[perm], inverse[perm]
        st.update(code=codes, order=order, inverse=inverse)

    def drop(self, h, rate, st):
        if not self.training or rate <= 0.0:
            return h
        keep = self.keep_mask(st).float()[:, None]
        return h * keep / (1.0 - rate)

    def block(self, x, st, pre, heads, patch, i, rate):
        p = self.p
        h = self.conv(x, p[f"{pre}.cpe.conv.weight"], st["nb"])
        h = h + p[f"{pre}.cpe.conv.bias"]
        x = x + ln(self.lin(h, f"{pre}.cpe.linear"), p, f"{pre}.cpe.norm")
        a = self.attention(ln(x, p, f"{pre}.norm1"), st, f"{pre}.attn",
                           heads, patch, i)
        x = x + self.drop(a, rate, st)
        m = self.lin(F.gelu(self.lin(ln(x, p, f"{pre}.norm2"),
                                     f"{pre}.mlp.fc1")), f"{pre}.mlp.fc2")
        return x + self.drop(m, rate, st)

    def attention(self, x, st, pre, heads, patch, i):
        n, c = x.shape
        d = c // heads
        pad, unpad, k = padding_and_inverse(st["batch"], patch)
        oi = i % st["order"].shape[0]
        order = st["order"][oi][pad]
        inverse = unpad[st["inverse"][oi]]
        qkv = self.lin(x, f"{pre}.qkv")[order]
        q, kk, v = qkv.reshape(-1, k, 3, heads, d).permute(2, 0, 3, 1, 4
                                                            ).unbind(0)
        feat = self.patches(q, kk, v, d ** -0.5)
        feat = feat.transpose(1, 2).reshape(-1, c)[inverse]
        return self.lin(feat, f"{pre}.proj")

    def patches(self, q, k, v, scale):
        return patch_attention(q, k, v, scale)

    def pool(self, x, st, pre):
        code = st["code"] >> 3
        _, cluster, counts = torch.unique(code[0], sorted=True,
                                          return_inverse=True,
                                          return_counts=True)
        _, indices = torch.sort(cluster)
        idx_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        head = indices[idx_ptr[:-1]]
        h = self.lin(x, f"{pre}.proj")
        feat = h.new_zeros((len(head), h.shape[1])).scatter_reduce(
            0, cluster[:, None].expand(-1, h.shape[1]), h, "amax",
            include_self=False)
        new = {"grid": st["grid"][head] >> 1, "batch": st["batch"][head],
               "depth": st["depth"] - 1, "cluster": cluster}
        self.serialize(new, code[:, head])
        new["nb"] = neighbours(new["grid"], new["batch"], 3)
        return F.gelu(bn(feat, self.p, f"{pre}.norm", self.training)), new

    def unpool(self, x, skip, cluster, pre):
        p, t = self.p, self.training
        up = F.gelu(bn(self.lin(x, f"{pre}.proj"), p, f"{pre}.proj_norm", t))
        sk = F.gelu(bn(self.lin(skip, f"{pre}.skip"), p, f"{pre}.skip_norm",
                       t))
        return sk + up[cluster]

    def backbone(self, grid, batch):
        cfg, p = self.cfg, self.p
        depth = max(int(grid.max()).bit_length(), 1)
        st = {"grid": grid, "batch": batch, "depth": depth}
        codes = torch.stack([encode(grid, batch, depth, o)
                             for o in cfg.get("order", ORDERS)])
        self.serialize(st, codes)
        st["nb"] = neighbours(grid, batch, 3)
        x = self.conv(torch.ones((grid.shape[0], 4), device=grid.device),
                        p["ptv3.embedding.stem.weight"],
                        neighbours(grid, batch, STEM_K))
        x = F.gelu(bn(x, p, "ptv3.embedding.norm", self.training))
        enc_d, dec_d = cfg["enc_depths"], cfg["dec_depths"]
        rates = [float(v) for v in torch.linspace(0, cfg["drop_path"],
                                                  sum(enc_d))]
        stages, skips = [], []
        for s in range(len(enc_d)):
            if s > 0:
                x, st = self.pool(x, st, f"ptv3.enc.{s}.down")
            stages.append(st)
            for i in range(enc_d[s]):
                x = self.block(x, st, f"ptv3.enc.{s}.blocks.{i}",
                               cfg["enc_num_head"][s],
                               cfg["enc_patch_size"][s], i,
                               rates[sum(enc_d[:s]) + i])
            skips.append(x)
        rates = [float(v) for v in torch.linspace(0, cfg["drop_path"],
                                                  sum(dec_d))]
        for s in reversed(range(len(dec_d))):
            r = rates[sum(dec_d[:s]):sum(dec_d[:s + 1])][::-1]
            x = self.unpool(x, skips[s], stages[s + 1]["cluster"],
                            f"ptv3.dec.{s}.up")
            for i in range(dec_d[s]):
                x = self.block(x, stages[s], f"ptv3.dec.{s}.blocks.{i}",
                               cfg["dec_num_head"][s],
                               cfg["dec_patch_size"][s], i, r[i])
        return x

    def head(self, x, pre, live):
        h = self.lin(x, f"{pre}.0")
        h = torch.relu(bn(h, self.p, f"{pre}.1", self.training, HEAD_BN_EPS,
                          live))
        return self.lin(h, f"{pre}.3")

    def __call__(self, coords, batch_ids, valid, batch_size, voxel_size,
                 spatial_shape=None):
        """(semantic logits (N, 2), offsets (N, 3))."""
        grid, batch, v2p = voxelize(coords, batch_ids, valid, batch_size,
                                    voxel_size, spatial_shape)
        x = self.backbone(grid, batch)
        assert not self.draws, f"{len(self.draws)} draws left over"
        feats = torch.where((v2p >= 0)[:, None], x[v2p.clamp(min=0)],
                            torch.zeros((), device=x.device))
        return (self.head(feats, "semantic_linear", valid),
                self.head(feats, "offset_linear", valid))


# -- loss and step -----------------------------------------------------------

def loss_of(sem, off, b):
    """50 x the mean cross-entropy over ``masks_sem`` plus the mean offset
    distance over ``masks_off`` (TreeLearn's loss)."""
    sel_s = b["masks_sem"] & b["valid"]
    sel_o = b["masks_off"] & b["valid"]
    ce = -torch.log_softmax(sem, 1).gather(
        1, b["semantic_labels"].long().clamp(0, 1)[:, None])[:, 0]
    dist = torch.sqrt(((off - b["offset_labels"]) ** 2).sum(1) + 1e-12)
    sem_loss = (ce * sel_s).sum() / sel_s.sum().clamp(min=1)
    off_loss = (dist * sel_o).sum() / sel_o.sum().clamp(min=1)
    return SEMANTIC_WEIGHT * sem_loss + off_loss


def adamw_step(params, grads, lr, wd, state, t, clip=1.0,
               b1=0.9, b2=0.999, eps=1e-8):
    """One AdamW step (decoupled weight decay) after clipping the global
    norm to ``clip`` (optax's rule: scaled by clip / norm where norm >=
    clip); ``t`` counts from 1."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if float(norm) < clip else clip / float(norm)
    out = {}
    for k, g in grads.items():
        g = g * scale
        m, v = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        p = params[k] * (1.0 - lr * wd)
        out[k] = p - lr * mh / (vh.sqrt() + eps)
    return out


# -- the benchmark's additions ----------------------------------------------

from collections import OrderedDict  # noqa: E402

from torch.utils.checkpoint import checkpoint  # noqa: E402

from .training import loss_of as tl_loss_of  # noqa: E402
from .training import lr_at, to_tensors  # noqa: E402
from .unet import Fp8Matmul, Fp8Round, fp8_round  # noqa: E402

ATTN_BLOCK = 32       # patches of an attention block on the card
TRAINABLE = ("conv", "linear", "xavier", "head", "bias", "ln_weight",
             "ln_bias", "bn_weight", "bn_bias")


class Fp8Bmm(torch.autograd.Function):
    """a @ b over batched matrices, operands in float8 e4m3 and the output
    gradient in e5m2 (one scale a tensor), products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a.detach()), fp8_round(b.detach())
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        return gq @ bq.transpose(-2, -1), aq.transpose(-2, -1) @ gq


def _attn_fp8(q, k, v, scale):
    attn = torch.softmax(Fp8Bmm.apply(q * scale, k.transpose(-2, -1)), -1)
    return Fp8Round.apply(Fp8Bmm.apply(attn, v))


class CardForward(Forward):
    """:class:`Forward` with its attention in blocks of ``block`` patches,
    each recomputed in the backward, and with ``quant="fp8"`` the float8
    control."""

    def __init__(self, params, cfg, draws, training, quant="none",
                 block=ATTN_BLOCK):
        super().__init__(params, cfg, draws, training)
        self.fp8 = quant == "fp8"
        self.attn_block = int(block)

    def lin(self, x, pre):
        if not self.fp8:
            return super().lin(x, pre)
        y = Fp8Matmul.apply(x, self.p[f"{pre}.weight"].t())
        b = self.p.get(f"{pre}.bias")
        return Fp8Round.apply(y if b is None else y + b)

    def conv(self, x, w, nb):
        if not self.fp8:
            return super().conv(x, w, nb)
        out = x.new_zeros((x.shape[0], w.shape[2]))
        for k in range(nb.shape[0]):
            rows = torch.nonzero(nb[k] >= 0).squeeze(1)
            if rows.numel():
                out = out.index_add(0, rows,
                                    Fp8Matmul.apply(x[nb[k][rows]], w[k]))
        return Fp8Round.apply(out)

    def patches(self, q, k, v, scale):
        fn = _attn_fp8 if self.fp8 else patch_attention
        parts = []
        for i in range(0, q.shape[0], self.attn_block):
            j = i + self.attn_block
            if torch.is_grad_enabled():
                parts.append(checkpoint(fn, q[i:j], k[i:j], v[i:j], scale,
                                        use_reentrant=False))
            else:
                parts.append(fn(q[i:j], k[i:j], v[i:j], scale))
        return torch.cat(parts)


def param_spec(ptv3: dict, in_channels: int = 4, head_in: int = None):
    """name -> (shape, kind, fan_in) of every parameter and buffer of
    ``TreeLearn(backbone="ptv3")`` with Pointcept's keys ``ptv3``, under the
    program's ``state_dict`` names."""
    spec = OrderedDict()

    def bn(pre, c):
        spec[f"{pre}.weight"] = ((c,), "bn_weight", c)
        spec[f"{pre}.bias"] = ((c,), "bn_bias", c)
        spec[f"{pre}.running_mean"] = ((c,), "bn_mean", c)
        spec[f"{pre}.running_var"] = ((c,), "bn_var", c)
        spec[f"{pre}.num_batches_tracked"] = ((), "count", 0)

    def linear(pre, cin, cout, bias=True):
        spec[f"{pre}.weight"] = ((cout, cin), "linear", cin)
        if bias:
            spec[f"{pre}.bias"] = ((cout,), "bias", cin)

    def ln_(pre, c):
        spec[f"{pre}.weight"] = ((c,), "ln_weight", c)
        spec[f"{pre}.bias"] = ((c,), "ln_bias", c)

    def block(pre, c):
        spec[f"{pre}.cpe.conv.weight"] = ((27, c, c), "conv", 27 * c)
        spec[f"{pre}.cpe.conv.bias"] = ((c,), "bias", 27 * c)
        linear(f"{pre}.cpe.linear", c, c)
        ln_(f"{pre}.cpe.norm", c)
        ln_(f"{pre}.norm1", c)
        linear(f"{pre}.attn.qkv", c, 3 * c, ptv3.get("qkv_bias", True))
        linear(f"{pre}.attn.proj", c, c)
        ln_(f"{pre}.norm2", c)
        hid = int(c * ptv3.get("mlp_ratio", 4))
        linear(f"{pre}.mlp.fc1", c, hid)
        linear(f"{pre}.mlp.fc2", hid, c)

    enc, dec = list(ptv3["enc_channels"]), list(ptv3["dec_channels"])
    c0 = enc[0]
    spec["ptv3.embedding.stem.weight"] = ((STEM_K ** 3, in_channels, c0),
                                          "conv", STEM_K ** 3 * in_channels)
    bn("ptv3.embedding.norm", c0)
    for s, c in enumerate(enc):
        if s > 0:
            linear(f"ptv3.enc.{s}.down.proj", enc[s - 1], c)
            bn(f"ptv3.enc.{s}.down.norm", c)
        for i in range(ptv3["enc_depths"][s]):
            block(f"ptv3.enc.{s}.blocks.{i}", c)
    chans = dec + [enc[-1]]
    for s in range(len(dec)):
        pre = f"ptv3.dec.{s}.up"
        linear(f"{pre}.proj", chans[s + 1], chans[s])
        bn(f"{pre}.proj_norm", chans[s])
        linear(f"{pre}.skip", enc[s], chans[s])
        bn(f"{pre}.skip_norm", chans[s])
        for i in range(ptv3["dec_depths"][s]):
            block(f"ptv3.dec.{s}.blocks.{i}", chans[s])
    c = chans[0] if dec else enc[-1]
    for name, out in (("semantic_linear", 2), ("offset_linear", 3)):
        spec[f"{name}.0.weight"] = ((c, c), "xavier", c + c)
        spec[f"{name}.0.bias"] = ((c,), "bias", c)
        bn(f"{name}.1", c)
        spec[f"{name}.3.weight"] = ((out, c), "head", c)
        spec[f"{name}.3.bias"] = ((out,), "bias", c)
    return spec


def make_weights(seed: int, device, spec) -> "OrderedDict[str, torch.Tensor]":
    """The parameters and buffers of ``spec`` from ``seed``: one draw of
    uniform numbers in [-1, 1) on ``device`` by a seeded generator, cut
    into the leaves and scaled by kind: convs and linears to unit gain
    (sqrt(3 / fan_in)), the heads' hidden layer xavier, their output 0.01
    wide, biases 0.01, LayerNorm and BatchNorm scales and variances near 1,
    shifts and means near 0."""
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
        if kind in ("conv", "linear"):
            x = x * (3.0 / fan) ** 0.5
        elif kind == "xavier":
            x = x * (6.0 / fan) ** 0.5
        elif kind == "head":
            x = x * 0.01 * 3.0 ** 0.5
        elif kind == "bias":
            x = x * 0.01
        elif kind in ("bn_weight", "bn_var", "ln_weight"):
            x = 1.0 + 0.2 * x
        else:   # bn_bias, bn_mean, ln_bias
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def train_steps(params0: dict, spec: dict, batches, draws, cfg: dict,
                device, quant: str = "none", step_grads: list = None):
    """One step per batch from ``params0``, each forward on its recorded
    draws; returns (losses, the first step's clipped gradient per leaf,
    the leaves after the last step, the first step's semantic logits and
    offsets), as ``reference/training.py:train_steps`` does for the
    U-Net.  ``step_grads``, if given, gets every step's clipped gradient
    per leaf."""
    model = cfg["model"]
    params = {}
    for k, v in params0.items():
        t = v.detach().to(device).float() if v.is_floating_point() else v
        if spec[k][1] in TRAINABLE:
            t = t.clone().requires_grad_(True)
        params[k] = t
    leaves = [k for k in params if spec[k][1] in TRAINABLE]
    opt = cfg["optimizer"]
    wd = float(opt["weight_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(params[k]) for k in leaves}
    v = {k: torch.zeros_like(params[k]) for k in leaves}
    bs = int(cfg["dataloader"]["train"]["batch_size"])
    spe = max(int(cfg["examples_per_epoch"]) // bs, 1)
    clip = 1.0 if cfg.get("grad_norm_clip") is True else cfg.get(
        "grad_norm_clip")
    losses, first_grad, first_out = [], None, None
    for t, (batch, dr) in enumerate(zip(batches, draws)):
        b = to_tensors(batch, device)
        f = CardForward(params, model["ptv3"], dr, True, quant)
        sem, off = f(b["coords"], b["batch_ids"], b["valid"],
                     int(batch["batch_size"]), float(model["voxel_size"]),
                     model.get("spatial_shape"))
        if first_out is None:
            first_out = (sem.detach(), off.detach())
        loss = tl_loss_of(sem, off, b)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(leaves, grads)]
        del f, sem, off
        if clip:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = (1.0 if float(norm) < float(clip)
                     else float(clip) / float(norm))
            grads = [g * scale for g in grads]
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(leaves, grads)}
        if step_grads is not None:
            step_grads.append({k: g.detach() for k, g in zip(leaves, grads)})
        lr = lr_at(t, opt, cfg["scheduler"], spe)
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                p = params[k]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** (t + 1))
                vh = v[k] / (1 - b2 ** (t + 1))
                p.sub_(lr * mh / (vh.sqrt() + eps))
        losses.append(float(loss.detach()))
    return (losses, first_grad, {k: params[k].detach() for k in leaves},
            first_out)
