"""SPFormer's query decoder as a head of the port (Sun et al., "Superpoint
Transformer for 3D Scene Instance Segmentation", AAAI 2023,
arXiv:2211.15766; github.com/sunjiahao1999/SPFormer
``spformer/model/query_decoder.py``, widths of ``configs/spf_scannet.yaml``).

The decoder reads the U-Net's voxel features ``x`` (every 0.1 m voxel is
its own superpoint, so the mean of a superpoint's point features is the
voxel's feature) one batch element at a time, as SPFormer loops over its
batch, so no key is padded and no element's keys reach another element's
queries.  Layers, with Q queries of width D and H heads:

* sources: ``S = ReLU(LN(Linear(x)))`` (keys and values), mask features
  ``M = Linear(ReLU(Linear(x)))``, and the learned queries
  ``q0 = Embedding(Q, D).weight``, the same for every element;
* prediction head, before the first layer and after each of the
  ``num_layer`` layers: ``q^ = LN(q)``, class logits ``Linear(ReLU(Linear(
  q^)))`` (tree, no-object), a score logit of the same form, mask logits
  ``P = q^ M^T`` (Q, K_b), and the next layer's attention mask ``A = P <
  0`` (``sigmoid(P) < 0.5``) with every all-closed row opened, detached;
* decoder layer (post-norm): ``q = LN(q + MHA(q, S, S; closed where A))``,
  ``q = LN(q + MHA(q, q, q))``, ``q = LN(q + Linear(GELU(Linear(q))))``;
  ``MHA`` as ``nn.MultiheadAttention(D, H)`` (in-projection with bias,
  scale ``(D / H) ** -0.5``, out-projection with bias).

Precision (as the other modules place it): linears, the mask products and
attention take ``compute_dtype`` operands and sum in float32; LayerNorm
statistics, softmax statistics, the query stream, ``P`` and everything the
loss computes from it are float32.  Each prediction packs the next layer's
mask from ``P`` (``ops/mask_attn.py:mask_pack``: one bit a pair, a byte a
64 x 64 tile, the open pairs counted on the device).  On a card the masked
cross-attention runs on the kernels of ``csrc/mask_attn.cu`` (bf16 only)
and the self-attention on ``scaled_dot_product_attention``'s flash backend;
on the CPU both run SDPA's math backend, the cross-attention under
``mask_bias`` of the unpacked closed mask.  A fallback raises.

Host reads: none; the element's voxel ranges come with the voxelization's
own read (``voxelize_points(elem_counts=True)``).  The loss
(``train/matching.py``) makes the mechanism's one host read a step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mask_attn import mask_attention, mask_pack, unpack_closed
from ..utils.trace import count, span
from .blocks import _kaiming_uniform, _split
from .ptv3 import layer_norm, linear

LN_EPS = 1e-5

# configs/spf_scannet.yaml, model.decoder, model.criterion and model.test_cfg
PUBLISHED = {"num_layer": 6, "num_query": 400, "d_model": 256, "nhead": 8,
             "hidden_dim": 1024, "dropout": 0.0, "activation_fn": "gelu",
             "iter_pred": True, "attn_mask": True, "pe": False,
             "num_class": 1, "loss_weight": (0.5, 1.0, 1.0, 0.5),
             "cost_weight": (0.5, 1.0, 1.0), "non_object_weight": 0.1,
             "topk_insts": 100, "score_thr": 0.0, "npoint_thr": 100}
# published keys this port implements only at their published value
_FIXED = {"dropout": 0.0, "activation_fn": "gelu", "iter_pred": True,
          "attn_mask": True, "pe": False, "num_class": 1}
_CRITERION = ("loss_weight", "cost_weight", "non_object_weight")
_TEST = ("topk_insts", "score_thr", "npoint_thr")


def mask_bias(closed: torch.Tensor, dtype) -> torch.Tensor:
    """The (1, 1, Q, K) additive mask of a (Q, K) closed mask: -inf where
    closed, 0 where open, in ``dtype`` (the CPU route's), its rows
    16-element aligned so that SDPA's memory-efficient kernel would read it
    in place."""
    q, k = closed.shape
    k16 = -(-k // 16) * 16
    bias = torch.zeros((q, k16), dtype=dtype, device=closed.device)
    bias[:, :k].masked_fill_(closed, float("-inf"))
    return bias[:, :k][None, None]


def attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """Softmax attention of (1, H, L, d) heads on one forced backend: the
    memory-efficient kernel under an additive ``bias`` on a card, flash
    without one, the math backend on the CPU."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not q.is_cuda:
        backend = SDPBackend.MATH
    elif bias is not None or q.dtype not in (torch.float16, torch.bfloat16):
        backend = SDPBackend.EFFICIENT_ATTENTION
    else:
        backend = SDPBackend.FLASH_ATTENTION
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=scale)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters under its names, computed on
    :func:`attention`."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        if d % heads:
            raise ValueError(f"{d} channels do not split into {heads} heads")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def project(self, x, part: slice, dtype):
        return F.linear(x.to(dtype), self.in_proj_weight[part].to(dtype),
                        self.in_proj_bias[part].to(dtype))

    def heads_of(self, x):
        """(L, D) -> (1, H, L, d)."""
        return x.view(1, x.shape[0], self.heads, -1).transpose(1, 2)

    def merge(self, o):
        """(1, H, L, d) -> (L, D)."""
        return o.transpose(1, 2).reshape(o.shape[2], -1)


class CrossAttentionLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(d, heads)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, q, src, ranges, closed, dtype):
        """q (B, Q, D) float32, src (V, D) the keys and values of every
        element, ``ranges`` [(start, end)] of each element's rows of src,
        ``closed`` each element's mask in the form its route reads (on a
        card the packed ``MaskBits``, on the CPU the (Q, K_b) bool closed
        mask) -> (B, Q, D) float32."""
        d = q.shape[-1]
        a = self.attn
        qp = a.project(q, slice(0, d), dtype)
        kv = a.project(src, slice(d, 3 * d), dtype)
        scale = (d // a.heads) ** -0.5
        if q.is_cuda:
            o = mask_attention(qp, kv, closed, ranges, a.heads, scale)
        else:
            outs = []
            for b, (s, e) in enumerate(ranges):
                k, v = kv[s:e, :d], kv[s:e, d:]
                o = attention(a.heads_of(qp[b]), a.heads_of(k),
                              a.heads_of(v), mask_bias(closed[b], dtype),
                              scale)
                outs.append(a.merge(o))
            o = torch.stack(outs)
        o = linear(o, a.out_proj, dtype)
        return layer_norm(q + o.float(), self.norm)


class SelfAttentionLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(d, heads)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, q, dtype):
        bsz, n, d = q.shape
        a = self.attn
        qkv = a.project(q, slice(0, 3 * d), dtype)
        qkv = qkv.view(bsz, n, 3, a.heads, d // a.heads).permute(2, 0, 3, 1,
                                                                 4)
        o = attention(qkv[0], qkv[1], qkv[2], None, (d // a.heads) ** -0.5)
        o = linear(o.transpose(1, 2).reshape(bsz, n, d), a.out_proj, dtype)
        return layer_norm(q + o.float(), self.norm)


class FFN(nn.Module):
    """Linear, GELU, Linear (SPFormer's ``net`` Sequential: indices 0 and 3
    around the activation and its dropout), residual, LayerNorm."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.net = nn.ModuleDict({"0": nn.Linear(d, hidden),
                                  "3": nn.Linear(hidden, d)})
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, q, dtype):
        h = F.gelu(linear(q, self.net["0"], dtype))
        return layer_norm(q + linear(h, self.net["3"], dtype).float(),
                          self.norm)


def _mlp(d: int, out: int):
    return nn.ModuleDict({"0": nn.Linear(d, d), "2": nn.Linear(d, out)})


def _run_mlp(m, x, dtype):
    return linear(F.relu(linear(x, m["0"], dtype)), m["2"], dtype).float()


def closed_mask(p: torch.Tensor) -> torch.Tensor:
    """SPFormer's attention mask of mask logits ``p`` (Q, K): closed where
    ``sigmoid(p) < 0.5``, every all-closed row opened; no host read.  The
    plain statement of the set that ``mask_pack`` packs."""
    a = p < 0
    return a & ~a.all(-1, keepdim=True)


class SPFormerHead(nn.Module):
    """The query decoder; :meth:`forward` maps (V, C) voxel features and
    the elements' voxel ranges to the 1 + ``num_layer`` predictions.

    With ``record`` a list, each forward appends a dict to it holding the
    closed masks each cross-attention used (``masks``: per layer, per
    element, (Q, K_b) bool), and the loss adds its assignments there
    (``output["record"]``), so that a reference can follow the same
    steps."""

    def __init__(self, in_channels: int, num_layer: int = 6,
                 num_query: int = 400, d_model: int = 256, nhead: int = 8,
                 hidden_dim: int = 1024, **rest):
        super().__init__()
        self.criterion = {k: rest.pop(k, PUBLISHED[k]) for k in _CRITERION}
        for k in _TEST:     # spformer_instances' settings, read by callers
            rest.pop(k, None)
        for k, v in rest.items():
            if k not in _FIXED:
                raise ValueError(f"spformer: unknown key {k!r}")
            if v != _FIXED[k]:
                raise ValueError(f"spformer: {k}={v!r} is not implemented "
                                 f"(only {_FIXED[k]!r})")
        self.num_layer, self.num_query = int(num_layer), int(num_query)
        self.d_model, self.nhead = int(d_model), int(nhead)
        d = self.d_model
        self.input_proj = nn.ModuleDict({"0": nn.Linear(in_channels, d),
                                         "1": nn.LayerNorm(d, eps=LN_EPS)})
        self.x_mask = nn.ModuleDict({"0": nn.Linear(in_channels, d),
                                     "2": nn.Linear(d, d)})
        self.query = nn.Embedding(self.num_query, d)
        self.cross_attn_layers = nn.ModuleList(
            [CrossAttentionLayer(d, nhead) for _ in range(num_layer)])
        self.self_attn_layers = nn.ModuleList(
            [SelfAttentionLayer(d, nhead) for _ in range(num_layer)])
        self.ffn_layers = nn.ModuleList(
            [FFN(d, hidden_dim) for _ in range(num_layer)])
        self.out_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.out_cls = _mlp(d, 2)
        self.out_score = _mlp(d, 1)
        self.record: Optional[list] = None

    def predict(self, q, mfeat, ranges, dtype, pack: bool):
        """(normalized queries, class logits, score logits, mask logits per
        element, packed masks per element, or None without ``pack``) of the
        queries ``q``; the mask logits are float32 and carry no gradient
        (the loss recomputes its matched rows from the normalized
        queries)."""
        qn = layer_norm(q, self.out_norm)
        cls = _run_mlp(self.out_cls, qn, dtype)
        score = _run_mlp(self.out_score, qn, dtype)[..., 0]
        masks, packed = [], []
        with torch.no_grad():
            qd = qn.to(dtype)
            for b, (s, e) in enumerate(ranges):
                p = (qd[b] @ mfeat[s:e].t()).float()
                masks.append(p)
                if pack:
                    packed.append(mask_pack(p))
        return qn, cls, score, masks, packed if pack else None

    def forward(self, x: torch.Tensor, ranges: Sequence[tuple],
                dtype=torch.float32) -> Dict[str, object]:
        """x (V, C) voxel features, ``ranges`` [(start, end)] of each batch
        element's voxels -> dict of per-prediction lists: ``pred_logits``
        (B, Q, 2), ``pred_scores`` (B, Q), ``pred_masks`` [(Q, K_b)]
        float32, ``pred_queries`` (B, Q, D) (the normalized queries),
        plus ``mask_feats`` (V, D), ``open_pairs`` ((num_layer,) int64 on
        the device: the pairs each cross-attention's mask left open) and
        ``mask_tiles`` ((num_layer, 2) int64 on the device: each layer's
        64 x 64 (query, key) tiles with no open pair, which the kernels
        skip, and its tiles)."""
        rec = None
        if self.record is not None:
            rec = {"masks": []}
            self.record.append(rec)
        n_elems = len(ranges)
        count("spformer.keys", int(x.shape[0]))
        out = {"pred_logits": [], "pred_scores": [], "pred_masks": [],
               "pred_queries": []}
        opens, tiles = [], []
        with span("spformer.decoder"):
            with span("spformer.proj"):
                src = F.relu(layer_norm(
                    linear(x, self.input_proj["0"], dtype),
                    self.input_proj["1"]))
                mfeat = linear(F.relu(linear(x, self.x_mask["0"], dtype)),
                               self.x_mask["2"], dtype)
                q = self.query.weight.float()[None].expand(
                    n_elems, -1, -1)
            closed = None
            for layer in range(self.num_layer + 1):
                if layer > 0:
                    with span(f"spformer.layer{layer}"):
                        with span("spformer.cross_attn"):
                            q = self.cross_attn_layers[layer - 1](
                                q, src, ranges, closed, dtype)
                        with span("spformer.self_attn"):
                            q = self.self_attn_layers[layer - 1](q, dtype)
                        with span("spformer.ffn"):
                            q = self.ffn_layers[layer - 1](q, dtype)
                with span(f"spformer.pred{layer}"):
                    qn, cls, score, masks, packed = self.predict(
                        q, mfeat, ranges, dtype, layer < self.num_layer)
                    if packed is not None:
                        stats = sum(m.stats for m in packed)
                        opens.append(stats[0])
                        tiles.append(stats[1:])
                        closed = (packed if x.is_cuda else
                                  [unpack_closed(m) for m in packed])
                        if rec is not None:
                            rec["masks"].append(
                                [unpack_closed(m) for m in packed]
                                if x.is_cuda else closed)
                for k, v in zip(("pred_queries", "pred_logits",
                                 "pred_scores", "pred_masks"),
                                (qn, cls, score, masks)):
                    out[k].append(v)
        out["mask_feats"] = mfeat
        out["open_pairs"] = torch.stack(opens) if opens else None
        out["mask_tiles"] = torch.stack(tiles) if tiles else None
        out["record"] = rec
        out["criterion"] = dict(self.criterion)
        return out


def _init_kind(head: SPFormerHead, name: str) -> str:
    owner, leaf = name.rsplit(".", 1)
    mod = head.get_submodule(owner)
    in_layer = name.startswith(("cross_attn_layers", "self_attn_layers",
                                "ffn_layers"))
    if isinstance(mod, nn.Embedding):
        return "normal"
    if isinstance(mod, nn.LayerNorm):
        return "one" if leaf == "weight" else "zero"
    if isinstance(mod, MultiheadAttention):
        return "xavier" if leaf == "in_proj_weight" else "zero"
    if leaf == "weight":
        return "xavier" if in_layer else "kaiming"
    return "zero" if owner.endswith("attn.out_proj") else "bias"


def init_numpy(head: SPFormerHead, seed) -> "Dict[str, np.ndarray]":
    """Parameters of ``head`` (names as its ``state_dict``) from a
    ``SeedSequence``, one child sequence a tensor in ``state_dict`` order,
    as SPFormer initialises them: the attention layers' and FFNs' matrices
    xavier-uniform (their ``_reset_parameters``), the attentions' biases 0
    (``nn.MultiheadAttention``'s own reset); the other linears as PyTorch
    does (kaiming-uniform weights, biases uniform in +-1 / sqrt(fan_in));
    the query embedding N(0, 1); LayerNorm scales 1 and shifts 0."""
    ss = (seed if isinstance(seed, np.random.SeedSequence)
          else np.random.SeedSequence(int(seed)))
    sd = head.state_dict()
    out = {}
    for key, (name, t) in zip(_split(ss, len(sd)), sd.items()):
        shape = tuple(t.shape)
        kind = _init_kind(head, name)
        rng = np.random.default_rng(key)
        if kind == "normal":
            out[name] = rng.normal(size=shape).astype(np.float32)
        elif kind == "xavier":
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
        elif kind == "kaiming":
            out[name] = _kaiming_uniform(key, shape, shape[1])
        elif kind == "bias":
            fan = int(sd[name.rsplit(".", 1)[0] + ".weight"].shape[1])
            bound = 1.0 / math.sqrt(fan)
            out[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
        else:
            out[name] = np.full(shape, kind == "one", np.float32)
    return out


def spformer_instances(output: dict, topk_insts: int = 100,
                       score_thr: float = 0.0, npoint_thr: int = 100,
                       v2p_map: Optional[torch.Tensor] = None
                       ) -> List[Dict[str, torch.Tensor]]:
    """Instances of the last prediction, per batch element (SPFormer's
    ``predict_by_feat``): each query scored ``softmax(cls)[tree] *
    sigmoid(score)``, the ``topk_insts`` best kept above ``score_thr``,
    their masks ``P > 0`` gathered to the points through the
    voxelization's point -> voxel map (``output["v2p_map"]``; invalid
    points are in no instance), and those of fewer than ``npoint_thr``
    points dropped.  Returns [{"scores": (I,), "masks": (I, N) bool}]."""
    v2p = output["v2p_map"] if v2p_map is None else v2p_map
    cls = output["pred_logits"][-1].float()
    score = output["pred_scores"][-1].float()
    quality = torch.softmax(cls, -1)[..., 0] * torch.sigmoid(score)
    res = []
    for b, (s, e) in enumerate(output["voxel_ranges"]):
        k = min(int(topk_insts), quality.shape[1])
        top, idx = torch.topk(quality[b], k)
        keep = top > score_thr
        top, idx = top[keep], idx[keep]
        vox = output["pred_masks"][-1][b][idx] > 0          # (I, K_b)
        inside = (v2p >= s) & (v2p < e)
        local = torch.where(inside, v2p - s, 0)
        pts = vox[:, local] & inside[None]
        big = pts.sum(1) >= int(npoint_thr)
        res.append({"scores": top[big], "masks": pts[big]})
    return res
