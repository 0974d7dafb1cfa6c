"""Plain training steps of SPFormer's query decoder on TreeLearn's U-Net
(Sun et al., "Superpoint Transformer for 3D Scene Instance Segmentation",
AAAI 2023, arXiv:2211.15766; github.com/sunjiahao1999/SPFormer
``spformer/model/query_decoder.py`` and ``loss.py``) in float32 PyTorch,
with scipy's assignment: no kernels, no caches, no batching of elements.

Backbone: ``reference/unet.py``'s network at ``num_blocks`` levels up to its
output BatchNorm and ReLU (voxel features, each voxel its own superpoint).
Decoder, one batch element at a time, Q queries of width D, H heads:

* ``S = ReLU(LN(Linear(x)))``; ``M = Linear(ReLU(Linear(x)))``; ``q0`` the
  query embedding;
* prediction (before the first layer and after each): ``q^ = LN(q)``, class
  ``Linear(ReLU(Linear(q^)))`` (tree, no-object), score of the same form,
  ``P = q^ M^T``, attention mask ``sigmoid(P) < 0.5`` with all-closed rows
  opened;
* layer: ``q = LN(q + MHA(q, S, S; mask))``, ``q = LN(q + MHA(q, q, q))``,
  ``q = LN(q + Linear(GELU(Linear(q))))``; attention written out as
  ``softmax(q k^T / sqrt(d) + mask) v`` over blocks of queries, each block
  recomputed in the backward (checkpointed) so that 200,000 keys fit.

Targets: per element, each instance label other than 0 (non-tree) and -1
(ignore) over its valid points; voxel v is in target g where the share of
v's points with label g is above one half (``scatter_mean(gt_mask,
superpoint) > 0.5``); empty targets dropped.  Matching costs as SPFormer's
``batch_sigmoid_bce_loss`` and ``batch_dice_loss`` write them
(``softplus(-P) t^T + softplus(P) (1 - t)^T`` over the keys), weights
``cost_weight``; losses as its ``Criterion``: class cross-entropy with
weights [1, ``non_object_weight``] over the batch's queries, mask BCE and
dice over the matched pairs, the score's MSE (on sigmoid(score), the
configuration's ``assumed.score_sigmoid``) to the IoU over the pairs of IoU
above 0.5, each element's share divided by the element count, weights
``loss_weight``, summed over every prediction.

The steps follow the program's records: each matching takes the program's
assignment (query rows and instance labels), and each cross-attention the
program's recorded mask where one is given, so that a near-tie of random
weights or a mask entry on the sign's edge moves neither the loss nor the
next layer.  Against them the reference reports its own: ``match_gap`` (its
cost of the program's assignment less its own optimum, over the optimum;
1 where the program's assignment is no complete matching of the
reference's targets) and ``mask_flip`` (the share of (query, key) entries
where its own mask differs from the program's).

``quant="fp8"`` computes the products of the backbone (``reference/
unet.py``) and the decoder (linears, attention, mask products) on float8
e4m3 operands with float8 e5m2 gradients: the control.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .sparse import topology
from .training import lr_at
from .unet import Fp8Matmul, Fp8Round, Net
from .unet import param_spec as unet_spec

LN_EPS = 1e-5
TRAINABLE = ("conv", "xavier", "head", "bias", "bn_weight", "bn_bias",
             "linear", "lbias", "ln_weight", "ln_bias", "embed", "axavier")
ATTN_ELEMS = 1 << 26        # score entries of one block of queries


def param_spec(model: dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind, fan) of every parameter and buffer, under the
    program's state_dict names: the U-Net's (without its point heads) and
    the decoder's under ``spformer.``."""
    c, nb = int(model["channels"]), int(model["num_blocks"])
    spec = OrderedDict((k, v) for k, v in unet_spec(c, nb).items()
                       if not k.startswith(("semantic_linear",
                                            "offset_linear")))
    cfg = model["spformer"]
    d, hid = int(cfg["d_model"]), int(cfg["hidden_dim"])

    def lin(pre, cin, cout, kind="linear"):
        spec[f"spformer.{pre}.weight"] = ((cout, cin), kind,
                                          cin + cout if kind == "axavier"
                                          else cin)
        spec[f"spformer.{pre}.bias"] = ((cout,), "lbias", cin)

    def ln(pre):
        spec[f"spformer.{pre}.weight"] = ((d,), "ln_weight", d)
        spec[f"spformer.{pre}.bias"] = ((d,), "ln_bias", d)

    def mha(pre):
        spec[f"spformer.{pre}.attn.in_proj_weight"] = ((3 * d, d), "axavier",
                                                       4 * d)
        spec[f"spformer.{pre}.attn.in_proj_bias"] = ((3 * d,), "lbias", d)
        lin(f"{pre}.attn.out_proj", d, d, "axavier")
        ln(f"{pre}.norm")

    lin("input_proj.0", c, d)
    ln("input_proj.1")
    lin("x_mask.0", c, d)
    lin("x_mask.2", d, d)
    spec["spformer.query.weight"] = ((int(cfg["num_query"]), d), "embed", d)
    n = int(cfg["num_layer"])
    for i in range(n):
        mha(f"cross_attn_layers.{i}")
    for i in range(n):
        mha(f"self_attn_layers.{i}")
    for i in range(n):
        lin(f"ffn_layers.{i}.net.0", d, hid, "axavier")
        lin(f"ffn_layers.{i}.net.3", hid, d, "axavier")
        ln(f"ffn_layers.{i}.norm")
    ln("out_norm")
    lin("out_cls.0", d, d)
    lin("out_cls.2", d, 2)
    lin("out_score.0", d, d)
    lin("out_score.2", d, 1)
    return spec


def make_weights(seed: int, device, spec) -> "OrderedDict[str, torch.Tensor]":
    """Every leaf from ``seed``: one draw of uniform numbers on ``device``,
    cut into the leaves and scaled as each kind asks (the U-Net's kinds as
    ``reference/unet.py`` scales them; linears and their biases as PyTorch
    initialises them, bound 1 / sqrt(fan in); the attention's and FFN's
    matrices xavier-uniform; the query embedding of unit variance;
    LayerNorm scales near 1 and shifts near 0)."""
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
        elif kind in ("xavier", "axavier"):
            x = x * (6.0 / fan) ** 0.5
        elif kind == "head":
            x = x * 0.01 * 3.0 ** 0.5
        elif kind == "bias":
            x = x * 0.01
        elif kind in ("linear", "lbias"):
            x = x * fan ** -0.5
        elif kind == "embed":
            x = x * 3.0 ** 0.5
        elif kind in ("bn_weight", "bn_var", "ln_weight"):
            x = 1.0 + 0.2 * x
        else:   # bn_bias, bn_mean, ln_bias
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


class Backbone(Net):
    """``reference/unet.py``'s network up to its output BatchNorm and
    ReLU."""

    def voxels(self) -> torch.Tensor:
        lv0 = self.topo.levels[0]
        x = torch.ones((lv0.keys.shape[0], 4), device=lv0.keys.device)
        x = self.conv(x, self.p["input_conv.0.weight"], lv0.rule)
        x = self.ublock(x, "unet", 0)
        return torch.relu(self.bn(x, "output_layer.0"))


def closed_of(p: torch.Tensor) -> torch.Tensor:
    a = torch.sigmoid(p) < 0.5
    full = a.sum(-1) == a.shape[-1]
    a[full] = False
    return a


def _attend_block(q, k, v, closed, scale, fp8):
    r = Fp8Round.apply if fp8 else (lambda t: t)
    s = (r(q) @ r(k).transpose(1, 2)) * scale
    if closed is not None:
        s = s.masked_fill(closed[None], float("-inf"))
    return r(torch.softmax(s, -1)) @ r(v)


class Decoder:
    """The decoder over one batch element's voxel features."""

    def __init__(self, params: dict, cfg: dict, quant: str = "none"):
        self.p = params
        self.h = int(cfg["nhead"])
        self.n_layer = int(cfg["num_layer"])
        self.fp8 = quant == "fp8"

    def mm(self, x, w):
        return Fp8Matmul.apply(x, w) if self.fp8 else x @ w

    def lin(self, x, pre):
        p = self.p
        return self.mm(x, p[f"spformer.{pre}.weight"].t()) + \
            p[f"spformer.{pre}.bias"]

    def ln(self, x, pre):
        p = self.p
        return F.layer_norm(x, (x.shape[-1],), p[f"spformer.{pre}.weight"],
                            p[f"spformer.{pre}.bias"], LN_EPS)

    def mha(self, xq, xkv, pre, closed):
        p = self.p
        d = xq.shape[1]
        w = p[f"spformer.{pre}.attn.in_proj_weight"]
        bias = p[f"spformer.{pre}.attn.in_proj_bias"]
        q = self.mm(xq, w[:d].t()) + bias[:d]
        k = self.mm(xkv, w[d:2 * d].t()) + bias[d:2 * d]
        v = self.mm(xkv, w[2 * d:].t()) + bias[2 * d:]
        h = self.h
        q, k, v = (t.view(t.shape[0], h, d // h).transpose(0, 1)
                   for t in (q, k, v))
        scale = (d // h) ** -0.5
        blk = max(1, ATTN_ELEMS // max(h * k.shape[1], 1))
        outs = []
        for i in range(0, q.shape[1], blk):
            c = None if closed is None else closed[i:i + blk]
            outs.append(checkpoint(_attend_block, q[:, i:i + blk], k, v, c,
                                   scale, self.fp8, use_reentrant=False))
        o = torch.cat(outs, 1).transpose(0, 1).reshape(-1, d)
        return self.lin(o, f"{pre}.attn.out_proj")

    def predict(self, q, mfeat):
        qn = self.ln(q, "out_norm")
        cls = self.lin(torch.relu(self.lin(qn, "out_cls.0")), "out_cls.2")
        score = self.lin(torch.relu(self.lin(qn, "out_score.0")),
                         "out_score.2")[:, 0]
        return cls, score, self.mm(qn, mfeat.t())

    def forward(self, x, masks=None, keep=None):
        """[(cls (Q, 2), score (Q,), P (Q, K))] of every prediction, or what
        ``keep(layer, cls, score, P)`` keeps of each, and the reference's own
        closed masks; the cross-attention of layer l takes ``masks[l]`` (the
        program's) where given, else its own."""
        src = torch.relu(self.ln(self.lin(x, "input_proj.0"),
                                 "input_proj.1"))
        mfeat = self.lin(torch.relu(self.lin(x, "x_mask.0")), "x_mask.2")
        q = self.p["spformer.query.weight"]
        preds, own = [], []
        for layer in range(self.n_layer + 1):
            if layer > 0:
                closed = own[-1] if masks is None else masks[layer - 1]
                i = layer - 1
                q = self.ln(q + self.mha(q, src, f"cross_attn_layers.{i}",
                                         closed),
                            f"cross_attn_layers.{i}.norm")
                q = self.ln(q + self.mha(q, q, f"self_attn_layers.{i}",
                                         None),
                            f"self_attn_layers.{i}.norm")
                h = F.gelu(self.lin(q, f"ffn_layers.{i}.net.0"))
                q = self.ln(q + self.lin(h, f"ffn_layers.{i}.net.3"),
                            f"ffn_layers.{i}.norm")
            cls, score, pm = self.predict(q, mfeat)
            if layer < self.n_layer:
                own.append(closed_of(pm.detach()))
            preds.append(keep(layer, cls, score, pm) if keep
                         else (cls, score, pm))
        return preds, own


def element_ranges(topo, n_elems: int):
    b = topo.levels[0].bxyz[:, 0]
    cnt = torch.bincount(b, minlength=n_elems).tolist()
    ends = np.cumsum(cnt).tolist()
    return [(e - n, e) for e, n in zip(ends, cnt)]


def targets(topo, inst, bid, valid, ranges):
    """Per element, (its kept instance labels (G,), targets (G, K) float32)
    by the majority rule over every valid point of a voxel."""
    v2p = topo.v2p
    out = []
    for b, (s, e) in enumerate(ranges):
        sel = valid & (bid == b) & (v2p >= 0)
        vox = v2p[sel] - s
        lab = inst[sel]
        n_pts = torch.zeros(e - s, device=vox.device).index_add_(
            0, vox, torch.ones_like(vox, dtype=torch.float32))
        labels, rows = [], []
        for g in torch.unique(lab).tolist():
            if g in (0, -1):
                continue
            hit = torch.zeros(e - s, device=vox.device).index_add_(
                0, vox[lab == g], torch.ones(int((lab == g).sum()),
                                             device=vox.device))
            t = (hit / n_pts.clamp(min=1.0) > 0.5).float()
            if t.sum() > 0:
                labels.append(g)
                rows.append(t)
        t = (torch.stack(rows) if rows
             else torch.zeros((0, e - s), device=vox.device))
        out.append((np.asarray(labels, np.int64), t))
    return out


def cost_matrix(cls, pm, t, weights):
    """SPFormer's matching cost (Q, G) in float32."""
    k = pm.shape[1]
    pos = F.binary_cross_entropy_with_logits(pm, torch.ones_like(pm),
                                             reduction="none")
    neg = F.binary_cross_entropy_with_logits(pm, torch.zeros_like(pm),
                                             reduction="none")
    bce = (pos @ t.t() + neg @ (1 - t).t()) / k
    sig = torch.sigmoid(pm)
    dice = 1 - (2 * sig @ t.t() + 1) / (sig.sum(-1)[:, None]
                                        + t.sum(-1)[None, :] + 1)
    p_tree = torch.softmax(cls, -1)[:, 0]
    return (weights[0] * -p_tree[:, None] + weights[1] * bce
            + weights[2] * dice)


def match_gap(cost: np.ndarray, rows, cols) -> float:
    """(the cost of the matching (rows, cols) - the least cost) / |least
    cost|; 1 where (rows, cols) is no complete matching."""
    from scipy.optimize import linear_sum_assignment

    if cost.shape[1] == 0:
        return 0.0 if len(rows) == 0 else 1.0
    r, c = linear_sum_assignment(cost)
    best = float(cost[r, c].sum())
    if (len(rows) != len(r) or len(set(rows)) != len(rows)
            or len(set(cols)) != len(cols) or min(cols, default=0) < 0):
        return 1.0
    got = float(cost[rows, cols].sum())
    return max(got - best, 0.0) / max(abs(best), 1e-12)


def spformer_loss(preds, tgts, assign, crit, record_terms=None):
    """Loss of every prediction under the program's assignment: ``preds``
    per element [(cls, score, P_rows)] per prediction (``P_rows`` the mask
    logits of the assignment's query rows, in its order), ``tgts`` per
    element (labels, t), ``assign`` per prediction per element (rows, cols
    into the reference's targets); each term's sum over the predictions goes
    into ``record_terms`` where given."""
    w = [float(x) for x in crit["loss_weight"]]
    n_el = len(preds)
    total = 0.0
    terms = {"class_loss": 0.0, "bce_loss": 0.0, "dice_loss": 0.0,
             "score_loss": 0.0}
    cw = torch.tensor([1.0, float(crit["non_object_weight"])],
                      device=tgts[0][1].device)
    for lp in range(len(preds[0])):
        logits, labels = [], []
        bce = dice = score = 0.0
        for b in range(n_el):
            cls, sc, pm = preds[b][lp]
            rows, cols = assign[lp][b]
            tgt = torch.ones(cls.shape[0], dtype=torch.long,
                             device=cls.device)
            logits.append(cls)
            if len(rows):
                r = torch.as_tensor(rows, device=cls.device)
                tgt[r] = 0
                pr = pm
                tr = tgts[b][1][torch.as_tensor(cols, device=cls.device)]
                bce = bce + F.binary_cross_entropy_with_logits(pr, tr)
                sig = torch.sigmoid(pr)
                dice = dice + (1 - (2 * (sig * tr).sum(-1) + 1)
                               / (sig.sum(-1) + tr.sum(-1) + 1)).mean()
                with torch.no_grad():
                    on = (sig > 0.5).float()
                    inter = (on * tr).sum(-1)
                    iou = inter / (tr.sum(-1) + on.sum(-1) - inter)
                keep = iou > 0.5
                if bool(keep.any()):
                    score = score + F.mse_loss(torch.sigmoid(sc[r][keep]),
                                               iou[keep])
            labels.append(tgt)
        cls_loss = F.cross_entropy(torch.cat(logits), torch.cat(labels),
                                   weight=cw)
        parts = (w[0] * cls_loss, w[1] * bce / n_el, w[2] * dice / n_el,
                 w[3] * score / n_el)
        for k, v in zip(terms, parts):
            terms[k] += float(v.detach()) if torch.is_tensor(v) else v
        total = total + sum(parts)
    if record_terms is not None:
        record_terms.update({k: round(v, 6) for k, v in terms.items()})
    return total


def train_steps(params0: dict, spec: dict, batches, records, cfg: dict,
                device, quant: str = "none", step_grads=None,
                own_masks: bool = False):
    """Run one step per batch from ``params0`` on the program's records
    (per step: ``masks`` per layer per element, ``assignments`` per
    prediction per element as (rows, labels)).  Returns (losses, the first
    step's clipped gradient per leaf, the leaves after the last step, the
    first step's last prediction per element (cls, score, P), and
    ``stats``: per step the mask flips and entries, the worst match gap,
    the open pairs per layer of the reference's own masks).  With
    ``own_masks`` every cross-attention takes the reference's own mask."""
    model = cfg["model"]
    crit = dict(model["spformer"])
    L = int(model["num_blocks"])
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
    clip = (1.0 if cfg.get("grad_norm_clip") is True
            else cfg.get("grad_norm_clip"))
    losses, first_grad, first_out, stats = [], None, None, []
    for t, (batch, rec) in enumerate(zip(batches, records)):
        keys = ("coords", "batch_ids", "valid", "instance_labels")
        bt = {k: torch.from_numpy(np.asarray(batch[k])).to(device)
              for k in keys}
        n_el = int(batch["batch_size"])
        topo = topology(bt["coords"], bt["batch_ids"], bt["valid"], n_el,
                        float(model["voxel_size"]), L,
                        model.get("spatial_shape"))
        x = Backbone(params, topo, L, training=True, quant=quant).voxels()
        ranges = element_ranges(topo, n_el)
        tg = targets(topo, bt["instance_labels"].long(),
                     bt["batch_ids"].long(), bt["valid"], ranges)
        dec = Decoder(params, crit, quant)
        # the program's assignment in the reference's target columns
        assign = []
        for lp in range(int(crit["num_layer"]) + 1):
            row = []
            for b in range(n_el):
                rows, labs = rec["assignments"][lp][b]
                pos = {int(g): i for i, g in enumerate(tg[b][0])}
                row.append((list(rows), [pos.get(int(g), -1) for g in labs]))
            assign.append(row)
        gaps, last = [], []

        def keep(layer, cls, score, pm, b):
            """The matching's gap of one prediction, and the logits the loss
            reads: the assignment's rows of P (the rest is freed)."""
            rows, cols = assign[layer][b]
            with torch.no_grad():
                c = cost_matrix(cls, pm, tg[b][1], crit["cost_weight"])
            gaps.append(match_gap(c.double().cpu().numpy(), rows, cols))
            if first_out is None and layer == int(crit["num_layer"]):
                last.append((cls.detach(), score.detach(), pm.detach()))
            ok = [r for r, c_ in zip(rows, cols) if c_ >= 0]
            return cls, score, pm[torch.as_tensor(ok, dtype=torch.long,
                                                  device=pm.device)]

        preds, flips, entries = [], 0, 0
        opens = np.zeros(int(crit["num_layer"]), np.int64)
        for b, (s, e) in enumerate(ranges):
            given = None if own_masks else [
                mk[b].to(device) for mk in rec["masks"]]
            pb, own = dec.forward(
                x[s:e], given,
                lambda layer, cls, sc, pm, b=b: keep(layer, cls, sc, pm, b))
            preds.append(pb)
            for lyr, a in enumerate(own):
                opens[lyr] += int((~a).sum())
                if given is not None:
                    flips += int((a != given[lyr]).sum())
                    entries += a.numel()
            del own, given
        gap = max(gaps)
        assign = [[([r for r, c_ in zip(rows, cols) if c_ >= 0],
                    [c_ for c_ in cols if c_ >= 0]) for rows, cols in row]
                  for row in assign]
        if first_out is None:
            first_out = last
        terms = {}
        loss = spformer_loss(preds, tg, assign, crit, terms)
        stats.append({"flips": flips, "entries": entries, "match_gap": gap,
                      "open_pairs": opens, "terms": terms})
        grads = torch.autograd.grad(loss, [params[k] for k in leaves],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(leaves, grads)]
        if step_grads is not None:
            step_grads.append({k: g.detach().clone()
                               for k, g in zip(leaves, grads)})
        if clip:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = (1.0 if float(norm) < float(clip)
                     else float(clip) / float(norm))
            grads = [g * scale for g in grads]
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(leaves, grads)}
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
        del preds, x, loss, grads
    return (losses, first_grad, {k: params[k].detach() for k in leaves},
            first_out, stats)
