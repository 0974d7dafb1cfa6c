"""SPFormer's training loss (Sun et al., AAAI 2023; its
``spformer/model/loss.py``): voxel targets, the bipartite matching of the
queries to them, and the matched mask, class and score losses.

* Targets: each tree instance of a batch element (instance labels other
  than non-tree 0 and ignore -1, over the whole crop) is one target;
  ``t_g(v) = 1`` where more than half of voxel v's points carry label g
  (SPFormer's ``scatter_mean(gt_mask, superpoint) > 0.5``, every 0.1 m voxel
  its own superpoint; the count is over every valid point of the voxel).
  A target with no voxel is dropped.  Every target's class is tree.
* Matching, for each of the 1 + ``num_layer`` predictions and each element:
  ``C = w0 (-softmax(cls)[:, tree]) + w1 BCE_cost + w2 Dice_cost`` (Q, G),
  ``BCE_cost`` the mean over the element's keys of BCE-with-logits,
  ``Dice_cost = 1 - (2 sigma(P) t^T + 1) / (sum sigma(P) + sum t + 1)``,
  solved by ``scipy.optimize.linear_sum_assignment``.  All the step's cost
  matrices (with the target sizes, the masks' open pairs and their skipped
  and total tiles) go to the host in one read, under the span
  ``spformer.match``: the mechanism's one host read a step.
* Loss of a prediction (span ``spformer.loss``): ``l0 class + l1 bce + l2
  dice + l3 score``; class: cross-entropy of every query of the batch
  (matched: tree, the rest: no-object), class weights [1,
  ``non_object_weight``] as a weighted mean over the batch's queries (as
  SPFormer's ``F.cross_entropy`` over (B, 2, Q)); bce and dice: the mean
  over an element's matched pairs of the mean over its keys and of the dice
  loss; score: the MSE of sigmoid(score) to the IoU of ``P > 0`` with the
  target over the matched pairs of IoU above 0.5 (0 without one); bce, dice
  and score summed over the elements and divided by their number.  The
  step's loss is the sum over the predictions.  Costs and losses are
  float32; the matched rows' mask logits are computed again from the
  normalized queries, so that the gradient reaches only those rows.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.trace import count, span

NON_TREE, IGNORE = 0, -1


def instance_table(batch: dict):
    """(dense instance id of every point (N,) int64, -1 outside any
    instance; the instance labels of each batch element, sorted), from the
    loader's host arrays: element b's instances take the ids after those of
    the elements before it."""
    inst = np.asarray(batch["instance_labels"]).astype(np.int64)
    bid = np.asarray(batch["batch_ids"])
    valid = np.asarray(batch["valid"], bool)
    ids = np.full(inst.shape, -1, np.int64)
    per_elem, off = [], 0
    for b in range(int(batch["batch_size"])):
        rows = np.flatnonzero(valid & (bid == b) & (inst != NON_TREE)
                              & (inst != IGNORE))
        lab = inst[rows]
        if len(lab) and lab.min() >= 0 and lab.max() < 1 << 22:
            present = np.bincount(lab) > 0
            uniq = np.flatnonzero(present)
            lut = np.cumsum(present) - 1
            ids[rows] = off + lut[lab]
        else:
            uniq, inv = np.unique(lab, return_inverse=True)
            ids[rows] = off + inv
        per_elem.append(uniq)
        off += len(uniq)
    return ids, per_elem


def voxel_targets(v2p: torch.Tensor, ids: torch.Tensor, ranges,
                  counts) -> List[torch.Tensor]:
    """Per element, its targets (G_b, K_b) float32 of 0 and 1: voxel v is
    in target g where more than half of its valid points carry instance
    g.  ``v2p`` the voxelization's point -> voxel map (invalid points: the
    voxel count), ``ids`` :func:`instance_table`'s ids; no host read."""
    n_vox = ranges[-1][1] if ranges else 0
    g_all = int(sum(counts))
    dev = v2p.device
    live = v2p < n_vox
    n_pts = torch.zeros(n_vox + 1, device=dev).index_add_(
        0, torch.where(live, v2p, n_vox), live.float())[:n_vox]
    has = live & (ids >= 0)
    slot = torch.where(has, v2p * g_all + ids, n_vox * g_all)
    hits = torch.zeros(n_vox * g_all + 1, device=dev).index_add_(
        0, slot, has.float())[:-1].view(n_vox, g_all)
    win = hits * 2 > n_pts[:, None]
    out, off = [], 0
    for (s, e), g in zip(ranges, counts):
        out.append(win[s:e, off:off + g].t().float())
        off += g
    return out


def match_cost(p: torch.Tensor, t: torch.Tensor, p_tree: torch.Tensor,
               weights) -> torch.Tensor:
    """The (Q, G) cost of mask logits ``p`` (Q, K) against targets ``t``
    (G, K) and the queries' tree probabilities: ``softplus(-p) t^T +
    softplus(p) (1 - t)^T`` written as ``rowsum(softplus(p)) - p t^T``."""
    k = p.shape[1]
    bce = (F.softplus(p).sum(1, keepdim=True) - p @ t.t()) / k
    sig = torch.sigmoid(p)
    dice = 1.0 - (2.0 * (sig @ t.t()) + 1.0) / (
        sig.sum(1, keepdim=True) + t.sum(1)[None] + 1.0)
    w_cls, w_bce, w_dice = (float(w) for w in weights)
    return w_cls * -p_tree[:, None] + w_bce * bce + w_dice * dice


def assign(cost: np.ndarray, sizes: np.ndarray):
    """(query rows, target columns) of the least-cost matching of the
    non-empty targets."""
    from scipy.optimize import linear_sum_assignment

    keep = np.flatnonzero(sizes > 0)
    if not len(keep):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows, cols = linear_sum_assignment(cost[:, keep])
    return rows.astype(np.int64), keep[cols].astype(np.int64)


def spformer_loss(output: dict, batch: dict):
    """(loss, {class_loss, bce_loss, dice_loss, score_loss}) of the
    decoder's predictions against the batch's instances (``instance_ids``
    and ``instance_elems``, :func:`instance_table`)."""
    crit = output["criterion"]
    w_cls, w_bce, w_dice, w_score = (float(w) for w in crit["loss_weight"])
    ranges = output["voxel_ranges"]
    labels = batch["instance_elems"]
    counts = [len(x) for x in labels]
    n_pred, n_el = len(output["pred_logits"]), len(ranges)
    n_q = output["pred_logits"][0].shape[1]
    rec = output.get("record")
    with span("spformer.match"):
        with torch.no_grad():
            t = voxel_targets(output["v2p_map"], batch["instance_ids"],
                              ranges, counts)
            parts = []
            for lp in range(n_pred):
                p_tree = torch.softmax(output["pred_logits"][lp], -1)[..., 0]
                for b in range(n_el):
                    parts.append(match_cost(
                        output["pred_masks"][lp][b], t[b], p_tree[b],
                        crit["cost_weight"]).flatten())
            parts += [tb.sum(1) for tb in t]
            n_layer = 0
            if output.get("open_pairs") is not None:
                n_layer = len(output["open_pairs"])
                parts += [output["open_pairs"],
                          output["mask_tiles"].flatten()]
            host = torch.cat([x.double() for x in parts]).cpu().numpy()
        pos, costs = 0, []
        for lp in range(n_pred):
            for b in range(n_el):
                n = n_q * counts[b]
                costs.append(host[pos:pos + n].reshape(n_q, counts[b]))
                pos += n
        sizes = []
        for b in range(n_el):
            sizes.append(host[pos:pos + counts[b]])
            pos += counts[b]
        opens = host[pos:pos + n_layer]
        tiles = host[pos + n_layer:].reshape(n_layer, 2)
        pairs = [assign(c, sizes[i % n_el]) for i, c in enumerate(costs)]
        dev = output["pred_logits"][0].device
        flat = np.concatenate([np.concatenate(p) for p in pairs]
                              + [np.zeros(0, np.int64)])
        idx = torch.from_numpy(flat)
        if dev.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(dev, non_blocking=True)
    for layer, (n, (empty, every)) in enumerate(zip(opens, tiles), start=1):
        count(f"spformer.open_pairs.l{layer}", int(n))
        count(f"spformer.mask_attn.tiles_skipped.l{layer}", int(empty))
        count(f"spformer.mask_attn.tiles.l{layer}", int(every))
    count("spformer.targets", sum(int((s > 0).sum()) for s in sizes))
    count("spformer.matched", sum(len(r) for r, _ in pairs))
    if rec is not None:
        rec["assignments"] = [
            [(pairs[lp * n_el + b][0], labels[b][pairs[lp * n_el + b][1]])
             for b in range(n_el)] for lp in range(n_pred)]
        rec["open_pairs"] = opens.astype(np.int64)

    with span("spformer.loss"):
        mfeat = output["mask_feats"]
        class_w = torch.tensor([1.0, float(crit["non_object_weight"])],
                               device=dev)
        # the index tensor's slices of each matching: rows, then columns
        views, pos = [], 0
        for rows, cols in pairs:
            m = len(rows)
            views.append((idx[pos:pos + m], idx[pos + m:pos + 2 * m], m))
            pos += 2 * m
        # every prediction's matched rows of an element in one product
        logits = {}
        for b, (s, e) in enumerate(ranges):
            sel = [(lp, views[lp * n_el + b]) for lp in range(n_pred)
                   if views[lp * n_el + b][2]]
            if not sel:
                continue
            qn = torch.cat([output["pred_queries"][lp][b].index_select(0, r)
                            for lp, (r, _, _) in sel])
            pm = (qn.to(mfeat.dtype) @ mfeat[s:e].t()).float()
            for (lp, _), chunk in zip(sel, pm.split([v[2] for _, v in sel])):
                logits[lp, b] = chunk
        terms = {"class_loss": 0.0, "bce_loss": 0.0, "dice_loss": 0.0,
                 "score_loss": 0.0}
        for lp in range(n_pred):
            cls = output["pred_logits"][lp]
            tgt = torch.ones(cls.shape[:2], dtype=torch.long, device=dev)
            bce = dice = score = 0.0
            for b in range(n_el):
                rows, cols, m = views[lp * n_el + b]
                if not m:
                    continue
                tgt[b].index_fill_(0, rows, 0)
                pm, tm = logits[lp, b], t[b].index_select(0, cols)
                bce = bce + F.binary_cross_entropy_with_logits(pm, tm)
                sig = torch.sigmoid(pm)
                dice = dice + (1.0 - (2.0 * (sig * tm).sum(1) + 1.0)
                               / (sig.sum(1) + tm.sum(1) + 1.0)).mean()
                with torch.no_grad():
                    on, tb = pm > 0, tm > 0.5
                    iou = (on & tb).sum(1).float() / (on | tb).sum(1).float()
                    good = (iou > 0.5).float()
                sc = torch.sigmoid(
                    output["pred_scores"][lp][b].index_select(0, rows))
                score = score + ((good * (sc - iou) ** 2).sum()
                                 / good.sum().clamp(min=1.0))
            terms["class_loss"] = terms["class_loss"] + w_cls * F.cross_entropy(
                cls.reshape(-1, 2).float(), tgt.reshape(-1), weight=class_w)
            terms["bce_loss"] = terms["bce_loss"] + w_bce * bce / n_el
            terms["dice_loss"] = terms["dice_loss"] + w_dice * dice / n_el
            terms["score_loss"] = terms["score_loss"] + w_score * score / n_el
        terms = {k: v if torch.is_tensor(v) else torch.zeros((), device=dev)
                 for k, v in terms.items()}
        loss = sum(terms.values())
    return loss, terms
