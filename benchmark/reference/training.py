"""Plain training steps of the TreeLearn network (github.com/ecker-lab/TreeLearn,
tree_learn/util/train.py and tree_learn.py): the forward of
``reference/unet.py`` in training mode, the loss, autograd's gradients in
float32, global-norm clipping to 1.0, AdamW with decoupled weight decay and
the epoch-indexed cosine schedule with linear warm-up (timm's
CosineLRScheduler, t_in_epochs).

Loss: 50 x the mean cross-entropy of the semantic logits over the points of
``masks_sem`` plus the mean Euclidean distance of the offsets to their
labels over the points of ``masks_off`` (each zero on an empty mask).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .sparse import topology
from .unet import Net

SEMANTIC_WEIGHT = 50.0
_EPS32 = float(np.finfo(np.float32).eps)
TRAINABLE = ("conv", "xavier", "head", "bias", "bn_weight", "bn_bias")


def lr_at(step: int, optimizer_cfg: dict, scheduler_cfg: dict,
          steps_per_epoch: int) -> float:
    base = float(optimizer_cfg["lr"])
    epoch = step // steps_per_epoch
    warm = int(scheduler_cfg.get("warmup_t", 0))
    if epoch < warm:
        w0 = float(scheduler_cfg.get("warmup_lr_init", 0.0))
        return w0 + (base - w0) * epoch / warm
    lo = float(scheduler_cfg.get("lr_min", 0.0))
    t = min(max(epoch / int(scheduler_cfg["t_initial"]), 0.0), 1.0)
    return lo + 0.5 * (base - lo) * (1.0 + math.cos(math.pi * t))


def loss_of(sem, off, b):
    sel_s = b["masks_sem"] & b["valid"]
    sel_o = b["masks_off"] & b["valid"]
    logp = torch.log_softmax(sem, 1)
    lab = b["semantic_labels"].long().clamp(0, 1)
    ce = -logp.gather(1, lab[:, None])[:, 0]
    ns, no = sel_s.sum(), sel_o.sum()
    sem_loss = (ce * sel_s).sum() / ns.clamp(min=1) if ns > 0 else ce.sum() * 0
    dist = torch.sqrt(((off - b["offset_labels"]) ** 2).sum(1) + 1e-12)
    off_loss = (dist * sel_o).sum() / no.clamp(min=1) if no > 0 else dist.sum() * 0
    return SEMANTIC_WEIGHT * sem_loss + off_loss


def to_tensors(batch: dict, device) -> dict:
    keys = ("coords", "batch_ids", "valid", "masks_sem", "masks_off",
            "semantic_labels", "offset_labels")
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys}


def train_steps(params0: dict, spec: dict, batches, cfg: dict, device,
                quant: str = "none"):
    """Run one step per batch from ``params0``; returns (losses, the first
    step's clipped gradient per leaf, the leaves after the last step, the
    first step's semantic logits and offsets)."""
    model = cfg["model"]
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
    clip = 1.0 if cfg.get("grad_norm_clip") is True else cfg.get("grad_norm_clip")
    losses, first_grad, first_out = [], None, None
    for t, batch in enumerate(batches):
        b = to_tensors(batch, device)
        topo = topology(b["coords"], b["batch_ids"], b["valid"],
                        int(batch["batch_size"]), float(model["voxel_size"]),
                        L, model.get("spatial_shape"))
        sem, off = Net(params, topo, L, training=True,
                       quant=quant).forward(b["valid"])
        if first_out is None:
            first_out = (sem.detach(), off.detach())
        loss = loss_of(sem, off, b)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(leaves, grads)]
        if clip:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = 1.0 if float(norm) < float(clip) else float(clip) / float(norm)
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
    return (losses, first_grad, {k: params[k].detach() for k in leaves},
            first_out)


def output_gaps(prog, ref, valid) -> tuple:
    """(rms, max) over the two heads of a forward's outputs: the RMS of
    (prog - ref) over the RMS of ref, and the largest |prog - ref| over the
    largest |ref|, over the valid points."""
    rms, mx = 0.0, 0.0
    for a, b in zip(prog, ref):
        a, b = a[valid].double(), b[valid].double()
        d = a - b
        rms = max(rms, float(d.square().mean().sqrt()
                             / b.square().mean().sqrt().clamp(min=1e-30)))
        mx = max(mx, float(d.abs().max() / b.abs().max().clamp(min=1e-30)))
    return rms, mx


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """[(gap, leaf)] worst first, of per-leaf norms: |norm(prog) -
    norm(ref)| over the larger of the leaf's reference norm and the median
    leaf's, over the leaves in ``keep`` (default all)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return sorted(((abs(float(prog[k].double().norm()) - rn[k])
                    / max(rn[k], med, 1e-30), k) for k in names),
                  reverse=True)


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(worst gap, its leaf) of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, keep)
    return gaps[0] if gaps else (0.0, None)


def labels_of(xyz: np.ndarray, inst: np.ndarray, inner_edge: float,
              lean: int = 0):
    """Per point of one sample: semantic label (0 tree, 1 non-tree), offset
    to its tree's base (the mean of its points within 0.5 m above
    ``np.partition(z, 10)[3]``, upstream's floor for trees of more than 11
    points, or above the lowest point) and the inner, semantic and offset
    masks (upstream dataset.py:111-164).

    ``lean`` places the points that lie within float32 rounding of a
    boundary, the inner square's edge or a tree's floor + 0.5 m: 0 where
    their coordinates say, -1 all outside, +1 all inside.  A loader that
    decides on float64 coordinates and ships them as float32 may put such
    a point on either side."""
    sem = np.where(inst == 0, 1, 0)
    pos = np.ones_like(xyz)
    ok = np.zeros(len(xyz), bool)
    for t in np.unique(inst):
        if t == 0:
            continue
        rows = np.where(inst == t)[0]
        z = xyz[rows, 2]
        zmin = np.partition(z, 10)[3] if len(rows) > 11 else z.min()
        tol = lean * _EPS32 * (2.0 * abs(zmin) + 1.0)
        low = xyz[rows][z <= zmin + 0.5 + tol]
        if len(low):
            pos[rows] = low.mean(0)
            ok[rows] = True
        else:
            pos[rows] = 0.0
    off = pos - xyz
    half = inner_edge / 2
    inner = np.abs(xyz[:, :2]).max(1) <= half + lean * _EPS32 * half
    known = inst != -1
    return sem, off, inner & known, inner & known & (sem != 1) & ok


def loader_miss(batch: dict, inner_edge: float) -> float:
    """Share of a batch's points whose semantic label or masks differ from
    those worked out again from its coordinates and instance labels, or
    whose offset label is more than 1 mm away.  A point within float32
    rounding of a boundary counts where neither side's labels
    (:func:`labels_of` with ``lean`` -1 and +1) are the batch's."""
    n = int(batch["n_points"])
    bid = np.asarray(batch["batch_ids"])[:n]
    xyz = np.asarray(batch["coords"], np.float64)[:n]
    inst = np.asarray(batch["instance_labels"])[:n]
    got = {k: np.asarray(batch[k])[:n] for k in (
        "semantic_labels", "offset_labels", "masks_sem", "masks_off")}
    bad = 0
    for b in np.unique(bid):
        r = bid == b
        miss = None
        for lean in (-1, 1):
            sem, off, ms, mo = labels_of(xyz[r], inst[r], inner_edge, lean)
            d = np.abs(got["offset_labels"][r] - off).max(1)
            m = ((got["semantic_labels"][r] != sem)
                 | (got["masks_sem"][r] != ms)
                 | (got["masks_off"][r] != mo) | (d > 1e-3))
            miss = m if miss is None else miss & m
        bad += int(miss.sum())
    return bad / max(n, 1)
