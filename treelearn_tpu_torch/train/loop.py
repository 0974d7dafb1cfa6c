"""Training: optimizer, LR schedule, train and eval steps (port of
treelearn_tpu/train/loop.py).

Parity targets:
* optimizer and scheduler (reference util/train.py:105-122 +
  configs/training/train.yaml): AdamW (``torch.optim.AdamW`` is the update
  of ``optax.adamw``: decoupled weight decay on every parameter) with the
  epoch-indexed timm cosine schedule (warmup from ``warmup_lr_init``,
  floor ``lr_min``), step 0 at ``schedule(0)``;
* global-norm clipping to 1.0 in the form of ``optax.clip_by_global_norm``
  (gradients scaled by ``max_norm / norm`` when ``norm >= max_norm``; no
  1e-6 added to the norm as ``torch.nn.utils.clip_grad_norm_`` does).

The JAX step gates its whole update to a no-op when a level overflowed its
static voxel capacity or a banded conv window overflowed
(loop.py:137-154).  Eager PyTorch works on exact voxel counts and the CUDA
convs read the rule directly, so nothing can overflow and the step has no
gate.  BatchNorm running statistics update in place during the forward.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.trace import span
from .losses import point_wise_loss, total_loss

_BATCH_TENSORS = ("coords", "input_feats", "batch_ids", "valid", "masks_sem",
                  "masks_off", "semantic_labels", "offset_labels")


def make_epoch_cosine_schedule(cfg, steps_per_epoch: int):
    """timm CosineLRScheduler(t_in_epochs=True) as a step-indexed function:
    the lr is a function of the epoch = step // steps_per_epoch."""
    base_lr = float(cfg["base_lr"])
    t_initial = int(cfg.get("t_initial", 1000))
    lr_min = float(cfg.get("lr_min", 5e-5))
    warmup_t = int(cfg.get("warmup_t", 0))
    warmup_lr_init = float(cfg.get("warmup_lr_init", 0.0))

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup_t:
            return warmup_lr_init + (base_lr - warmup_lr_init) * (
                epoch / max(warmup_t, 1))
        # timm default warmup_prefix=False: cosine progress counts all epochs
        progress = min(max(epoch / max(t_initial, 1), 0.0), 1.0)
        return lr_min + 0.5 * (base_lr - lr_min) * (
            1 + math.cos(math.pi * progress))

    return schedule


def build_optimizer(params, optim_cfg, scheduler_cfg=None,
                    steps_per_epoch: int = 1):
    """(AdamW, LambdaLR or None).  The scheduler is stepped once after every
    optimizer step, so step ``t`` runs at ``schedule(t)``."""
    cfg = dict(optim_cfg)
    opt_type = cfg.pop("type", "AdamW").lower()
    if opt_type != "adamw":
        raise ValueError(f"unsupported optimizer type: {opt_type}")
    lr = float(cfg.pop("lr", 1e-3))
    optimizer = torch.optim.AdamW(
        params, lr=lr, weight_decay=float(cfg.pop("weight_decay", 0.0)),
        betas=tuple(cfg.pop("betas", (0.9, 0.999))),
        eps=float(cfg.pop("eps", 1e-8)))
    if cfg:
        raise ValueError(f"unsupported optimizer options: {sorted(cfg)}")
    scheduler = None
    if scheduler_cfg is not None:
        sched_cfg = dict(scheduler_cfg)
        sched_cfg["base_lr"] = lr
        schedule = make_epoch_cosine_schedule(sched_cfg, steps_per_epoch)
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda step: schedule(step) / lr)
    return optimizer, scheduler


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so their global norm is at most
    ``max_norm`` (optax.clip_by_global_norm); returns the norm before."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def batch_to_device(batch: dict, device) -> dict:
    """The loader's numpy arrays that a step reads, as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in _BATCH_TENSORS if k in batch}


def loss_from_output(output, batch):
    sem_loss, off_loss = point_wise_loss(
        output["semantic_prediction_logits"], output["offset_predictions"],
        batch["masks_sem"] & batch["valid"],
        batch["masks_off"] & batch["valid"],
        batch["semantic_labels"], batch["offset_labels"])
    return total_loss(sem_loss, off_loss)


def make_train_step(model, optimizer, scheduler=None, *, batch_size: int,
                    compute_dtype=torch.bfloat16,
                    grad_norm_clip: Optional[float] = None, device=None):
    """One optimization step over a padded flat batch (the loader's numpy
    dict): forward in training mode, loss, backward, clip, AdamW update,
    schedule step.  Returns ``(loss, loss_dict)`` as detached tensors.
    ``grad_norm_clip=True`` means 1.0, as the reference's config does.  Its
    parts run under the spans step.h2d, step.forward, step.loss,
    step.backward, step.clip and step.optimizer (utils/trace.py)."""
    device = next(model.parameters()).device if device is None else device
    clip = (1.0 if grad_norm_clip is True
            else float(grad_norm_clip) if grad_norm_clip else None)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch):
        model.train()
        with span("step.h2d"):
            b = batch_to_device(batch, device)
        with span("step.forward"):
            output = model(b["coords"], b["input_feats"], b["batch_ids"],
                           b["valid"], batch_size=batch_size,
                           compute_dtype=compute_dtype)
        with span("step.loss"):
            loss, loss_dict = loss_from_output(output, b)
        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("step.clip"):
            if clip is not None:
                clip_by_global_norm_(params, clip)
        with span("step.optimizer"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return loss.detach(), {k: v.detach() for k, v in loss_dict.items()}

    return train_step


def make_eval_step(model, *, batch_size: int, compute_dtype=torch.float32,
                   device=None):
    """Forward in eval mode without gradients over one padded batch."""
    device = next(model.parameters()).device if device is None else device

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        b = batch_to_device(batch, device)
        return model(b["coords"], b["input_feats"], b["batch_ids"],
                     b["valid"], batch_size=batch_size,
                     compute_dtype=compute_dtype)

    return eval_step
