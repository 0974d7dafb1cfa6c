"""Point-wise losses (port of treelearn_tpu/train/losses.py).

Parity: reference tree_learn/util/train.py:145-166 and the 50x semantic
multiplier applied in the model (tree_learn.py:9,121): semantic = masked
mean cross-entropy; offset = masked mean Euclidean distance; both zero, with
a zero gradient, when the mask is empty.
"""

from __future__ import annotations

from typing import Optional

import torch

LOSS_MULTIPLIER_SEMANTIC = 50.0


def point_wise_loss(semantic_prediction_logits: torch.Tensor,  # (N, 2)
                    offset_predictions: torch.Tensor,          # (N, 3)
                    masks_sem: torch.Tensor,                   # (N,) bool
                    masks_off: torch.Tensor,                   # (N,) bool
                    semantic_labels: torch.Tensor,             # (N,) int
                    offset_labels: torch.Tensor,               # (N, 3)
                    weights: Optional[torch.Tensor] = None):
    logits = semantic_prediction_logits.float()
    offs = offset_predictions.float()
    labels = torch.clamp(semantic_labels.long(), 0, logits.shape[1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    if weights is not None:
        ce = ce * weights
    msem = masks_sem.float()
    n_sem = msem.sum()
    semantic_loss = torch.where(
        n_sem > 0, (ce * msem).sum() / torch.clamp(n_sem, min=1.0), 0.0)
    dist = torch.sqrt(torch.square(offs - offset_labels.float()).sum(1)
                      + 1e-12)
    moff = masks_off.float()
    n_off = moff.sum()
    offset_loss = torch.where(
        n_off > 0, (dist * moff).sum() / torch.clamp(n_off, min=1.0), 0.0)
    return semantic_loss, offset_loss


def total_loss(semantic_loss, offset_loss):
    """Combined objective (reference tree_learn.py:107-126)."""
    loss_dict = {"semantic_loss": semantic_loss * LOSS_MULTIPLIER_SEMANTIC,
                 "offset_loss": offset_loss}
    return sum(loss_dict.values()), loss_dict
