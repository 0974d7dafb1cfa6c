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


def point_wise_loss_sums(semantic_prediction_logits: torch.Tensor,  # (N, 2)
                         offset_predictions: torch.Tensor,          # (N, 3)
                         masks_sem: torch.Tensor,                   # (N,) bool
                         masks_off: torch.Tensor,                   # (N,) bool
                         semantic_labels: torch.Tensor,             # (N,) int
                         offset_labels: torch.Tensor,               # (N, 3)
                         weights: Optional[torch.Tensor] = None):
    """(4,) masked sums [sum ce * m_sem, sum m_sem, sum dist * m_off,
    sum m_off], whose ratios are the two losses (:func:`masked_means`).
    The data-parallel step adds them over ranks before it divides
    (parallel/mesh.py)."""
    logits = semantic_prediction_logits.float()
    offs = offset_predictions.float()
    labels = torch.clamp(semantic_labels.long(), 0, logits.shape[1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    if weights is not None:
        ce = ce * weights
    msem = masks_sem.float()
    dist = torch.sqrt(torch.square(offs - offset_labels.float()).sum(1)
                      + 1e-12)
    moff = masks_off.float()
    return torch.stack([(ce * msem).sum(), msem.sum(), (dist * moff).sum(),
                        moff.sum()])


def masked_means(sums: torch.Tensor):
    """(semantic_loss, offset_loss) from :func:`point_wise_loss_sums`: each
    sum over its count, zero (with a zero gradient) when the count is 0."""
    semantic_loss = torch.where(
        sums[1] > 0, sums[0] / torch.clamp(sums[1], min=1.0), 0.0)
    offset_loss = torch.where(
        sums[3] > 0, sums[2] / torch.clamp(sums[3], min=1.0), 0.0)
    return semantic_loss, offset_loss


def point_wise_loss(semantic_prediction_logits: torch.Tensor,  # (N, 2)
                    offset_predictions: torch.Tensor,          # (N, 3)
                    masks_sem: torch.Tensor,                   # (N,) bool
                    masks_off: torch.Tensor,                   # (N,) bool
                    semantic_labels: torch.Tensor,             # (N,) int
                    offset_labels: torch.Tensor,               # (N, 3)
                    weights: Optional[torch.Tensor] = None):
    return masked_means(point_wise_loss_sums(
        semantic_prediction_logits, offset_predictions, masks_sem, masks_off,
        semantic_labels, offset_labels, weights))


def total_loss(semantic_loss, offset_loss):
    """Combined objective (reference tree_learn.py:107-126)."""
    loss_dict = {"semantic_loss": semantic_loss * LOSS_MULTIPLIER_SEMANTIC,
                 "offset_loss": offset_loss}
    return sum(loss_dict.values()), loss_dict
