"""Training: losses, optimizer and schedule, train/eval steps, self-training
on synthetic forests (port of treelearn_tpu/train)."""

from .losses import LOSS_MULTIPLIER_SEMANTIC, point_wise_loss, total_loss  # noqa: F401
