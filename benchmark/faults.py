"""Faults planted in the program under test, for the readings that set the
upper ends of the limits (``benchmark/control.py --fault``) and for the
tests that see ``correct`` come out false (``tests/test_bench_faults.py``).
The benchmark's own runs never plant one.

Each fault takes ``setattr``-like ``patch(obj, name, value)`` and patches the
program where it produces the thing it breaks.
"""

from __future__ import annotations

import numpy as np


def _wrap_forward(patch, change):
    from treelearn_tpu_torch.model import network

    orig = network.TreeLearn.forward

    def forward(self, *a, **k):
        out = dict(orig(self, *a, **k))
        change(out)
        return out

    patch(network.TreeLearn, "forward", forward)


def forward_altered(patch):
    """Every 97th point's offsets moved by 0.5 m where the forward
    produces them (in training the loss sees them too)."""
    def change(out):
        off = out["offset_predictions"].clone()
        off[::97] += 0.5
        out["offset_predictions"] = off

    _wrap_forward(patch, change)


def half_batch(patch):
    """Segmentation: the forward leaves the second half of its points at
    zero."""
    def change(out):
        for k in ("semantic_prediction_logits", "offset_predictions"):
            t = out[k].clone()
            t[t.shape[0] // 2:] = 0
            out[k] = t

    _wrap_forward(patch, change)


def labels_altered(patch):
    """One in a hundred of the labels the 5-NN assignment gives moved to
    another tree."""
    from treelearn_tpu_torch.pipeline import run as prun

    orig = prun.assign_remaining_points_nearest_neighbor

    def assign(coords, preds, label, *a, **k):
        out = orig(coords, preds, label, *a, **k)
        q = np.where(preds == label)[0][::100]
        out[q] = out[q] % max(int(out.max()), 1) + 1
        return out

    patch(prun, "assign_remaining_points_nearest_neighbor", assign)


def trees_merged(patch):
    """The grouping returns trees 1 and 2 as one (the rest renumbered)."""
    from treelearn_tpu_torch.pipeline import run as prun

    orig = prun.get_instances

    def get_instances(*a, **k):
        out = orig(*a, **k)
        out[out == 2] = 1
        out[out > 2] -= 1
        return out

    patch(prun, "get_instances", get_instances)


def saved_labels_altered(patch):
    """One in a hundred of the tree labels written to the full plot's file
    moved to another tree."""
    import os

    from treelearn_tpu_torch.pipeline import run as prun

    orig = prun.save_data

    def save_data(data, fmt, name, folder, *a, **k):
        if os.path.basename(folder) == "full_forest":
            data = np.array(data)
            q = np.where(data[:, 3] > 0)[0][::100]
            data[q, 3] = data[q, 3] % max(data[:, 3].max(), 1.0) + 1
        return orig(data, fmt, name, folder, *a, **k)

    patch(prun, "save_data", save_data)


def state_unchanged(patch):
    """The optimizer's step leaves the parameters as they are."""
    import torch

    patch(torch.optim.AdamW, "step", lambda self, closure=None: None)


def train_half_batch(patch):
    """The loss counts only the batch's first crop, the mean taken over its
    points."""
    from treelearn_tpu_torch.train import loop

    orig = loop.loss_from_output

    def loss(output, b):
        b = dict(b)
        first = b["batch_ids"] == 0
        b["masks_sem"] = b["masks_sem"] & first
        b["masks_off"] = b["masks_off"] & first
        return orig(output, b)

    patch(loop, "loss_from_output", loss)


FAULTS = {f.__name__: f for f in (
    forward_altered, half_batch, labels_altered, trees_merged,
    saved_labels_altered, state_unchanged, train_half_batch)}
