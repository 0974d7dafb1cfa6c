"""Segmentation counts for validation (port of the part of
treelearn_tpu/eval/evaluation.py that training's validation uses)."""

from __future__ import annotations


def get_eval_components(preds_mask, labels_mask):
    """tp/fp/tn/fn (parity: reference eval.py:230-238)."""
    tp = int((preds_mask & labels_mask).sum())
    fp = int((preds_mask & ~labels_mask).sum())
    fn = int((~preds_mask & labels_mask).sum())
    tn = int((~preds_mask & ~labels_mask).sum())
    return tp, fp, tn, fn
