"""Benchmark evaluation protocol: detection + segmentation metrics (port of
treelearn_tpu/eval/evaluation.py).

Parity: reference tree_learn/util/eval.py and tools/evaluation/evaluate.py —
Hungarian matching on a pred x gt IoU matrix gated at min_iou, commission/
omission failure analysis, pointwise precision/recall/IoU per matched tree,
and 10-bin radial-xy / vertical-z partition metrics.  The IoU matrix comes
from one contingency-table scatter: O(N + P*G).

Stated narrowing: no pandas.  Where the JAX package returns
``pd.DataFrame.from_dict(rows)``, the port returns ``rows`` itself, a dict
from column name to a list, with the same keys in the same order
(``pd.DataFrame.from_dict`` of it is the JAX frame).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def contingency_matrices(instance_labels: np.ndarray, instance_preds: np.ndarray,
                         non_tree_label: int = -1):
    """IoU / precision / recall matrices of shape (max_pred+1, max_gt+1)
    (parity: get_detections' matrix construction, reference eval.py:7-26;
    entries whose gt is ``non_tree_label`` stay zero like the reference's
    filter at eval.py:16)."""
    n_pred = int(instance_preds.max()) + 1
    n_gt = int(instance_labels.max()) + 1

    counts = np.zeros((n_pred + 1, n_gt + 1), np.int64)
    pi = np.where(instance_preds >= 0, instance_preds, n_pred)
    gi = np.where(instance_labels >= 0, instance_labels, n_gt)
    np.add.at(counts, (pi, gi), 1)

    inter = counts[:n_pred, :n_gt].astype(np.float64)
    pred_sizes = np.bincount(pi, minlength=n_pred + 1)[:n_pred].astype(np.float64)
    gt_sizes = np.bincount(gi, minlength=n_gt + 1)[:n_gt].astype(np.float64)

    union = pred_sizes[:, None] + gt_sizes[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
        precision = np.where(pred_sizes[:, None] > 0, inter / pred_sizes[:, None], 0.0)
        recall = np.where(gt_sizes[None, :] > 0, inter / gt_sizes[None, :], 0.0)
    if non_tree_label >= 0:
        iou[:, non_tree_label] = 0.0
        precision[:, non_tree_label] = 0.0
        recall[:, non_tree_label] = 0.0
    return iou, precision, recall


def get_detections(instance_labels: np.ndarray, instance_preds: np.ndarray,
                   min_iou_match: float, non_tree_label: int = -1):
    """Hungarian matching gated at min_iou (parity: reference eval.py:7-31).
    Returns (matched_gts, matched_preds, iou, precision, recall)."""
    iou, precision, recall = contingency_matrices(
        instance_labels, instance_preds, non_tree_label)
    pred_idx, gt_idx = linear_sum_assignment(iou, maximize=True)
    ok = iou[pred_idx, gt_idx] > min_iou_match
    return gt_idx[ok], pred_idx[ok], iou, precision, recall


def get_detection_failures(matched_gts, matched_preds, unique_instance_labels,
                           unique_instance_preds, iou_matrix, precision_matrix,
                           recall_matrix, min_precision_for_pred,
                           min_recall_for_gt):
    """Commission/omission analysis (parity: reference eval.py:35-76)."""
    if (iou_matrix[matched_preds, matched_gts] > 0).sum() != len(matched_preds):
        raise ValueError("a zero iou correspondence has been matched")
    non_matched_preds = np.array(
        sorted(set(unique_instance_preds) - set(matched_preds)), np.int64)
    non_matched_gts = np.array(
        sorted(set(unique_instance_labels) - set(matched_gts)), np.int64)

    non_matched_preds_corresponding_gt = []
    for p in non_matched_preds:
        if precision_matrix[p].sum() < min_precision_for_pred:
            non_matched_preds_corresponding_gt.append(np.nan)
        else:
            non_matched_preds_corresponding_gt.append(precision_matrix[p].argmax())
    non_matched_preds_corresponding_gt = np.array(non_matched_preds_corresponding_gt)

    non_matched_gts_corresponding_pred = []
    non_matched_gts_corresponding_other_tree = []
    for g in non_matched_gts:
        if recall_matrix[:, g].max() < min_recall_for_gt:
            non_matched_gts_corresponding_pred.append(np.nan)
            non_matched_gts_corresponding_other_tree.append(np.nan)
        else:
            corresponding_pred = int(np.argmax(recall_matrix[:, g]))
            non_matched_gts_corresponding_pred.append(corresponding_pred)
            other_gts = np.delete(np.arange(recall_matrix.shape[1]), g)
            best = recall_matrix[corresponding_pred, other_gts].argmax()
            if recall_matrix[corresponding_pred, other_gts][best] < min_recall_for_gt:
                non_matched_gts_corresponding_other_tree.append(np.nan)
            else:
                non_matched_gts_corresponding_other_tree.append(other_gts[best])

    return (non_matched_gts, non_matched_preds,
            non_matched_preds_corresponding_gt,
            np.array(non_matched_gts_corresponding_pred),
            np.array(non_matched_gts_corresponding_other_tree))


def get_eval_components(preds_mask, labels_mask):
    """tp/fp/tn/fn (parity: reference eval.py:230-238)."""
    tp = int((preds_mask & labels_mask).sum())
    fp = int((preds_mask & ~labels_mask).sum())
    fn = int((~preds_mask & labels_mask).sum())
    tn = int((~preds_mask & ~labels_mask).sum())
    return tp, fp, tn, fn


def get_segmentation_metrics(tp, fp, fn):
    """(prec, rec, iou) with nan-on-empty semantics (reference eval.py:242-260)."""
    iou = np.nan if (tp == 0 and fp == 0 and fn == 0) else tp / (tp + fp + fn)
    rec = np.nan if (tp + fn == 0) else tp / (tp + fn)
    prec = np.nan if (tp + fp == 0) else tp / (tp + fp)
    return prec, rec, iou


def evaluate_no_partition(instance_preds, instance_labels, unique_gts,
                          unique_preds, mapping_gt, mapping_pred) -> dict:
    """Per (pred, gt) pair: precision, recall, IoU, as columns."""
    rows = {"instance_pred": [], "instance_label": [], "prec": [], "rec": [], "iou": []}
    for pred, gt in zip(unique_preds, unique_gts):
        rows["instance_pred"].append(mapping_pred[pred])
        rows["instance_label"].append(mapping_gt[gt])
        tp, fp, tn, fn = get_eval_components(instance_preds == pred,
                                             instance_labels == gt)
        prec, rec, iou = get_segmentation_metrics(tp, fp, fn)
        rows["prec"].append(prec)
        rows["rec"].append(rec)
        rows["iou"].append(iou)
    return rows


def _partition_eval(instance_preds, instance_labels, unique_gts, unique_preds,
                    coords, intvls, mapping_gt, mapping_pred,
                    normalized_coordinate_fn) -> dict:
    rows = {"instance_pred": [], "instance_label": []}
    for i in range(len(intvls) - 1):
        rows[f"prec_intvl{intvls[i]}_{intvls[i+1]}"] = []
    for i in range(len(intvls) - 1):
        rows[f"rec_intvl{intvls[i]}_{intvls[i+1]}"] = []
    for i in range(len(intvls) - 1):
        rows[f"iou_intvl{intvls[i]}_{intvls[i+1]}"] = []

    for pred, gt in zip(unique_preds, unique_gts):
        rows["instance_pred"].append(mapping_pred[pred])
        rows["instance_label"].append(mapping_gt[gt])
        ind_pred = instance_preds == pred
        ind_gt = instance_labels == gt
        t = normalized_coordinate_fn(coords, ind_gt)
        for i in range(len(intvls) - 1):
            sel = (t >= intvls[i]) & (t < intvls[i + 1])
            tp, fp, tn, fn = get_eval_components(ind_pred[sel], ind_gt[sel])
            prec, rec, iou = get_segmentation_metrics(tp, fp, fn)
            rows[f"prec_intvl{intvls[i]}_{intvls[i+1]}"].append(prec)
            rows[f"rec_intvl{intvls[i]}_{intvls[i+1]}"].append(rec)
            rows[f"iou_intvl{intvls[i]}_{intvls[i+1]}"].append(iou)
    return rows


def _xy_normalized(coords, ind_gt):
    """Radial distance from the tree seedpoint, normalized by the 5th most
    distant tree point (parity: reference eval.py:146-160)."""
    tree = coords[ind_gt]
    z_thresh = tree[:, 2].min() + 0.30
    position = tree[tree[:, 2] <= z_thresh].mean(axis=0)[:2]
    d = np.linalg.norm(coords[:, :2] - position, axis=1)
    d_tree = d[ind_gt]
    reg_max = d_tree[np.argsort(d_tree)[-5]] if len(d_tree) >= 5 else d_tree.max()
    return d / reg_max


def _z_normalized(coords, ind_gt):
    """Height above the tree's lowest point, normalized by the 5th highest
    tree point (parity: reference eval.py:200-208)."""
    tree_z = coords[ind_gt][:, 2]
    z0 = tree_z.min()
    reg_max = tree_z[np.argsort(tree_z)[-5]] if len(tree_z) >= 5 else tree_z.max()
    return (coords[:, 2] - z0) / max(reg_max - z0, 1e-12)


def evaluate_xy_partition(instance_preds, instance_labels, unique_gts,
                          unique_preds, coords, intvls, mapping_gt, mapping_pred):
    return _partition_eval(instance_preds, instance_labels, unique_gts,
                           unique_preds, coords, intvls, mapping_gt,
                           mapping_pred, _xy_normalized)


def evaluate_z_partition(instance_preds, instance_labels, unique_gts,
                         unique_preds, coords, intvls, mapping_gt, mapping_pred):
    return _partition_eval(instance_preds, instance_labels, unique_gts,
                           unique_preds, coords, intvls, mapping_gt,
                           mapping_pred, _z_normalized)


def evaluate_instance_segmentation(instance_preds, instance_labels, unique_gts,
                                   unique_preds, coords, mapping_gt,
                                   mapping_pred, xy_partition: Optional[Sequence[float]],
                                   z_partition: Optional[Sequence[float]]):
    no_partition = evaluate_no_partition(
        instance_preds, instance_labels, unique_gts, unique_preds,
        mapping_gt, mapping_pred)
    xy = (evaluate_xy_partition(instance_preds, instance_labels, unique_gts,
                                unique_preds, coords, xy_partition, mapping_gt,
                                mapping_pred) if xy_partition else None)
    z = (evaluate_z_partition(instance_preds, instance_labels, unique_gts,
                              unique_preds, coords, z_partition, mapping_gt,
                              mapping_pred) if z_partition else None)
    return no_partition, xy, z


def detection_summary(matched_gts, non_matched_gts, matched_preds,
                      non_matched_preds_filtered):
    """Completeness / omission / commission / F1 (parity: reference
    tools/evaluation/evaluate.py:92-99), in percent, 1 decimal."""
    completeness = len(matched_gts) / max(len(matched_gts) + len(non_matched_gts), 1)
    omission = 1 - completeness
    commission = len(non_matched_preds_filtered) / max(
        len(matched_preds) + len(non_matched_preds_filtered), 1)
    f1 = 2 * ((1 - commission) * (1 - omission)) / max(2 - (commission + omission), 1e-12)
    return {
        "completeness": round(completeness * 100, 1),
        "omission_error_rate": round(omission * 100, 1),
        "commission_error_rate": round(commission * 100, 1),
        "f1_score": round(f1 * 100, 1),
    }
