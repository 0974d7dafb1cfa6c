"""Where a checkpoint loses trees: the quality chain of a pipeline run's
pointwise dump (counterpart of the analysis in
scripts/exp_hard_quality.py:109-141, returned as numbers).

Offset error in xy, split into trunk points (``rad < 0.3`` m from the
tree's base) and crown points (``rad > 1.0`` m); the crown offsets'
direction (cosine against the label) and magnitude ratio where the label is
longer than 0.5 m; then detection and the 10-bin partition IoUs of the same
dump (``train/selftrain.py``).
"""

from __future__ import annotations

import numpy as np

# The keys of quality_chain's dict, in the order it fills them.
KEYS = ("xy_err_trunk_median", "xy_err_crown_median", "xy_err_crown_p90",
        "xy_err_tree_median", "crown_cos_median", "crown_mag_ratio_median",
        "n_trunk", "n_crown", "n_crown_dir",
        "f1", "completeness", "commission", "matched_iou", "n_pred", "n_gt",
        "xy_partition_mean_iou", "z_partition_mean_iou")


def _median(x: np.ndarray) -> float:
    return float(np.median(x)) if len(x) else float("nan")


def quality_chain(pointwise_npz: str) -> dict:
    """The offset error split by trunk and crown, the crown offsets'
    direction and magnitude, detection and partitions of one dump."""
    from ..train.selftrain import (detection_f1_from_pointwise,
                                   segmentation_partition_summary)

    z = np.load(pointwise_npz)
    coords = z["coords"]
    op, ol = z["offset_predictions"], z["offset_labels"]
    gt = z["instance_labels"].astype(int)
    tree = gt > 0
    base = coords[:, :2] + ol[:, :2]
    rad = np.linalg.norm(coords[:, :2] - base, axis=1)
    trunkish = tree & (rad < 0.3)
    crown = tree & (rad > 1.0)
    err = np.linalg.norm((op - ol)[:, :2], axis=1)
    pm = np.linalg.norm(op[:, :2], axis=1)
    lm = np.linalg.norm(ol[:, :2], axis=1)
    m = crown & (lm > 0.5)
    cos = (op[m, :2] * ol[m, :2]).sum(1) / (pm[m] * lm[m] + 1e-9)
    out = {
        "xy_err_trunk_median": _median(err[trunkish]),
        "xy_err_crown_median": _median(err[crown]),
        "xy_err_crown_p90": (float(np.percentile(err[crown], 90))
                             if crown.any() else float("nan")),
        "xy_err_tree_median": _median(err[tree]),
        "crown_cos_median": _median(cos),
        "crown_mag_ratio_median": _median(pm[m] / lm[m]),
        "n_trunk": int(trunkish.sum()), "n_crown": int(crown.sum()),
        "n_crown_dir": int(m.sum()),
    }
    q = detection_f1_from_pointwise(pointwise_npz)
    out.update(f1=q["f1_score"], completeness=q["completeness"],
               commission=q["commission_error_rate"],
               matched_iou=q.get("mean_matched_iou", float("nan")),
               n_pred=q["n_pred"], n_gt=q["n_gt"])
    out.update(segmentation_partition_summary(pointwise_npz))
    return out
