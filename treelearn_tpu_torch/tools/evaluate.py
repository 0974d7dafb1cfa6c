"""Benchmark evaluation CLI of the PyTorch/CUDA port:

    python -m treelearn_tpu_torch.tools.evaluate --config configs/evaluation/evaluate.yaml

Counterpart of tools/evaluate.py (reference tools/evaluation/evaluate.py):
load gt + predicted clouds, propagate predictions onto gt coordinates (5-NN
majority: kernel 6 or the host KD-tree, by ``knn_classify``'s routing),
Hungarian matching, detection failure analysis, partitioned segmentation
metrics, aggregate scores.  Runs on the card by default; ``--device cpu``
runs the plain versions.  The results pickle keeps the JAX tool's keys; its
partition tables are column dicts (name -> list), not DataFrames.
"""

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..config import get_config
from ..device import resolve_device
from ..eval import (
    detection_summary,
    evaluate_instance_segmentation,
    get_detection_failures,
    get_detections,
)
from ..io.pointcloud import load_data, save_data
from ..logging_utils import get_root_logger
from ..pipeline.instances import make_labels_consecutive, propagate_preds

NON_TREE_LABEL = 0


def evaluate(config, config_path=None, device=None):
    """Score ``config.paths.pred_forest_path`` against
    ``config.paths.gt_forest_path``; returns the results dict that is also
    pickled as ``evaluation_results.pkl``."""
    device = resolve_device(device)
    base_dir = (config.get("work_dir")
                or osp.join(osp.dirname(config.paths.pred_forest_path),
                            "evaluation"))
    documentation_dir = osp.join(base_dir, "documentation")
    os.makedirs(documentation_dir, exist_ok=True)
    logger = get_root_logger(osp.join(documentation_dir, "evaluate_log.txt"))

    # ground truth
    gt = load_data(config.paths.gt_forest_path)
    gt_coords = gt[:, :3]
    gt_labels = gt[:, 3].astype(int)
    gt_labels[gt_labels == NON_TREE_LABEL] = -1
    tree_mask = gt_labels != -1
    gt_labels[tree_mask], mapping_gt = make_labels_consecutive(
        gt_labels[tree_mask], start_num=0)
    mapping_gt[-1] = NON_TREE_LABEL

    # predictions, propagated onto gt coordinates
    pred = load_data(config.paths.pred_forest_path)
    logger.info("propagating predictions to coords of ground truth...")
    instance_preds = propagate_preds(pred[:, :3], pred[:, 3].astype(int),
                                     gt_coords, 5, device=device)
    instance_preds[instance_preds == NON_TREE_LABEL] = -1
    tree_mask = instance_preds != -1
    instance_preds[tree_mask], mapping_pred = make_labels_consecutive(
        instance_preds[tree_mask], start_num=0)
    mapping_pred[-1] = NON_TREE_LABEL

    # detection
    logger.info("getting detection results...")
    matched_gts, matched_preds, iou, precision, recall = get_detections(
        gt_labels, instance_preds, config.thresholds.min_iou_for_match, -1)
    unique_labels = np.arange(gt_labels.max() + 1)
    unique_preds_all = np.arange(instance_preds.max() + 1)
    failures = get_detection_failures(
        matched_gts, matched_preds, unique_labels, unique_preds_all, iou,
        precision, recall, config.thresholds.min_precision_for_pred,
        config.thresholds.min_recall_for_gt)
    (non_matched_gts, non_matched_preds, nmp_gt, nmg_pred, nmg_other) = failures

    # segmentation (coverage-style: per gt, the argmax-iou pred)
    logger.info("getting segmentation results...")
    unique_gts = np.arange(iou.shape[1])
    unique_preds = iou.argmax(axis=0)
    no_partition, xy_partition, z_partition = evaluate_instance_segmentation(
        instance_preds, gt_labels, unique_gts, unique_preds, gt_coords,
        mapping_gt, mapping_pred, config.partitions.xy_partition,
        config.partitions.z_partition)

    nmp_filtered = np.array([p for p, g in zip(non_matched_preds, nmp_gt)
                             if not np.isnan(g)])
    summary = detection_summary(matched_gts, non_matched_gts, matched_preds,
                                nmp_filtered)
    # column means that skip NaN, as the JAX tool's DataFrame.mean(0) does
    seg = {c: np.nanmean(np.asarray(no_partition[c], np.float64)) * 100
           for c in ("prec", "rec", "iou")}

    logger.info("\n===== Results detection evaluation =====")
    logger.info(f"Completeness: {summary['completeness']}%")
    logger.info(f"Omission Error Rate: {summary['omission_error_rate']}%")
    logger.info(f"Commission Error Rate: {summary['commission_error_rate']}%")
    logger.info(f"F1 Score: {summary['f1_score']}%")
    logger.info("\n===== Results segmentation evaluation =====")
    logger.info(f"Precision: {round(seg['prec'], 1)}%")
    logger.info(f"Recall: {round(seg['rec'], 1)}%")
    logger.info(f"Coverage: {round(seg['iou'], 1)}%")

    # predictions on gt cloud for analysis
    preds_original = np.array([mapping_pred[p] for p in instance_preds])
    save_data(np.hstack([gt_coords, preds_original[:, None]]), "las",
              "pred_forest_propagated_to_gt_pointcloud", base_dir)

    # failure correspondences in ORIGINAL label space (key names per
    # reference evaluate.py:122-138): commission errors = non-matched preds
    # whose best gt passed the precision gate, paired with that gt; omission
    # errors = non-matched gts paired with the undersegmenting pred and the
    # gt tree that pred was matched to
    def _map_or_nan(mapping, values):
        return np.array([np.nan if (isinstance(v, float) and np.isnan(v))
                         else mapping[int(v)] for v in values], dtype=float)

    nmp_pairs = [(p, g) for p, g in zip(non_matched_preds, nmp_gt)
                 if not np.isnan(g)]
    results = {
        "detection_results": {
            **summary,
            "matched_gts": np.array([mapping_gt[g] for g in matched_gts]),
            "matched_preds": np.array([mapping_pred[p] for p in matched_preds]),
            "non_matched_gts": np.array([mapping_gt[g] for g in non_matched_gts]),
            "non_matched_preds": np.array([mapping_pred[p] for p in non_matched_preds]),
            "non_matched_preds_filtered": np.array(
                [mapping_pred[p] for p, _ in nmp_pairs], dtype=float),
            "non_matched_preds_corresponding_gt_filtered": np.array(
                [mapping_gt[int(g)] for _, g in nmp_pairs], dtype=float),
            "non_matched_gts_corresponding_pred": _map_or_nan(
                mapping_pred, nmg_pred),
            "non_matched_gts_corresponding_other_tree": _map_or_nan(
                mapping_gt, nmg_other),
        },
        "segmentation_results": {
            "precision": round(seg["prec"], 1),
            "recall": round(seg["rec"], 1),
            "iou": round(seg["iou"], 1),
            "no_partition": no_partition,
            "xy_partition": xy_partition,
            "z_partition": z_partition,
        },
    }
    with open(osp.join(base_dir, "evaluation_results.pkl"), "wb") as f:
        pickle.dump(results, f)
    return results


def main(argv=None):
    # same flag set as the JAX tool, plus --device
    parser = argparse.ArgumentParser("treelearn_tpu_torch evaluate")
    parser.add_argument("--config", type=str, help="path to evaluation config")
    parser.add_argument("--work_dir", type=str, default=None,
                        help="output directory (default: alongside the "
                             "predicted cloud)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = get_config(args.config)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    return evaluate(cfg, args.config, device=args.device)


if __name__ == "__main__":
    main()
