"""Tree instance extraction from pointwise predictions (port of
treelearn_tpu/pipeline/instances.py).

Parity: get_instances + group_dbscan/group_hdbscan + remaining-point
assignment (reference util/pipeline.py:145-206, 287-296).  Cluster
candidates: tree confidence >= tree_conf_thresh AND verticality > tau_vert
AND |offset_z| < tau_off; clustering runs on the xy of offset-shifted
coords.  DBSCAN mode is the eps-graph components pass (kernel 5 on the
card); HDBSCAN mode (``grouping.use_hdbscan``, the repository's default,
configs/_modular/grouping.yaml) is ops/hdbscan.py with the same tau_min
post-filter.
"""

from __future__ import annotations

import numpy as np

from ..ops.cluster import dbscan_cluster, knn_classify
from ..ops.hdbscan import hdbscan_cluster
from ..utils.trace import span


def softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def make_labels_consecutive(labels: np.ndarray, start_num: int):
    """Relabel to start_num..start_num+k-1; returns (labels, mapping new->old)
    (parity: reference util/pipeline.py:195-206)."""
    palette = np.sort(np.unique(labels))
    index = np.digitize(labels, palette, right=True)
    new_labels = np.arange(len(palette))[index] + start_num
    mapping = {new + start_num: orig for new, orig in enumerate(palette)}
    return new_labels, mapping


def group_hdbscan(cluster_coords: np.ndarray, npoint_thr: int,
                  not_assigned_label: int, start_num: int,
                  device=None) -> np.ndarray:
    """HDBSCAN mode (ops/hdbscan.py: core distances + eps-ladder components
    on ``device`` + condensed-tree extraction).  Same single-hyperparameter
    contract and tau_min filtering as the reference
    (util/pipeline.py:184-191)."""
    labels = hdbscan_cluster(cluster_coords, min_cluster_size=npoint_thr,
                             not_assigned_label=not_assigned_label,
                             start_num=start_num, device=device)
    uniq, counts = np.unique(labels, return_counts=True)
    valid = uniq[(counts >= npoint_thr) & (uniq != not_assigned_label)]
    ind_valid = np.isin(labels, valid)
    labels[ind_valid], _ = make_labels_consecutive(labels[ind_valid], start_num)
    labels[~ind_valid] = not_assigned_label
    return labels


def get_instances(coords: np.ndarray, offset: np.ndarray,
                  semantic_prediction_logits: np.ndarray, grouping_cfg,
                  verticality_feat: np.ndarray, tree_class_in_dataset: int,
                  non_trees_label: int, not_assigned_label: int,
                  start_num_preds: int, search_radius: float = 0.6,
                  device=None) -> np.ndarray:
    """``verticality_feat=None`` defers verticality: it is computed here,
    on ``device``, only for points that already pass the confidence and
    offset filters (neighborhoods still from the full cloud).  Its parts
    run under the spans cluster.filter, cluster.verticality and
    cluster.components."""
    with span("cluster.filter"):
        cluster_coords = (coords + offset)[:, :3]

        logits = np.asarray(semantic_prediction_logits)
        thr = float(grouping_cfg.tree_conf_thresh)
        if logits.ndim == 2 and logits.shape[1] == 2 and 0.0 < thr < 1.0:
            # binary head: the softmax confidence test is exactly the logit
            # margin against the log-odds (instances.py:66-78 of the JAX
            # package)
            other = 1 - tree_class_in_dataset
            margin = (logits[:, tree_class_in_dataset].astype(np.float64)
                      - logits[:, other].astype(np.float64))
            tree_mask = margin >= np.log(thr / (1.0 - thr))
        else:
            probs = softmax_np(np.asarray(logits, np.float64))
            tree_mask = probs[:, tree_class_in_dataset] >= thr
        offset_mask = np.abs(offset[:, 2]) < grouping_cfg.tau_off
    with span("cluster.verticality"):
        if verticality_feat is None:
            from ..ops.features import compute_verticality

            pre = np.where(tree_mask & offset_mask)[0]
            vertical_mask = np.zeros(len(coords), bool)
            if len(pre):
                vert = compute_verticality(coords[:, :3].astype(np.float32),
                                           search_radius=search_radius,
                                           query_idx=pre, device=device)
                vertical_mask[pre] = vert[:, 0] > grouping_cfg.tau_vert
        else:
            vertical_mask = (np.asarray(verticality_feat).reshape(-1)
                             > grouping_cfg.tau_vert)
    with span("cluster.components"):
        mask_cluster = tree_mask & vertical_mask & offset_mask
        ind_cluster = np.where(mask_cluster)[0]
        filtered_xy = cluster_coords[ind_cluster][:, :2]

        predictions = non_trees_label * np.ones(len(cluster_coords))
        predictions[tree_mask] = not_assigned_label

        if grouping_cfg.get("use_hdbscan", False):
            pred_instances = group_hdbscan(
                filtered_xy, grouping_cfg.tau_min, not_assigned_label,
                start_num_preds, device=device)
        else:
            pred_instances = dbscan_cluster(
                filtered_xy.astype(np.float32), eps=grouping_cfg.tau_group,
                min_size=grouping_cfg.tau_min,
                not_assigned_label=not_assigned_label,
                start_num=start_num_preds, device=device)
        predictions[ind_cluster] = pred_instances
    return predictions.astype(np.int64)


def assign_remaining_points_nearest_neighbor(coords: np.ndarray,
                                             predictions: np.ndarray,
                                             remaining_label: int,
                                             n_neighbors: int = 5,
                                             device=None) -> np.ndarray:
    """5-NN assignment of unclustered tree points onto cluster labels
    (parity: util/pipeline.py:287-296)."""
    predictions = np.copy(predictions)
    assert len(coords) == len(predictions)
    query_idx = np.where(predictions == remaining_label)[0]
    ref_idx = np.where(predictions != remaining_label)[0]
    if len(query_idx) == 0 or len(ref_idx) == 0:
        return predictions.astype(np.int64)
    predictions[query_idx] = knn_classify(
        coords[ref_idx].astype(np.float32), predictions[ref_idx],
        coords[query_idx].astype(np.float32), k=n_neighbors, device=device)
    return predictions.astype(np.int64)


def propagate_preds(source_coords: np.ndarray, source_preds: np.ndarray,
                    target_coords: np.ndarray, n_neighbors: int = 5,
                    device=None) -> np.ndarray:
    """k-NN majority-vote propagation between clouds (parity:
    util/pipeline.py:300-331)."""
    return knn_classify(source_coords.astype(np.float32),
                        source_preds.astype(np.int64),
                        target_coords.astype(np.float32), k=n_neighbors,
                        device=device)


def get_cluster_means(coords: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Mean coordinate per label, rows ordered by ascending label
    (parity: util/pipeline.py:279-283)."""
    uniq, inv = np.unique(labels, return_inverse=True)
    sums = np.zeros((len(uniq), coords.shape[1]))
    np.add.at(sums, inv, coords)
    counts = np.bincount(inv).astype(np.float64)
    return sums / counts[:, None]
