"""End-to-end segmentation pipeline (port of treelearn_tpu/pipeline/run.py).

Parity: run_treelearn_pipeline (reference tools/pipeline/pipeline.py:22-200):
load forest -> center coords -> voxelize -> whole-plot or tile batches ->
pointwise inference -> ensemble -> [hull/outer-remove] -> instances
(deferred verticality + HDBSCAN or DBSCAN) -> assign remaining (5-NN) -> [save
pointwise] -> propagate to the original cloud -> de-center -> save full
forest + per-tree files.  With ``dist: true`` under a process group the
tile batches are dealt to the ranks (JAX pipeline/run.py:265-269).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import pprint
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import config_to_dict
from ..data.dataset import TreeDataset, TreeLoader
from ..device import resolve_device
from ..io.pointcloud import load_data, save_data
from ..logging_utils import get_root_logger
from ..model import TreeLearn, load_checkpoint
from .ensemble import ensemble_named, ensemble_named_by_id, propagate_by_key
from .hull import HullRaster
from .inference import get_pointwise_preds
from .instances import (
    assign_remaining_points_nearest_neighbor,
    get_cluster_means,
    get_instances,
    make_labels_consecutive,
    propagate_preds,
)
from .tiles import generate_tiles
from ..utils.trace import span

TREE_CLASS_IN_DATASET = 0
NON_TREES_LABEL_IN_GROUPING = 0
NOT_ASSIGNED_LABEL_IN_GROUPING = -1
START_NUM_PREDS = 1


def save_treewise(coords, instance_preds, cluster_means_within_hull,
                  insts_not_at_edge, save_format, plot_results_dir,
                  non_trees_label=NON_TREES_LABEL_IN_GROUPING):
    """Per-tree output files in three edge categories
    (parity: reference util/pipeline.py:397-419)."""
    coords = coords - np.mean(coords, axis=0)
    dirs = {
        "completely_inside": osp.join(plot_results_dir, "completely_inside"),
        "trunk_base_inside": osp.join(plot_results_dir, "trunk_base_inside"),
        "trunk_base_outside": osp.join(plot_results_dir, "trunk_base_outside"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    # non-trees + any never-assigned points (labels <= non_trees_label) land
    # in one non_trees file; tree instances are labels 1..K
    nt_mask = instance_preds <= non_trees_label
    if nt_mask.any():
        pred_coord = np.hstack([coords[nt_mask],
                                non_trees_label * np.ones((nt_mask.sum(), 1))])
        save_data(pred_coord, save_format, "non_trees", plot_results_dir,
                  use_offset=False)
    for i in np.unique(instance_preds):
        if i <= non_trees_label:
            continue
        pred_coord = coords[instance_preds == i]
        pred_coord = np.hstack([pred_coord, i * np.ones((len(pred_coord), 1))])
        idx = int(i) - 1
        if cluster_means_within_hull[idx] and insts_not_at_edge[idx]:
            save_data(pred_coord, save_format, str(int(i)),
                      dirs["completely_inside"], use_offset=False)
        elif cluster_means_within_hull[idx] and not insts_not_at_edge[idx]:
            save_data(pred_coord, save_format, str(int(i)),
                      dirs["trunk_base_inside"], use_offset=False)
        else:
            save_data(pred_coord, save_format, str(int(i)),
                      dirs["trunk_base_outside"], use_offset=False)


def run_treelearn_pipeline(config, config_path: Optional[str] = None,
                           model=None, logger=None, device=None):
    """Run the full segmentation pipeline; returns a result summary dict.

    ``model`` defaults to ``TreeLearn(**config.model)`` with seed-0 weights,
    overwritten by ``config.pretrain`` when set.  Runs on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).

    ``config.dist``: when a process group of world size > 1 is initialized
    (parallel/mesh.py:init_dp), each rank runs on its ``DPGroup.device``
    and forwards its share of the tile batches.  Rank 0 alone writes the
    voxelized / feature caches and the results and returns the summary;
    the other ranks wait at a barrier until the caches exist, forward, and
    return None.  Without such a group the single path runs and the log
    says so.

    Each of the nine stages (load_center, voxelize_features, inference,
    ensemble, cluster, assign_remaining, save_pointwise, propagate, save)
    runs under a span of its name, its parts under ``<stage>.<part>`` spans
    (utils/trace.py); ``stage_seconds`` holds each stage's seconds and a
    ``stage[<name>]`` log line marks its end."""
    head = (getattr(model, "head", None) if model is not None
            else config.model.get("head", "offset"))
    if head == "spformer":
        raise ValueError(
            "the pipeline groups the offset head's shifted points; the "
            "spformer head predicts instance masks over voxels, and "
            "instances from query masks merged across tiles are not "
            "implemented")
    group = None
    if config.get("dist"):
        from ..parallel import make_mesh

        group = make_mesh(device)
    lead = group is None or group.rank == 0
    device = group.device if group is not None else resolve_device(device)
    t_start = time.time()
    stage_seconds = {}

    @contextlib.contextmanager
    def _stage(name):
        """A stage: the span ``name``, its seconds in ``stage_seconds`` and
        a ``stage[name]`` log line once it has ended."""
        with span(name):
            t0 = time.perf_counter()
            yield
            stage_seconds[name] = time.perf_counter() - t0
        logger.info(f"stage[{name}]: {stage_seconds[name]:.2f}s")

    plot_name = osp.basename(config.forest_path)[:-4]
    base_dir = osp.dirname(osp.dirname(config.forest_path))
    documentation_dir = osp.join(base_dir, "documentation")
    voxelized_dir = osp.join(base_dir, f"forest_voxelized{config.sample_generation.voxel_size}")
    tiles_dir = osp.join(base_dir, "tiles")
    results_dir = osp.join(base_dir, getattr(config.save_cfg, "results_dir", "results"))
    if lead:
        for d in (documentation_dir, voxelized_dir, tiles_dir, results_dir):
            os.makedirs(d, exist_ok=True)

    logger = logger or get_root_logger(
        osp.join(documentation_dir, "log_pipeline.txt") if lead else None)
    if config.get("dist") and group is None:
        logger.info("dist: no process group of world size > 1 is "
                    "initialized; running the single-process path")
    elif group is not None:
        logger.info(f"dist: rank {group.rank} of {group.world} on "
                    f"{group.device} ({group.backend})")
    centered_path = osp.join(osp.dirname(config.forest_path), plot_name + "_centered.npz")
    with _stage("load_center"):
        if lead:
            logger.info(pprint.pformat(config_to_dict(config), indent=2))
            if config_path is not None:
                shutil.copy(config_path, osp.join(documentation_dir, osp.basename(config_path)))

            # center coords (the reference's large-coordinate workaround,
            # tools/pipeline/pipeline.py:39-50) and re-save as npz
            with span("load_center.read"):
                data = load_data(config.forest_path)
            xyz = data[:, :3].astype(np.float64)
            xyz_mean = np.mean(xyz, 0)
            # keep the label column: the reference re-saves coords AND labels
            # (pipeline.py:46-50); labels ride through voxelization (first-
            # point-per-voxel) into the pointwise dump, where the evaluation
            # joins on them
            centered_pts = (xyz - xyz_mean).astype(np.float32)
            with span("load_center.write"):
                np.savez(centered_path, points=centered_pts,
                         labels=(data[:, 3] if data.shape[1] > 3
                                 else np.full(len(data), -1.0)))
            del data, xyz
        config.forest_path = centered_path

    # tiles: streaming mode (default) slices tiles in memory from the sorted
    # voxelized plot; npz mode writes them to disk like the reference
    streaming = bool(config.get("streaming", True))
    config.dataset_test.data_root = osp.join(tiles_dir, "npz")
    with _stage("voxelize_features"):
        if not lead:
            dist.barrier()  # rank 0 writes the caches below first; then read them
        if streaming:
            from .tiles import prepare_voxelized_features

            # models that ignore input features (use_feats false, the
            # reference default) don't need whole-plot verticality up front —
            # the grouping stage computes it lazily over its candidate points
            defer_features = not bool(config.model.get("use_feats", False))
            vox_path, feat_path, vox_arrays = prepare_voxelized_features(
                config.sample_generation, config.forest_path, logger,
                config.save_cfg.return_type, skip_features=defer_features,
                device=device)
        elif config.tile_generation:
            logger.info("#################### generating tiles ####################")
            if lead:
                generate_tiles(config.sample_generation, config.forest_path,
                               logger, config.save_cfg.return_type, device=device)
        if group is not None and lead:
            dist.barrier()

    # model + pointwise predictions
    with _stage("inference"):
        logger.info(f"{plot_name}: #################### getting pointwise predictions ####################")
        if model is None:
            model = TreeLearn(**config.model).init(0)
            if config.get("pretrain"):
                load_checkpoint(config.pretrain, model, logger)
        if streaming:
            from .streaming import TileStream

            with span("inference.stream"):
                if vox_arrays is not None:
                    vox_pts = vox_arrays[0].astype(np.float64)
                    vox_labels = vox_arrays[1]
                else:
                    vox = np.load(vox_path)
                    vox_pts = vox["points"].astype(np.float64)
                    vox_labels = vox["labels"]
                feats_arr = (np.zeros((len(vox_pts), 1), np.float32)
                             if feat_path is None
                             else np.load(feat_path)["features"])
                stream = TileStream(
                    vox_pts, vox_labels,
                    feats_arr, config.sample_generation.inner_edge,
                    config.sample_generation.outer_edge, config.sample_generation.stride)
                # whole-plot single-pass inference: one batch holding the
                # entire plot instead of the reference's overlapping context
                # windows ('auto' switches on the voxel count; whole_plot:
                # false streams tiles)
                whole_plot = config.get("whole_plot", "auto")
                wp_max = int(config.get("whole_plot_max_voxels", 1 << 23))
                use_wp = (whole_plot is True
                          or (whole_plot == "auto" and len(vox_pts) <= wp_max))
                if use_wp:
                    vs = float(config.model.get("voxel_size", 0.1))
                    ext = vox_pts.max(axis=0) - vox_pts.min(axis=0)
                    # spatial shape bucketed to multiples of 64 as in the JAX
                    # package; batch_size x prod(shape) stays below 2^31
                    # (int32 keys)
                    ss = [int(np.ceil((np.ceil(e / vs) + 2) / 64)) * 64 for e in ext]
                    logger.info(f"whole-plot inference: {len(vox_pts)} voxels, "
                                f"spatial_shape {ss}")
                    model.spatial_shape = tuple(ss)
                    loader = stream.whole_plot_batches(min_bucket=1)
                else:
                    model.spatial_shape = (tuple(config.model.spatial_shape)
                                           if config.model.get("spatial_shape")
                                           else None)
                    loader = stream.batches(
                        batch_size=config.dataloader.batch_size,
                        inner_square_edge_length=config.dataset_test.inner_square_edge_length,
                        min_bucket=1)
        else:
            dataset = TreeDataset(**config.dataset_test, logger=logger)
            loader = TreeLoader(dataset, batch_size=config.dataloader.batch_size,
                                training=False, min_bucket=1)
        compute_dtype = torch.bfloat16 if config.get("fp16") else torch.float32
        model_timings = {}
        # the backbone features are only consumed by the pointwise-results dump
        pointwise = get_pointwise_preds(model, loader, compute_dtype=compute_dtype,
                                        device=device, logger=logger,
                                        timings=model_timings,
                                        need_backbone=bool(
                                            config.save_cfg.save_pointwise
                                            and config.save_cfg.get(
                                                "save_backbone_feats", True)),
                                        group=group)
    if not lead:
        return None
    (semantic_prediction_logits, semantic_labels, offset_predictions,
     offset_labels, coords, instance_labels, backbone_feats, input_feats,
     point_ids) = pointwise

    # ensemble overlapping predictions
    with _stage("ensemble"):
        logger.info(f"{plot_name}: #################### ensembling predictions ####################")
        if point_ids is not None:
            # id-plumbed path (streaming loaders): group by the integer
            # original-cloud row id each point carried through inference —
            # no coordinate quantization, and the surviving ids turn the
            # later propagate stage into an O(V) scatter instead of a
            # second join
            (point_ids, coords, semantic_prediction_logits, semantic_labels,
             offset_predictions, offset_labels, instance_labels, backbone_feats,
             input_feats) = ensemble_named_by_id(
                point_ids, coords, semantic_prediction_logits, semantic_labels,
                offset_predictions, offset_labels, instance_labels,
                backbone_feats, input_feats)
        else:
            (coords, semantic_prediction_logits, semantic_labels, offset_predictions,
             offset_labels, instance_labels, backbone_feats, input_feats) = ensemble_named(
                coords, semantic_prediction_logits, semantic_labels, offset_predictions,
                offset_labels, instance_labels, backbone_feats, input_feats)

    with _stage("cluster"):
        # hull for outer removal
        hull = None
        masks_inner_coords = None
        if config.shape_cfg.outer_remove:
            logger.info(f"{plot_name}: #################### prepare remove outer points ####################")
            hull = HullRaster(coords[:, :2], alpha=config.shape_cfg.alpha)
            at_edge = hull.within_boundary_buffer(coords[:, :2], config.shape_cfg.outer_remove)
            masks_inner_coords = ~at_edge

        # instances
        logger.info(f"{plot_name}: #################### getting predicted instances ####################")
        verticality = (None if (streaming and defer_features)
                       else input_feats[:, -1])
        instance_preds = get_instances(
            coords, offset_predictions, semantic_prediction_logits, config.grouping,
            verticality, TREE_CLASS_IN_DATASET, NON_TREES_LABEL_IN_GROUPING,
            NOT_ASSIGNED_LABEL_IN_GROUPING, START_NUM_PREDS,
            search_radius=config.sample_generation.search_radius_features,
            device=device)
        instance_preds_initial = np.copy(instance_preds)

    # assign remaining tree points by 5-NN on shifted coords
    with _stage("assign_remaining"):
        tree_mask = instance_preds != NON_TREES_LABEL_IN_GROUPING
        if tree_mask.any():
            instance_preds[tree_mask] = assign_remaining_points_nearest_neighbor(
                (coords + offset_predictions)[tree_mask], instance_preds[tree_mask],
                NOT_ASSIGNED_LABEL_IN_GROUPING, device=device)

    # save pointwise results
    if config.save_cfg.save_pointwise:
        with _stage("save_pointwise"):
            pointwise_dir = osp.join(results_dir, "pointwise_results")
            os.makedirs(pointwise_dir, exist_ok=True)
            # uncompressed: deflate on ~10^7-row float arrays costs seconds
            # per plot and the dump is a scratch artifact
            # (compress_pointwise: true restores the small-file behavior)
            _savez = (np.savez_compressed
                      if config.save_cfg.get("compress_pointwise", False)
                      else np.savez)
            with span("save_pointwise.npz"):
                _savez(
                    osp.join(pointwise_dir, "pointwise_results.npz"),
                    coords=coords, offset_predictions=offset_predictions,
                    offset_labels=offset_labels,
                    semantic_prediction_logits=semantic_prediction_logits,
                    semantic_labels=semantic_labels, instance_labels=instance_labels,
                    backbone_feats=backbone_feats, input_feats=input_feats,
                    instance_preds=instance_preds,
                    instance_preds_after_initial_clustering=instance_preds_initial,
                    **({"masks_inner_coords": masks_inner_coords}
                       if masks_inner_coords is not None else {}),
                )
            with span("save_pointwise.las"):
                shifted = coords + offset_predictions
                keep = instance_preds != NON_TREES_LABEL_IN_GROUPING
                save_data(np.hstack([shifted[keep], instance_preds[keep][:, None]]),
                          "las", "cluster_coords", pointwise_dir)

    with _stage("propagate"):
        # remove outer points
        if config.shape_cfg.outer_remove:
            m = masks_inner_coords
            (coords, semantic_prediction_logits, semantic_labels, offset_predictions,
             offset_labels, instance_labels, instance_preds, input_feats) = (
                coords[m], semantic_prediction_logits[m], semantic_labels[m],
                offset_predictions[m], offset_labels[m], instance_labels[m],
                instance_preds[m], input_feats[m])
            if point_ids is not None:
                point_ids = point_ids[m]
            nt = instance_preds != NON_TREES_LABEL_IN_GROUPING
            if nt.any():
                instance_preds[nt], _ = make_labels_consecutive(instance_preds[nt], start_num=1)

        # edge-tree categorization for treewise saving.  Tree instances are
        # the labels > NON_TREES_LABEL: NOT_ASSIGNED (-1) points can persist
        # when clustering finds nothing to anchor the 5-NN assignment
        # (degenerate models) and must not index the per-tree tables.
        cluster_means_within_hull = insts_not_at_edge = None
        if config.save_cfg.save_treewise:
            with span("propagate.edge_trees"):
                nt = instance_preds > NON_TREES_LABEL_IN_GROUPING
                n_insts = int(instance_preds.max()) if nt.any() else 0
                cluster_means = (get_cluster_means(
                    (coords + offset_predictions)[nt], instance_preds[nt])
                    if nt.any() else np.zeros((0, 3)))
                hull_full = HullRaster(coords[:, :2], alpha=config.shape_cfg.alpha)
                cluster_means_within_hull = hull_full.contains(cluster_means[:, :2])
                at_edge_small = hull_full.within_boundary_buffer(
                    coords[:, :2], config.shape_cfg.buffer_size_to_determine_edge_trees)
                preds_at_edge = np.unique(instance_preds[at_edge_small])
                preds_at_edge = preds_at_edge[preds_at_edge > NON_TREES_LABEL_IN_GROUPING]
                insts_not_at_edge = np.ones(n_insts, bool)
                insts_not_at_edge[preds_at_edge - 1] = False

        # propagate predictions to the requested cloud
        return_type = config.save_cfg.return_type
        if return_type == "original":
            logger.info(f"{plot_name}: propagating predictions to original points")
            # the centered original cloud and voxelized points are already
            # in memory (streaming path) — reloading their npz files cost
            # 1-6 s of host time per plot
            coords_to_return = centered_pts
            with span("propagate.trace_load"):
                trace = np.load(osp.join(voxelized_dir, f"{plot_name}_centered_trace.npz"))
                trace_inverse = trace["inverse"]
            vox_xyz = (vox_pts.astype(np.float32) if streaming else load_data(
                osp.join(voxelized_dir, f"{plot_name}_centered.npz"))[:, :3])
            if point_ids is not None:
                # ids ARE voxel-cloud rows: the join is a pure scatter
                with span("propagate.scatter"):
                    vox_preds = np.full(len(vox_xyz), -1, np.int64)
                    vox_preds[point_ids] = instance_preds
                    not_found_vox = np.ones(len(vox_xyz), bool)
                    not_found_vox[point_ids] = False
            else:
                with span("propagate.by_key"):
                    vox_preds, not_found_vox = propagate_by_key(
                        coords, instance_preds, vox_xyz)
            with span("propagate.gather"):
                preds_to_return = vox_preds[trace_inverse]
                not_yet_propagated = not_found_vox[trace_inverse]
        elif return_type == "voxelized":
            logger.info(f"{plot_name}: propagating predictions to voxelized points")
            coords_to_return = load_data(
                osp.join(voxelized_dir, f"{plot_name}_centered.npz"))[:, :3]
            if point_ids is not None:
                preds_to_return = np.full(len(coords_to_return), -1, np.int64)
                preds_to_return[point_ids] = instance_preds
                not_yet_propagated = np.ones(len(coords_to_return), bool)
                not_yet_propagated[point_ids] = False
            else:
                preds_to_return, not_yet_propagated = propagate_by_key(
                    coords, instance_preds, coords_to_return)
        else:  # 'voxelized_and_filtered'
            coords_to_return = coords
            preds_to_return = instance_preds
            not_yet_propagated = np.zeros(len(coords), bool)

        if config.shape_cfg.outer_remove:
            within = HullRaster(coords[:, :2], alpha=config.shape_cfg.alpha)
            at_edge = within.within_boundary_buffer(coords_to_return[:, :2],
                                                    config.shape_cfg.outer_remove)
            keep = ~at_edge
            coords_to_return = coords_to_return[keep]
            preds_to_return = np.asarray(preds_to_return)[keep]
            not_yet_propagated = not_yet_propagated[keep]

        if not_yet_propagated.any():
            with span("propagate.leftovers"):
                preds_to_return = np.asarray(preds_to_return)
                preds_to_return[not_yet_propagated] = propagate_preds(
                    coords, instance_preds, coords_to_return[not_yet_propagated], 5,
                    device=device)

        with span("propagate.decenter"):
            # one fused pass: de-center (f32 + f64 mean upcasts) straight
            # into the (N, 4) output block — the separate astype + hstack
            # cost two extra 240 MB temporaries and ~3 s at 10M points on
            # the 1-core host
            out = np.empty((len(coords_to_return), 4), np.float64)
            np.add(coords_to_return, xyz_mean, out=out[:, :3])
            out[:, 3] = np.asarray(preds_to_return)
            coords_to_return = out[:, :3]

    # save
    with _stage("save"):
        logger.info(f"{plot_name}: #################### Saving ####################")
        full_dir = osp.join(results_dir, "full_forest")
        os.makedirs(full_dir, exist_ok=True)
        with span("save.full_forest"):
            for save_format in config.save_cfg.save_formats:
                save_data(out, save_format, plot_name, full_dir)
        if config.save_cfg.save_treewise:
            trees_dir = osp.join(results_dir, "individual_trees")
            os.makedirs(trees_dir, exist_ok=True)
            with span("save.treewise"):
                save_treewise(coords_to_return, np.asarray(preds_to_return),
                              cluster_means_within_hull, insts_not_at_edge,
                              "las", trees_dir)

    elapsed = time.time() - t_start
    n_points = len(coords_to_return)
    n_trees = len(np.unique(preds_to_return)) - 1
    logger.info(f"{plot_name}: done in {elapsed:.1f}s — {n_points} pts, {n_trees} trees")
    return {
        "n_points": n_points,
        "n_trees": n_trees,
        "seconds": elapsed,
        "mpts_per_sec": n_points / max(elapsed, 1e-9) / 1e6,
        "results_dir": results_dir,
        "stage_seconds": stage_seconds,
        "model_timings": model_timings,
        "device": str(device),
        "output_path": (osp.join(
            full_dir, f"{plot_name}.{config.save_cfg.save_formats[0]}")
            if config.save_cfg.save_formats else None),
    }
