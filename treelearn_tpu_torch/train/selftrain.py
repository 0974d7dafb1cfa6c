"""Self-contained training on procedural synthetic forests (port of
treelearn_tpu/train/selftrain.py).

Trains a model on synthetic crops (data/synthetic.py, offset labels from
the TreeDataset machinery) and writes a checkpoint keyed by a fingerprint
of the model config and the recipe, so a second call with the same recipe
returns the cached file.  Progress is saved to a partial checkpoint every
``save_every`` steps and at a ``max_seconds`` budget stop; the next call
resumes from it.  :func:`detection_f1_from_pointwise` and
:func:`segmentation_partition_summary` score a pipeline run's pointwise
dump against the ground truth it carries.

The JAX package sizes per-level voxel capacities from the crops before it
trains and skips any step whose voxel counts overflow them; eager PyTorch
works on exact voxel counts, so there is nothing to size and no step to
skip (``tools/skip_count.py`` counts the JAX run's skips).  Randomness is
explicit and follows the JAX package: the weights come from
``SeedSequence(seed0)``, crop ``i`` from seed ``seed0 + i`` and the crop
densities from a numpy generator seeded with ``seed0``; the augmentations
and the batch order come from the dataset's and the loader's generators,
seeded with ``STREAM_SEED`` (0) as the JAX package's defaults seed them,
so both packages train on the same batch stream.  The training step
itself draws no random numbers.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# The benchmark training recipe of the JAX package (selftrain.py:36-37).
BENCH_RECIPE = {"steps": 6000, "n_crops": 192, "hard_frac": 0.8,
                "crop_extent": 24.0, "ppt": (10000, 16000), "lr": 1.5e-3}

# Seed of the dataset's augmentations and the loader's batch order: the JAX
# package builds both with their default seed 0 (selftrain.py:139-145).
STREAM_SEED = 0


def _recipe_key(model_cfg: dict, recipe: dict) -> str:
    blob = json.dumps({"model": model_cfg, "recipe": recipe}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def write_synthetic_crops(crops_dir: str, n_crops: int, crop_extent: float,
                          seed0: int, hard_frac: float, ppt) -> None:
    """``n_crops`` xy-centred synthetic crops as npz files: easy cone
    forests first, then hard-mode ones (``hard_frac`` of them); ``ppt`` an
    int or a (lo, hi) range drawn per crop."""
    from ..data.synthetic import (make_crop_npz, make_synthetic_forest,
                                  make_synthetic_forest_hard,
                                  verticality_proxy)

    n_easy = max(int(round(n_crops * (1.0 - hard_frac))), 1)
    ppt_rng = np.random.default_rng(seed0)
    for i in range(n_crops):
        gen = make_synthetic_forest if i < n_easy else make_synthetic_forest_hard
        crop_ppt = (int(ppt_rng.integers(ppt[0], ppt[1] + 1))
                    if isinstance(ppt, (tuple, list)) else int(ppt))
        data, _ = gen(n_trees=max(int(crop_extent * crop_extent / 75), 3),
                      extent=crop_extent, points_per_tree=crop_ppt,
                      ground_points=int(crop_extent * crop_extent * 55),
                      seed=seed0 + i)
        data[:, :2] -= crop_extent / 2.0
        make_crop_npz(osp.join(crops_dir, f"crop_{i}.npz"), data,
                      verticality_proxy(data))


def training_stream(crops_dir: str, crop_extent: float, batch_size: int):
    """The loader over ``crops_dir`` that the JAX package's
    ``train_synthetic_checkpoint`` builds: its augmentations, and the
    dataset's and the loader's generators seeded with ``STREAM_SEED``."""
    from ..data import TreeDataset, TreeLoader

    dataset = TreeDataset(
        crops_dir, inner_square_edge_length=crop_extent, training=True,
        data_augmentations={"jitter": True, "flip": True, "rot": True,
                            "scaled": False, "point_jitter": False},
        seed=STREAM_SEED)
    return TreeLoader(dataset, batch_size=batch_size, training=True,
                      seed=STREAM_SEED)


def train_synthetic_checkpoint(
    model_cfg: dict,
    cache_dir: str,
    steps: int = 300,
    lr: float = 2e-3,
    batch_size: int = 1,
    n_crops: int = 12,
    crop_extent: float = 30.0,
    seed0: int = 101,
    logger=None,
    log_every: int = 50,
    hard_frac: float = 0.5,
    recipe_v: int = 7,
    ppt=9000,
    max_seconds: Optional[float] = None,
    save_every: int = 500,
    return_info: bool = False,
    device=None,
    compute_dtype=torch.bfloat16,
):
    """Train ``model_cfg`` on synthetic crops on ``device``; return the
    checkpoint path (``.pth``: ``{net, epoch}``).  With ``return_info``
    returns ``(path, info)``: ``complete``, ``completed_steps``,
    ``target_steps``, ``cached`` and, for the steps this call ran, each
    step's ``losses`` and ``step_seconds`` (host clock around the step,
    which ends in a device sync when its loss is read)."""
    from ..device import resolve_device
    from ..model import TreeLearn
    from ..model.checkpoint import resume_checkpoint, save_checkpoint
    from .loop import build_optimizer, make_train_step

    dev = resolve_device(device)
    recipe = {"steps": steps, "lr": lr, "batch_size": batch_size,
              "n_crops": n_crops, "crop_extent": crop_extent, "seed0": seed0,
              "v": recipe_v, "dtype": str(compute_dtype),
              "stream_seed": STREAM_SEED}
    if hard_frac != 0.5:
        recipe["hard_frac"] = hard_frac
    if ppt != 9000:
        recipe["ppt"] = ppt
    mc = dict(model_cfg)
    side = int(np.ceil((crop_extent + 4) / 0.1 / 64)) * 64
    mc["spatial_shape"] = [side, side, 256]
    key = _recipe_key(mc, recipe)
    os.makedirs(cache_dir, exist_ok=True)
    ckpt_path = osp.join(cache_dir, f"selftrain_{key}.pth")
    partial_path = osp.join(cache_dir, f"selftrain_{key}_partial.pth")
    info = {"complete": True, "completed_steps": steps, "target_steps": steps,
            "cached": True, "losses": [], "step_seconds": []}
    if osp.isfile(ckpt_path):
        if logger:
            logger(f"selftrain: cached checkpoint {ckpt_path}")
        return (ckpt_path, info) if return_info else ckpt_path
    info["cached"] = False

    def fresh():
        model = TreeLearn(**mc).init(np.random.SeedSequence(seed0)).to(dev)
        optimizer, scheduler = build_optimizer(
            model.parameters(), {"type": "AdamW", "lr": lr,
                                 "weight_decay": 1e-3},
            scheduler_cfg={"t_initial": steps,
                           "warmup_t": min(30, steps // 10),
                           "lr_min": lr / 20, "warmup_lr_init": lr / 100},
            steps_per_epoch=1)
        return model, optimizer, scheduler

    t0 = time.time()
    model, optimizer, scheduler = fresh()
    start_step = 0
    if osp.isfile(partial_path):
        try:
            start_step = resume_checkpoint(partial_path, model, optimizer,
                                           scheduler) - 1
            if logger:
                logger(f"selftrain: resuming from step {start_step}")
        except (RuntimeError, EOFError, OSError, KeyError) as e:
            # a partial cut mid-write: start over
            if logger:
                logger(f"selftrain: partial unreadable ({e}); restarting")
            model, optimizer, scheduler = fresh()
            start_step = 0

    step_fn = make_train_step(model, optimizer, scheduler,
                              batch_size=batch_size,
                              compute_dtype=compute_dtype,
                              grad_norm_clip=True, device=dev)
    n_done = start_step
    out_of_time = False
    with tempfile.TemporaryDirectory(dir=cache_dir) as crops_dir:
        write_synthetic_crops(crops_dir, n_crops, crop_extent, seed0,
                              hard_frac, ppt)
        loader = training_stream(crops_dir, crop_extent, batch_size)
        while n_done < steps and not out_of_time:
            for batch in loader:
                if n_done >= steps:
                    break
                ts = time.time()
                loss, ld = step_fn(batch)
                info["losses"].append(float(loss))
                info["step_seconds"].append(time.time() - ts)
                n_done += 1
                if logger and (n_done % log_every == 0 or n_done == steps):
                    comps = {k: round(float(v), 3) for k, v in ld.items()}
                    logger(f"selftrain: step {n_done}/{steps} loss "
                           f"{info['losses'][-1]:.3f} {comps} "
                           f"({time.time() - t0:.0f}s)")
                if n_done % save_every == 0 and n_done < steps:
                    save_checkpoint(partial_path, model, optimizer, scheduler,
                                    n_done)
                if (max_seconds is not None and n_done < steps
                        and time.time() - t0 > max_seconds):
                    out_of_time = True
                    break
        loader.close()      # before its folder goes
    if info["losses"] and not np.isfinite(info["losses"][-1]):
        raise RuntimeError(f"selftrain diverged: losses {info['losses']}")
    if out_of_time:
        save_checkpoint(partial_path, model, optimizer, scheduler, n_done)
        if logger:
            logger(f"selftrain: budget ({max_seconds:.0f}s) exhausted at "
                   f"step {n_done}/{steps}; returning the partial checkpoint")
        info.update(complete=False, completed_steps=n_done)
        return (partial_path, info) if return_info else partial_path
    save_checkpoint(ckpt_path, model, epoch=0)
    if osp.isfile(partial_path):
        os.remove(partial_path)
    if logger:
        logger(f"selftrain: done in {time.time() - t0:.0f}s -> {ckpt_path}")
    return (ckpt_path, info) if return_info else ckpt_path


def segmentation_partition_summary(pointwise_npz: str) -> dict:
    """Mean xy/z partition IoU over matched trees (reference protocol:
    tools/evaluation/evaluate.py:92-116 with the 10-bin partitions of
    configs/evaluation/evaluate.yaml) — the hard-mode benchmark's regression
    anchors for clustering quality.  The partition tables are column dicts;
    the means skip NaN as the JAX package's DataFrame means do."""
    from ..eval import (evaluate_xy_partition, evaluate_z_partition,
                        get_detections)
    from ..pipeline.instances import make_labels_consecutive

    z = np.load(pointwise_npz)
    coords = z["coords"].astype(np.float64)
    gt = z["instance_labels"].astype(np.int64)
    pred = z["instance_preds"].astype(np.int64)

    gt = np.where(gt == 0, -1, gt)
    mapping_gt = {-1: -1}
    m = gt != -1
    if m.any():
        gt[m], mg = make_labels_consecutive(gt[m], start_num=0)
        mapping_gt.update(mg)
    pred = np.where(pred == 0, -1, pred)
    mapping_pred = {-1: -1}
    m = pred != -1
    if m.any():
        pred[m], mp = make_labels_consecutive(pred[m], start_num=0)
        mapping_pred.update(mp)

    _, _, iou, _, _ = get_detections(gt, pred, min_iou_match=0.5,
                                     non_tree_label=-1)
    if iou.shape[0] == 0:
        # no predicted tree: every gt tree's bins hold misses only
        return {"xy_partition_mean_iou": 0.0, "z_partition_mean_iou": 0.0}
    unique_gts = np.arange(iou.shape[1])
    unique_preds = iou.argmax(axis=0)
    intvls = [round(0.1 * i, 1) for i in range(11)]
    xy = evaluate_xy_partition(pred, gt, unique_gts, unique_preds, coords,
                               intvls, mapping_gt, mapping_pred)
    zp = evaluate_z_partition(pred, gt, unique_gts, unique_preds, coords,
                              intvls, mapping_gt, mapping_pred)

    def iou_values(table):
        return np.array([table[c] for c in table if c.startswith("iou_")],
                        np.float64)

    return {
        "xy_partition_mean_iou": round(
            float(np.nanmean(iou_values(xy))) * 100, 1),
        "z_partition_mean_iou": round(
            float(np.nanmean(iou_values(zp))) * 100, 1),
    }


def detection_f1_from_pointwise(pointwise_npz: str) -> dict:
    """Score a pipeline run's pointwise_results.npz against the ground-truth
    instance labels it carries (detection protocol of the reference:
    tools/evaluation/evaluate.py:92-99 via the port's eval stack)."""
    from ..eval import detection_summary, get_detection_failures, get_detections
    from ..pipeline.instances import make_labels_consecutive

    z = np.load(pointwise_npz)
    gt = z["instance_labels"].astype(np.int64)
    pred = z["instance_preds"].astype(np.int64)

    gt = np.where(gt == 0, -1, gt)          # raw convention: 0 = non-tree
    m = gt != -1
    if m.any():
        gt[m], _ = make_labels_consecutive(gt[m], start_num=0)
    pred = np.where(pred == 0, -1, pred)    # grouping: 0 = non-tree
    m = pred != -1
    if m.any():
        pred[m], _ = make_labels_consecutive(pred[m], start_num=0)

    matched_gts, matched_preds, iou, prec, rec = get_detections(
        gt, pred, min_iou_match=0.5, non_tree_label=-1)
    uniq_gt = np.arange(gt.max() + 1)
    uniq_pred = np.arange(pred.max() + 1)
    (nm_gts, nm_preds, nmp_gt, _, _) = get_detection_failures(
        matched_gts, matched_preds, uniq_gt, uniq_pred, iou, prec, rec,
        min_precision_for_pred=0.5, min_recall_for_gt=0.5)
    nmp_filtered = np.array([p for p, g in zip(nm_preds, nmp_gt)
                             if not np.isnan(g)])
    summary = detection_summary(matched_gts, nm_gts, matched_preds,
                                nmp_filtered)
    # mean pointwise segmentation quality over matched pairs
    if len(matched_preds):
        seg_iou = float(np.mean(iou[matched_preds, matched_gts]))
        summary["mean_matched_iou"] = round(seg_iou * 100, 1)
    summary["n_gt"] = int(gt.max() + 1)
    summary["n_pred"] = int(pred.max() + 1)
    return summary
