"""Hard-forest pipeline ceiling of the port (counterpart of
scripts/exp_oracle_ceiling.py):

    python -m treelearn_tpu_torch.tools.oracle_ceiling [--trees 24] [--ppt 16000] [--bench-hard] [--device cpu]

Runs grouping and remaining-point assignment with GROUND-TRUTH offsets (the
dataset's offset-label rule) and ground-truth semantics in place of the
model's predictions.  This isolates the grouping stages from the learned
model: the detection F1 it gives is the ceiling any checkpoint can reach on
the hard generator.  ``--bench-hard`` takes the bench's hard plot
(``make_synthetic_forest_hard(n_trees=48, extent=60, points_per_tree=16000,
ground_points=200000, seed=0)``, 616,177 points) instead of the script's
forest.  Runs on the card (verticality and found-bits kernels, the k-NN
kernel where ``assign_remaining`` takes the banded route) unless given
``--device cpu``; the launch counts (zeroed just before) and the k-NN
routes go to stderr, one JSON line with the scores and each stage's seconds
(a device sync before each clock read) to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# scripts/exp_oracle_ceiling.py:79-81
GROUPING = {"tau_group": 0.15, "tau_min": 50, "tau_off": 4, "tau_vert": 0.6,
            "tree_conf_thresh": 0.5, "use_hdbscan": False}
# the bench's hard plot (tools/bench.py: make_synthetic_forest_hard with the
# bench plot's arguments)
BENCH_HARD = dict(n_trees=48, extent=60.0, points_per_tree=16000,
                  ground_points=200000, seed=0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def gt_offsets(coords: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """The dataset's offset-label construction (data/dataset.py parity:
    target = mean of the tree's lowest 0.5 m slab, z from the 3rd-lowest
    point) applied to a whole plot."""
    off = np.zeros_like(coords)
    for t in np.unique(labels):
        if t <= 0:
            continue
        m = labels == t
        pts = coords[m]
        z0 = np.partition(pts[:, 2], min(2, len(pts) - 1))[min(2, len(pts) - 1)]
        slab = pts[pts[:, 2] <= z0 + 0.5]
        base = np.array([slab[:, 0].mean(), slab[:, 1].mean(), z0])
        off[m] = base - pts
    return off


def hard_forest(trees=24, ppt=16000, extent=42.0, seed=7777):
    """The script's forest: ``make_synthetic_forest_hard`` with ground
    points ``extent ** 2 * 55``."""
    from ..data.synthetic import make_synthetic_forest_hard

    data, _ = make_synthetic_forest_hard(
        n_trees=trees, extent=extent, points_per_tree=ppt,
        ground_points=int(extent ** 2 * 55), seed=seed)
    return data


def bench_hard_forest():
    from ..data.synthetic import make_synthetic_forest_hard

    data, _ = make_synthetic_forest_hard(**BENCH_HARD)
    return data


def run_oracle(data: np.ndarray, grouping=None, device=None,
               noise: float = 0.0, seed: int = 0) -> dict:
    """Voxel downsample, ground-truth offsets (plus xy noise of sigma
    ``noise`` from numpy seed ``seed``) and logits, ``get_instances``, the
    5-NN assignment and the detection score, on ``device``.  Returns the
    scores, ``stage_seconds``, the k-NN calls and ``labels`` (the voxels'
    instance predictions; ``coords`` and ``gt`` beside them)."""
    from ..config import ConfigDict
    from ..device import resolve_device
    from ..ops.cluster import KNN_LOG
    from ..ops.voxelize import voxel_downsample_trace_np
    from ..pipeline.instances import (
        assign_remaining_points_nearest_neighbor, get_instances)
    from ..train.selftrain import detection_f1_from_pointwise

    dev = resolve_device(device)
    grouping = ConfigDict.from_dict(dict(grouping or GROUPING))
    stages = {}
    t = [time.perf_counter()]

    def stage(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t[0]
        t[0] = now

    coords_all = data[:, :3].astype(np.float32)
    labels_all = data[:, 3].astype(np.int64)
    vox, idx, _ = voxel_downsample_trace_np(coords_all, 0.1)
    coords = vox.astype(np.float32)
    labels = labels_all[idx]
    stage("voxelize")
    offs = gt_offsets(coords, labels)
    if noise:
        rng = np.random.default_rng(seed)
        offs = offs + rng.normal(0, noise, offs.shape).astype(np.float32)
    offs = offs.astype(np.float32)
    # ground-truth semantics as logits: tree (class 0) against ground
    logits = np.where((labels > 0)[:, None],
                      np.array([10.0, -10.0], np.float32),
                      np.array([-10.0, 10.0], np.float32))
    stage("offsets")
    del KNN_LOG[:]
    preds = get_instances(coords, offs, logits, grouping, None, 0, 0, -1, 1,
                          search_radius=0.6, device=dev)
    n_clusters = int(preds.max())
    stage("get_instances")
    tree_mask = preds != 0
    preds[tree_mask] = assign_remaining_points_nearest_neighbor(
        (coords + offs)[tree_mask], preds[tree_mask], -1, device=dev)
    stage("assign_remaining")
    fd, pw = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        np.savez(pw, instance_labels=labels, instance_preds=preds)
        q = detection_f1_from_pointwise(pw)
    finally:
        os.remove(pw)
    stage("score")
    return {
        "n_points": int(len(coords_all)), "n_voxels": int(len(coords)),
        "n_trees": int(labels.max()), "n_clusters": n_clusters,
        "f1": q["f1_score"], "completeness": q["completeness"],
        "commission": q["commission_error_rate"],
        "matched_iou": q.get("mean_matched_iou"),
        "n_pred": q["n_pred"], "n_gt": q["n_gt"],
        "preds_per_gt": round(q["n_pred"] / max(q["n_gt"], 1), 4),
        "stage_seconds": {k: round(v, 4) for k, v in stages.items()},
        "knn": [{"route": c.route, "refs": c.n_refs, "queries": c.n_queries}
                for c in KNN_LOG],
        "labels": preds, "coords": coords, "gt": labels,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", type=int, default=24)
    ap.add_argument("--ppt", type=int, default=16000)
    ap.add_argument("--extent", type=float, default=42.0)
    ap.add_argument("--seed", type=int, default=7777)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="sigma of xy noise added to the oracle offsets")
    ap.add_argument("--bench-hard", action="store_true",
                    help="the bench's hard plot (616,177 points) instead")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..ops import _cuda
    from ..utils.profiling import card_line

    dev = resolve_device(args.device)
    t0 = time.time()
    data = (bench_hard_forest() if args.bench_hard else
            hard_forest(args.trees, args.ppt, args.extent, args.seed))
    log(f"[oracle +{time.time() - t0:6.1f}s] forest: {len(data)} points, "
        f"{int(data[:, 3].max())} trees")
    _cuda.reset_launches()
    out = run_oracle(data, device=dev, noise=args.noise)
    log(f"[oracle +{time.time() - t0:6.1f}s] launches "
        f"{json.dumps(_cuda.LAUNCHES)}; k-NN {json.dumps(out['knn'])}")
    log(f"[oracle +{time.time() - t0:6.1f}s] oracle F1 {out['f1']}% "
        f"completeness {out['completeness']}% commission "
        f"{out['commission']}% matched-IoU {out['matched_iou']}% "
        f"({out['n_pred']} preds / {out['n_gt']} gt)")
    line = {k: v for k, v in out.items()
            if k not in ("labels", "coords", "gt")}
    line.update(forest="bench_hard" if args.bench_hard else "script",
                noise=args.noise, card=card_line(dev),
                launches=dict(_cuda.LAUNCHES))
    print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
