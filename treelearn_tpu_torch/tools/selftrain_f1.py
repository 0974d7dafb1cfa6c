"""Detection F1 of a self-trained checkpoint on the bench plot, in both
grouping modes (card only):

    python -m treelearn_tpu_torch.tools.selftrain_f1 --cache-dir work_dirs/selftrain [--max-seconds S]

Trains (or resumes, or takes from ``--cache-dir``) ``train_synthetic_checkpoint``
with ``BENCH_RECIPE`` (192 synthetic crops of 24 m, 10,000-16,000 points a
tree, 80 % hard-mode, lr 1.5e-3) at the model width of
``configs/_modular/model.yaml``, bf16, stopping after ``--max-seconds`` of
training with a partial checkpoint that a later call resumes.  Then runs the
pipeline with those weights on ``make_synthetic_forest(n_trees=48,
extent=60, points_per_tree=16000, ground_points=200000, seed=0)`` (968,000
points) once in DBSCAN mode and once in HDBSCAN mode, and scores each run:
``detection_f1_from_pointwise`` and ``segmentation_partition_summary`` on
the pointwise dump, ``tools/evaluate.py`` on the full cloud.  Prints one JSON
line per mode after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache-dir", required=True,
                    help="where the checkpoint (and a partial one) is kept")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="training budget; a partial checkpoint is kept")
    args = ap.parse_args(argv)

    import torch

    from ..config import ConfigDict, get_config, load_yaml_file
    from ..data.synthetic import make_synthetic_forest
    from ..device import resolve_device
    from ..pipeline import run_treelearn_pipeline
    from ..train.selftrain import (BENCH_RECIPE, detection_f1_from_pointwise,
                                   segmentation_partition_summary,
                                   train_synthetic_checkpoint)
    from .evaluate import evaluate

    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    model_cfg = dict(load_yaml_file(osp.join(
        REPO, "configs", "_modular", "model.yaml"))["model"])
    t0 = time.time()
    ckpt, info = train_synthetic_checkpoint(
        model_cfg, cache_dir=args.cache_dir, max_seconds=args.max_seconds,
        return_info=True, log_every=250, logger=lambda m: print(m, flush=True),
        device="cuda", compute_dtype=torch.bfloat16, **BENCH_RECIPE)
    step_s = np.asarray(info["step_seconds"])
    train = {"checkpoint": osp.basename(ckpt), "complete": info["complete"],
             "completed_steps": info["completed_steps"],
             "target_steps": info["target_steps"], "cached": info["cached"],
             "steps_this_call": len(step_s),
             "train_call_s": time.time() - t0}
    if len(step_s) > 1:
        train.update(first_step_s=float(step_s[0]),
                     median_step_s=float(np.median(step_s[1:])),
                     last_losses=[float(x) for x in info["losses"][-5:]])
    print(json.dumps({"train": train}), flush=True)

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        data, _ = make_synthetic_forest(n_trees=48, extent=60,
                                        points_per_tree=16000,
                                        ground_points=200000, seed=0)
        d = osp.join(tmp, "plot", "forest")
        os.makedirs(d)
        path = osp.join(d, "bench.npz")
        np.savez(path, points=data[:, :3].astype(np.float32),
                 labels=data[:, 3])
        for mode in ("dbscan", "hdbscan"):
            config = get_config(osp.join(REPO, "configs", "pipeline",
                                         "pipeline.yaml"))
            config.forest_path = path
            config.pretrain = ckpt
            config.grouping.use_hdbscan = mode == "hdbscan"
            config.save_cfg = ConfigDict.from_dict({
                "save_formats": ["las"], "save_treewise": False,
                "save_pointwise": True, "save_backbone_feats": False,
                "return_type": "original", "results_dir": f"results_{mode}"})
            t1 = time.time()
            res = run_treelearn_pipeline(config, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t1
            pw = osp.join(res["results_dir"], "pointwise_results",
                          "pointwise_results.npz")
            cand = int((np.load(pw)["instance_preds_after_initial_clustering"]
                        >= 1).sum())
            ecfg = get_config(osp.join(REPO, "configs", "evaluation",
                                       "evaluate.yaml"))
            ecfg.paths.pred_forest_path = res["output_path"]
            ecfg.paths.gt_forest_path = path
            ecfg.work_dir = osp.join(tmp, f"eval_{mode}")
            ev = evaluate(ecfg, device="cuda")
            det, seg = ev["detection_results"], ev["segmentation_results"]
            print(json.dumps({
                "mode": mode, "n_trees": res["n_trees"], "wall_s": wall,
                "stage_seconds": res["stage_seconds"],
                "clustered_points": cand,
                "pointwise": detection_f1_from_pointwise(pw),
                "partitions": segmentation_partition_summary(pw),
                "evaluate": {k: det[k] for k in (
                    "f1_score", "completeness", "omission_error_rate",
                    "commission_error_rate")} | {
                    "precision": seg["precision"], "recall": seg["recall"],
                    "coverage": seg["iou"]}}), flush=True)


if __name__ == "__main__":
    main()
