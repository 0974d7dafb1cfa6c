"""Hard-forest quality experiment of the port (counterpart of
scripts/exp_hard_quality.py):

    python -m treelearn_tpu_torch.tools.hard_quality [--steps 600] [--crops 12] [--seed0 101] [--recipe bench] [--device cpu]

Trains a self-training recipe variant (``train_synthetic_checkpoint``, bf16
on the card, cached in ``--cache-dir``), runs the whole pipeline with it on
a held-out hard forest (``make_synthetic_forest_hard``, seed 7777) with the
script's config overrides, and prints one JSON line: the quality chain of
the run's pointwise dump (``eval/quality.py:quality_chain``: xy offset
error of trunk and crown points, crown direction cosine and magnitude
ratio, detection F1, partition IoUs), the training seconds and steps, and
the card's name and power limit.  ``--recipe bench`` trains
``BENCH_RECIPE`` at the bench's model config and cache directory, so it
scores the bench's cached checkpoint.  Runs on the card unless given
``--device cpu``; the launch counts of the training and of the pipeline run
(each zeroed just before) go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
# scripts/exp_hard_quality.py:48-51
MODEL_CFG = {"channels": 32, "num_blocks": 7, "kernel_size": 3,
             "dim_coord": 3, "dim_feat": 1, "use_feats": False,
             "spatial_shape": [512, 512, 256], "voxel_size": 0.1,
             "max_num_points_per_voxel": 3}
EVAL_SEED = 7777


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def training_kwargs(args) -> tuple:
    """(model config, train_synthetic_checkpoint keywords) of the flags:
    the script's recipe, or ``BENCH_RECIPE`` at the bench's model."""
    from ..train.selftrain import BENCH_RECIPE

    if args.recipe == "bench":
        from .bench import bench_config

        mc = dict(bench_config("", 1 << 18).model)
        kw = dict(BENCH_RECIPE)
    else:
        mc = dict(MODEL_CFG)
        kw = {"steps": args.steps, "lr": args.lr, "n_crops": args.crops,
              "hard_frac": args.hard_frac}
        if args.recipe_v is not None:
            kw["recipe_v"] = args.recipe_v
        if args.crop_extent is not None:
            kw["crop_extent"] = args.crop_extent
        if args.train_ppt is not None:
            kw["ppt"] = (tuple(int(x) for x in args.train_ppt.split(":"))
                         if ":" in args.train_ppt else int(args.train_ppt))
    if args.seed0 is not None:
        kw["seed0"] = args.seed0
    if args.channels is not None:
        mc["channels"] = args.channels
    if args.num_blocks is not None:
        mc["num_blocks"] = args.num_blocks
    return mc, kw


def eval_config(forest_path: str, ckpt: str, model_cfg: dict):
    """configs/pipeline/pipeline.yaml with the script's overrides
    (scripts/exp_hard_quality.py:85-98) and the trained model's config."""
    from ..config import ConfigDict, get_config

    config = get_config(osp.join(REPO, "configs", "pipeline",
                                 "pipeline.yaml"))
    config.forest_path = forest_path
    config.pretrain = ckpt
    config.tile_generation = True
    config.grouping.use_hdbscan = False
    config.save_cfg = ConfigDict.from_dict({
        "save_formats": [], "save_treewise": False,
        "save_pointwise": True, "return_type": "original",
        "save_backbone_feats": False, "results_dir": "results"})
    config.shape_cfg.outer_remove = None
    config.voxel_capacity = 1 << 18
    config.dataloader.batch_size = 1
    for k in ("channels", "num_blocks"):
        config.model[k] = model_cfg[k]
    return config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--crops", type=int, default=12)
    ap.add_argument("--hard-frac", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ppt", type=int, default=9000,
                    help="kept from the script, which ignores it too; "
                         "--train-ppt sets the training density")
    ap.add_argument("--trees", type=int, default=24)
    ap.add_argument("--extent", type=float, default=42.0)
    ap.add_argument("--eval-ppt", type=int, default=16000)
    ap.add_argument("--skip-assign", action="store_true",
                    help="kept from the script, which ignores it too")
    ap.add_argument("--recipe-v", type=int, default=None,
                    help="override recipe version tag (cache key)")
    ap.add_argument("--crop-extent", type=float, default=None,
                    help="training crop extent (selftrain default 30)")
    ap.add_argument("--train-ppt", type=str, default=None,
                    help="training points-per-tree: int or 'lo:hi' range")
    ap.add_argument("--seed0", type=int, default=None,
                    help="seed of the weights and crops (selftrain "
                         "default 101)")
    ap.add_argument("--recipe", choices=("script", "bench"),
                    default="script",
                    help="bench: BENCH_RECIPE at the bench's model config "
                         "(scores the bench's cached checkpoint)")
    ap.add_argument("--channels", type=int, default=None,
                    help="model width (default 32; small for CPU runs)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="U-Net levels (default 7)")
    ap.add_argument("--cache-dir", default=None,
                    help="checkpoint cache (default: the bench's, "
                         "~/.cache/treelearn_bench_torch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..data.synthetic import make_synthetic_forest_hard
    from ..device import resolve_device
    from ..eval.quality import quality_chain
    from ..ops import _cuda
    from ..pipeline import run_treelearn_pipeline
    from ..train.selftrain import train_synthetic_checkpoint
    from ..utils.profiling import card_line
    from .bench import CACHE_DIR

    dev = resolve_device(args.device)
    t_start = time.time()

    def tlog(m):
        log(f"[hard_quality +{time.time() - t_start:6.1f}s] {m}")

    mc, kw = training_kwargs(args)
    _cuda.reset_launches()
    t0 = time.time()
    ckpt, info = train_synthetic_checkpoint(
        mc, cache_dir=osp.expanduser(args.cache_dir or CACHE_DIR),
        logger=tlog, log_every=200, return_info=True, device=dev,
        compute_dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        **kw)
    train_s = time.time() - t0
    tlog(f"checkpoint: {ckpt} ({info['completed_steps']} steps, cached "
         f"{info['cached']}); launches {json.dumps(_cuda.LAUNCHES)}")

    data, _ = make_synthetic_forest_hard(
        n_trees=args.trees, extent=args.extent,
        points_per_tree=args.eval_ppt,
        ground_points=int(args.extent ** 2 * 55), seed=EVAL_SEED)
    tlog(f"eval forest: {len(data)} pts, {int(data[:, 3].max())} trees")
    work = tempfile.mkdtemp(prefix="hard_quality_")
    try:
        forest_dir = osp.join(work, "plot", "forest")
        os.makedirs(forest_dir)
        fp = osp.join(forest_dir, "eval_forest.npz")
        np.savez(fp, points=data[:, :3].astype(np.float32), labels=data[:, 3])
        config = eval_config(fp, ckpt, mc)
        _cuda.reset_launches()
        t0 = time.time()
        res = run_treelearn_pipeline(config, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        pipe_s = time.time() - t0
        tlog(f"pipeline: {pipe_s:.1f}s stages={res['stage_seconds']}; "
             f"launches {json.dumps(_cuda.LAUNCHES)}")
        pw = osp.join(res["results_dir"], "pointwise_results",
                      "pointwise_results.npz")
        out = quality_chain(pw)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tlog(f"xy err: trunk med {out['xy_err_trunk_median']:.3f} crown med "
         f"{out['xy_err_crown_median']:.3f} crown p90 "
         f"{out['xy_err_crown_p90']:.3f} all-tree med "
         f"{out['xy_err_tree_median']:.3f}; crown dir cos med "
         f"{out['crown_cos_median']:.3f}, mag ratio med "
         f"{out['crown_mag_ratio_median']:.3f}")
    tlog(f"detection: F1 {out['f1']}% completeness {out['completeness']}% "
         f"commission {out['commission']}% matched-IoU {out['matched_iou']}% "
         f"({out['n_pred']} preds / {out['n_gt']} gt); partitions: xy "
         f"{out['xy_partition_mean_iou']}% z {out['z_partition_mean_iou']}%")
    out.update(train_seconds=round(train_s, 1),
               trained_steps=info["completed_steps"],
               train_cached=info["cached"], recipe=args.recipe,
               seed0=kw.get("seed0", 101), pipeline_seconds=round(pipe_s, 2),
               n_eval_points=int(len(data)), card=card_line(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
