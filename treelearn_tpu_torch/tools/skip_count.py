"""Count the training steps the JAX package's self-training skips (host
only, numpy; no model runs):

    python -m treelearn_tpu_torch.tools.skip_count [--steps 6000]

The JAX package's ``train_synthetic_checkpoint`` sizes a static voxel
capacity per U-Net level from its crops (the largest count over the crops,
+35 %, rounded up to a power of two, at least 512, at most
``voxel_capacity``; level 0 at ``voxel_capacity``:
treelearn_tpu/train/selftrain.py:148-166) and makes a step a no-op when
any level of its batch holds more active voxels than that
(treelearn_tpu/train/loop.py:146, counted at selftrain.py:229-238).  The
port has no static capacities and never skips.  This tool writes
``BENCH_RECIPE``'s crops, sizes the capacities as the JAX package does,
walks the batch stream both packages train on (``selftrain.training_stream``)
for ``--steps`` steps, and counts each batch's level voxels as the jitted
step counts them (cell index by the float32 reciprocal of the voxel size).
Prints one JSON line: capacities, the largest count per level, the steps
that would be skipped and the overflowing level of each.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
VOXEL_CAPACITY = 1 << 17      # train_synthetic_checkpoint's default


def level_capacities(max_counts, voxel_capacity: int = VOXEL_CAPACITY):
    """treelearn_tpu/train/selftrain.py:155-166: +35 % headroom, a power of
    two, clamped to [512, voxel_capacity]; level 0 at voxel_capacity."""
    def pow2(x):
        return 1 << int(np.ceil(np.log2(max(int(x), 1))))

    caps = tuple(min(max(pow2(int(c * 1.35)), 512), voxel_capacity)
                 for c in max_counts)
    if caps[0] < voxel_capacity:
        caps = (voxel_capacity,) + caps[1:]
    return caps


def count_skips(steps: int, recipe: dict, model_cfg: dict, log=print,
                voxel_capacity: int = VOXEL_CAPACITY) -> dict:
    from ..ops.voxelize import level_voxel_counts_np
    from ..train.selftrain import training_stream, write_synthetic_crops

    t0 = time.time()
    n_crops, extent = int(recipe["n_crops"]), float(recipe["crop_extent"])
    vs = float(model_cfg.get("voxel_size", 0.1))
    nb = int(model_cfg.get("num_blocks", 7))
    side = int(np.ceil((extent + 4) / 0.1 / 64)) * 64
    shape = [side, side, 256]
    with tempfile.TemporaryDirectory() as crops:
        write_synthetic_crops(crops, n_crops, extent,
                              int(recipe.get("seed0", 101)),
                              float(recipe["hard_frac"]), recipe["ppt"])
        crop_max = np.zeros(nb, np.int64)
        for i in range(n_crops):
            pts = np.load(osp.join(crops, f"crop_{i}.npz"))["points"]
            crop_max = np.maximum(crop_max, level_voxel_counts_np(
                pts.astype(np.float64), vs, shape, nb))
        caps = level_capacities(crop_max, voxel_capacity)
        log(f"skip_count: crops written in {time.time() - t0:.0f} s; level "
            f"capacities {caps} (crop maxima {crop_max.tolist()})")
        loader = training_stream(crops, extent, 1)
        skipped, seen_max, n = [], np.zeros(nb, np.int64), 0
        while n < steps:
            for batch in loader:
                if n >= steps:
                    break
                xyz = batch["coords"][batch["valid"]]
                counts = np.asarray(level_voxel_counts_np(
                    xyz, vs, shape, nb, reciprocal=True))
                seen_max = np.maximum(seen_max, counts)
                over = np.nonzero(counts > np.asarray(caps))[0]
                if len(over):
                    skipped.append((n + 1, int(over[0]), int(counts[over[0]])))
                n += 1
                if n % 500 == 0:
                    log(f"skip_count: {n}/{steps} steps, {len(skipped)} "
                        f"skipped ({time.time() - t0:.0f} s)")
    per_level = np.bincount([s[1] for s in skipped], minlength=nb)
    return {"steps": n, "n_skipped": len(skipped),
            "level_capacities": list(caps),
            "crop_max_counts": crop_max.tolist(),
            "stream_max_counts": seen_max.tolist(),
            "skipped_by_first_level": per_level.tolist(),
            "first_skipped": [list(s) for s in skipped[:20]],
            "seconds": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of the stream to walk (default: the "
                         "recipe's 6000)")
    args = ap.parse_args(argv)

    from ..config import load_yaml_file
    from ..train.selftrain import BENCH_RECIPE

    model_cfg = load_yaml_file(osp.join(REPO, "configs", "_modular",
                                        "model.yaml"))["model"]
    recipe = dict(BENCH_RECIPE)
    out = count_skips(args.steps or recipe["steps"], recipe, model_cfg)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
