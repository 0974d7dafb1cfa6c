"""Training-crop generation CLI of the PyTorch/CUDA port:

    python -m treelearn_tpu_torch.tools.gen_train_data --config configs/data_gen/gen_train_data.yaml [--device cpu]

Counterpart of tools/gen_train_data.py (reference tools/data_gen/
gen_train_data.py): voxelize each plot of ``<base_dir>/forests``, compute
its whole-plot verticality (kernel 4 on the card, ops/features.py), build
occupancy grids, allocate crops to the plots in proportion to their
occupied area, and cut rotated random crops into
``<base_dir>/random_crops/{npz,json}``.  Every stage skips a plot whose
output file exists.  Runs on the card by default; ``--device cpu`` runs
the plain versions.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np

INSTANCE_LABEL_IGNORE = -1


def generate_random_crops(cfg, device=None) -> dict:
    """Write the random training crops of every plot under
    ``cfg.base_dir``; returns the crops written per plot file and the
    seconds per stage."""
    from ..device import resolve_device
    from ..io.pointcloud import load_data
    from ..logging_utils import get_root_logger
    from ..ops.features import compute_verticality
    from ..ops.voxelize import voxel_downsample_trace_np
    from ..pipeline.tiles import SampleGenerator

    device = resolve_device(device)
    documentation_dir = osp.join(cfg.base_dir, "documentation")
    os.makedirs(documentation_dir, exist_ok=True)
    logger = get_root_logger(osp.join(documentation_dir,
                                      "log_random_crop_generation"))

    forests_dir = osp.join(cfg.base_dir, "forests")
    voxelized_dir = osp.join(cfg.base_dir,
                             f"forests_voxelized{cfg.sample_generation.voxel_size}")
    features_dir = osp.join(cfg.base_dir, "features")
    occupancy_dir = osp.join(cfg.base_dir, "occupancy")
    save_dir = osp.join(cfg.base_dir, "random_crops")
    for d in (voxelized_dir, features_dir, occupancy_dir, save_dir):
        os.makedirs(d, exist_ok=True)

    stage_seconds = {}
    t0 = time.time()
    logger.info("voxelizing forests...")
    for plot_file in sorted(os.listdir(forests_dir)):
        out = osp.join(voxelized_dir, f"{plot_file[:-4]}.npz")
        if osp.exists(out):
            continue
        data = load_data(osp.join(forests_dir, plot_file))
        down, first_idx, _ = voxel_downsample_trace_np(
            data[:, :3], cfg.sample_generation.voxel_size)
        labels = data[first_idx, 3]
        np.savez_compressed(out, points=np.round(down, 2).astype(np.float32),
                            labels=labels)
    stage_seconds["voxelize"] = time.time() - t0

    t0 = time.time()
    logger.info("calculating features...")
    for plot_file in sorted(os.listdir(voxelized_dir)):
        out = osp.join(features_dir, f"{plot_file[:-4]}.npz")
        if osp.exists(out):
            continue
        data = load_data(osp.join(voxelized_dir, plot_file))
        features = compute_verticality(
            data[:, :3].astype(np.float32),
            search_radius=cfg.sample_generation.search_radius_features,
            device=device)
        np.savez_compressed(out, features=features)
    stage_seconds["features"] = time.time() - t0

    t0 = time.time()
    logger.info("calculating occupancy...")
    n_occupied = {}
    gens = {}
    for plot_file in sorted(os.listdir(voxelized_dir)):
        gen = SampleGenerator(
            plot_path=osp.join(voxelized_dir, plot_file),
            features_path=osp.join(features_dir, plot_file),
            save_dir=save_dir)
        gen.get_occupancy_grid(
            osp.join(occupancy_dir, plot_file), cfg.occupancy_res,
            cfg.n_points_to_calculate_occupancy, cfg.how_far_fill,
            cfg.min_percent_occupied_fill,
            ignore_for_occupancy=INSTANCE_LABEL_IGNORE)
        n_occupied[plot_file] = float(gen.occupancy_grid[:, :, 2].sum())
        gens[plot_file] = gen

    # crops in proportion to occupied area; the rounding drift goes to the
    # last plot
    total = sum(n_occupied.values())
    n_samples = {p: int(np.round(v / total * cfg.n_samples_total))
                 for p, v in n_occupied.items()}
    drift = cfg.n_samples_total - sum(n_samples.values())
    if drift and n_samples:
        n_samples[list(n_samples)[-1]] += drift
    stage_seconds["occupancy"] = time.time() - t0

    t0 = time.time()
    logger.info("getting chunks...")
    saved = {}
    for plot_file, gen in gens.items():
        gen.generate_candidates(cfg.n_samples_total, n_samples[plot_file],
                                cfg.chunk_size)
        gen.check_occupancy(cfg.min_percent_occupied_choose)
        saved[plot_file] = gen.save()
        logger.info(f"{plot_file}: saved {saved[plot_file]} crops")
    stage_seconds["crops"] = time.time() - t0
    return {"crops": saved, "stage_seconds": stage_seconds}


def main(argv=None):
    from ..config import get_config

    parser = argparse.ArgumentParser("random_crop_generation")
    parser.add_argument("--config", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return generate_random_crops(get_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
