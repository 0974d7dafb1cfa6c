"""Validation-tile generation CLI of the PyTorch/CUDA port:

    python -m treelearn_tpu_torch.tools.gen_val_data --config configs/data_gen/gen_val_data.yaml [--device cpu]

Counterpart of tools/gen_val_data.py (reference tools/data_gen/
gen_val_data.py): voxelize the plot at ``forest_path``, compute the
whole-plot verticality (kernel 4 on the card, ops/features.py), and cut
tiles with stride 1 (no overlap) into ``<base_dir>/tiles/{npz,json}``,
where ``base_dir`` is the folder above the plot's folder.  Runs on the card
by default; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def generate_val_tiles(cfg, device=None) -> dict:
    """Write the validation tiles of ``cfg.forest_path``; returns the tiles
    directory, the tiles written and the seconds per stage."""
    from ..device import resolve_device
    from ..logging_utils import get_root_logger
    from ..pipeline.tiles import generate_tiles

    device = resolve_device(device)
    base_dir = osp.dirname(osp.dirname(cfg.forest_path))
    logger = get_root_logger(osp.join(base_dir, "log_tile_generation"))
    stage_seconds = {}
    tiles_dir = generate_tiles(cfg.sample_generation, cfg.forest_path, logger,
                               device=device, stage_seconds=stage_seconds)
    return {"tiles_dir": tiles_dir,
            "tiles": len(os.listdir(osp.join(tiles_dir, "npz"))),
            "stage_seconds": stage_seconds}


def main(argv=None):
    from ..config import get_config

    parser = argparse.ArgumentParser("tile_generation")
    parser.add_argument("--config", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return generate_val_tiles(get_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
