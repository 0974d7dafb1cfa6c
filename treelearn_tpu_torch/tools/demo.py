"""End-to-end demo of the PyTorch/CUDA port: segment a (synthetic or real)
forest plot and report per-stage timings and results, the scripted
equivalent of the reference's TreeLearn_Pipeline.ipynb colab notebook.

    python -m treelearn_tpu_torch.tools.demo                        # synthetic 12-tree plot
    python -m treelearn_tpu_torch.tools.demo --forest my_plot.laz   # your own plot (las/laz/npz)
    python -m treelearn_tpu_torch.tools.demo --pretrain weights.pth # trained weights (.pth/.npz)
    python -m treelearn_tpu_torch.tools.demo --device cpu           # plain versions, no card

Outputs land in <workdir>/plot/results: a full labeled cloud (.laz, treeID
extra dimension) and per-tree files, exactly like the reference pipeline
(reference tools/pipeline/pipeline.py:22-200).  Counterpart of
tools/demo.py without its ``--capacity`` flag: the port works on exact
voxel counts and has no static voxel table to size.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

import numpy as np

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--forest", default=None,
                        help="las/laz/npy/npz/txt plot; default: synthetic")
    parser.add_argument("--pretrain", default=None,
                        help="model weights (.pth or .npz)")
    parser.add_argument("--workdir", default="demo_workdir")
    parser.add_argument("--trees", type=int, default=12,
                        help="synthetic tree count")
    parser.add_argument("--hdbscan", action="store_true",
                        help="HDBSCAN grouping instead of DBSCAN")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..config import ConfigDict, get_config
    from ..pipeline import run_treelearn_pipeline

    workdir = osp.abspath(args.workdir)
    forest_dir = osp.join(workdir, "plot", "forest")
    os.makedirs(forest_dir, exist_ok=True)
    if args.forest is None:
        from ..data.synthetic import make_synthetic_forest

        print(f"generating a synthetic {args.trees}-tree plot...")
        data, _ = make_synthetic_forest(n_trees=args.trees, extent=25.0,
                                        points_per_tree=8000,
                                        ground_points=60000, seed=0)
        forest_path = osp.join(forest_dir, "demo_forest.npz")
        np.savez_compressed(forest_path, points=data[:, :3].astype(np.float32),
                            labels=data[:, 3])
    else:
        forest_path = osp.join(forest_dir, osp.basename(args.forest))
        if not osp.exists(forest_path):
            shutil.copy(args.forest, forest_path)

    config = get_config(osp.join(_REPO, "configs", "pipeline", "pipeline.yaml"))
    config.forest_path = forest_path
    config.pretrain = args.pretrain
    config.grouping.use_hdbscan = bool(args.hdbscan)
    config.shape_cfg.outer_remove = None
    config.save_cfg = ConfigDict.from_dict({
        "save_formats": ["laz"], "save_treewise": True,
        "save_pointwise": False, "return_type": "original",
        "results_dir": "results",
    })

    result = run_treelearn_pipeline(config, device=args.device)

    print("\n=== demo results ===")
    print(f"device:       {result['device']}")
    print(f"points:       {result['n_points']}")
    print(f"trees found:  {result['n_trees']}")
    print(f"wall time:    {result['seconds']:.1f}s "
          f"({result['mpts_per_sec']:.3f} Mpts/s)")
    for name, secs in result.get("stage_seconds", {}).items():
        print(f"  stage {name:<18} {secs:7.2f}s")
    print(f"labeled cloud: {result['output_path']}")
    print(f"per-tree files: {osp.join(result['results_dir'], 'individual_trees')}")
    if args.pretrain is None:
        print("\nNOTE: random weights (no --pretrain): segmentation quality is "
              "meaningless; this demo exercises the full pipeline machinery.")
    return result


if __name__ == "__main__":
    main()
