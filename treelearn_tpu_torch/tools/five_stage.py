"""The users' whole workflow through the port's CLIs, on synthetic plots
(counterpart of scripts/five_stage_e2e.py):

    python -m treelearn_tpu_torch.tools.five_stage [--device cpu] [--work DIR]

  1. tools.gen_train_data  random crops from two training plots
  2. tools.gen_val_data    validation tiles of a third plot
  3. tools.train           a few epochs on the crops (``epoch_<n>.pth``)
  4. tools.pipeline        segment a held-out plot with the checkpoint
  5. tools.evaluate        score the segmentation against its labels

Each stage is a subprocess ``python -m treelearn_tpu_torch.tools.<stage>``
with a small user config that includes the shipped task config through
``default_args``, and ``--device`` passed through; one PASS or FAIL line a
stage, and the run exits non-zero on the first FAIL.  Last it executes the
port's evaluation notebook (``notebooks/TreeLearn_Evaluation_Torch.ipynb``:
its code cells in order in one namespace, ``MPLBACKEND=Agg``) on the
artifacts the stages wrote; without ``matplotlib`` it prints
``notebook: not run (no matplotlib)`` instead.  The workspace is
``--work``, else ``$FIVE_STAGE_DIR``, else ``five_stage`` in the temporary
directory.  The defaults are the script's plots and settings; the size
flags cut them (the tests run channels 8, 2 levels on small plots).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np
import yaml

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
NOTEBOOK = osp.join(REPO, "treelearn_tpu_torch", "notebooks",
                    "TreeLearn_Evaluation_Torch.ipynb")
# scripts/five_stage_e2e.py:59-74: (seed, trees, extent m, ground points)
TRAIN_PLOTS = ((11, 14, 45.0, 80000), (12, 14, 45.0, 80000))
VAL_PLOT = (21, 10, 40.0, 60000)
HELDOUT_PLOT = (31, 12, 42.0, 70000)


def default_work() -> str:
    return os.environ.get("FIVE_STAGE_DIR",
                          osp.join(tempfile.gettempdir(), "five_stage"))


def write_plot(path: str, plot, ppt: int, scale: float) -> None:
    """One ``make_synthetic_forest`` plot; ``scale`` shrinks the extent
    (and the trees and ground points with the area)."""
    from ..data.synthetic import make_synthetic_forest

    seed, trees, extent, ground = plot
    data, _ = make_synthetic_forest(
        n_trees=max(int(round(trees * scale ** 2)), 2), extent=extent * scale,
        points_per_tree=ppt, ground_points=int(ground * scale ** 2),
        seed=seed)
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])


def write_cfg(work: str, name: str, base: str, **overrides) -> str:
    cfg = {"default_args": [osp.join(REPO, base)]}
    cfg.update(overrides)
    path = osp.join(work, f"cfg_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def child_env(**extra) -> dict:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def sh(label: str, cmd, work: str, timeout: float = 1500, env=None):
    """Run one stage; print its PASS / FAIL line; exit non-zero on FAIL."""
    t0 = time.time()
    p = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                       timeout=timeout, env=env or child_env())
    ok = p.returncode == 0
    print(f"[{'PASS' if ok else 'FAIL'} {time.time() - t0:6.1f}s] {label}",
          flush=True)
    if not ok:
        print(p.stdout[-1500:])
        print(p.stderr[-3000:], flush=True)
        sys.exit(1)
    return p


def model_overrides(args) -> dict:
    m = {}
    if args.channels is not None:
        m["channels"] = args.channels
    if args.num_blocks is not None:
        m["num_blocks"] = args.num_blocks
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--work", default=None,
                    help="workspace (default $FIVE_STAGE_DIR, else "
                         "five_stage in the temporary directory)")
    ap.add_argument("--ppt", type=int, default=3000,
                    help="points per tree of every plot")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="extent factor of every plot (trees and ground "
                         "points follow the area)")
    ap.add_argument("--samples", type=int, default=60,
                    help="gen_train_data's n_samples_total")
    ap.add_argument("--chunk", type=float, default=None,
                    help="crop edge of gen_train_data (default the "
                         "config's 35 m)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--examples", type=int, default=8,
                    help="examples_per_epoch")
    ap.add_argument("--channels", type=int, default=None,
                    help="model width (default the config's 32)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="U-Net levels (default the config's 7)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)     # no card, no --device cpu: raise
    dflag = ["--device", str(dev.type)]
    work = osp.abspath(args.work or default_work())
    for d in ("train/forests", "val/forests", "plot/forest"):
        os.makedirs(osp.join(work, d), exist_ok=True)
    t0 = time.time()
    for i, plot in enumerate(TRAIN_PLOTS):
        write_plot(osp.join(work, "train", "forests", f"plot{i}.npz"), plot,
                   args.ppt, args.scale)
    write_plot(osp.join(work, "val", "forests", "valplot.npz"), VAL_PLOT,
               args.ppt, args.scale)
    heldout = osp.join(work, "plot", "forest", "heldout.npz")
    write_plot(heldout, HELDOUT_PLOT, args.ppt, args.scale)
    print(f"synthetic plots written ({time.time() - t0:.1f}s) under {work}",
          flush=True)

    py = sys.executable
    model = model_overrides(args)
    gen = {"base_dir": osp.join(work, "train"),
           "n_samples_total": args.samples}
    if args.chunk is not None:
        gen["chunk_size"] = args.chunk
    c1 = write_cfg(work, "gen_train", "configs/data_gen/gen_train_data.yaml",
                   **gen)
    sh("gen_train_data", [py, "-m", "treelearn_tpu_torch.tools.gen_train_data",
                          "--config", c1] + dflag, work)

    c2 = write_cfg(work, "gen_val", "configs/data_gen/gen_val_data.yaml",
                   forest_path=osp.join(work, "val", "forests",
                                        "valplot.npz"))
    sh("gen_val_data", [py, "-m", "treelearn_tpu_torch.tools.gen_val_data",
                        "--config", c2] + dflag, work)

    train = dict(
        dataset_train={"data_root": osp.join(work, "train", "random_crops",
                                             "npz")},
        dataset_test={"data_root": osp.join(work, "val", "tiles", "npz")},
        epochs=args.epochs, examples_per_epoch=args.examples,
        dataloader={"train": {"batch_size": 1, "num_workers": 0},
                    "test": {"batch_size": 1, "num_workers": 0}},
        voxel_capacity=1 << 17, validation_frequency=args.epochs,
        save_frequency=1, fp16=True)
    if model:
        train["model"] = model
    c3 = write_cfg(work, "train", "configs/training/train.yaml", **train)
    ckpt_dir = osp.join(work, "work")
    sh("train", [py, "-m", "treelearn_tpu_torch.tools.train", "--config", c3,
                 "--work_dir", ckpt_dir] + dflag, work)
    ckpts = sorted((c for c in os.listdir(ckpt_dir) if c.endswith(".pth")),
                   key=lambda c: int(c[len("epoch_"):-len(".pth")]))
    print(f"checkpoint: {ckpts[-1]}", flush=True)

    pipe = dict(forest_path=heldout, pretrain=osp.join(ckpt_dir, ckpts[-1]),
                voxel_capacity=1 << 18, fp16=True,
                shape_cfg={"outer_remove": None},
                save_cfg={"save_treewise": True})
    if model:
        pipe["model"] = model
    c4 = write_cfg(work, "pipeline", "configs/pipeline/pipeline.yaml", **pipe)
    sh("pipeline", [py, "-m", "treelearn_tpu_torch.tools.pipeline",
                    "--config", c4] + dflag, work)
    results = osp.join(work, "plot", "results")
    laz = osp.join(results, "full_forest", "heldout.laz")
    if not osp.isfile(laz):
        print(f"[FAIL] pipeline: missing {laz}", flush=True)
        sys.exit(1)

    c5 = write_cfg(work, "evaluate", "configs/evaluation/evaluate.yaml",
                   paths={"pred_forest_path": laz, "gt_forest_path": heldout})
    sh("evaluate", [py, "-m", "treelearn_tpu_torch.tools.evaluate",
                    "--config", c5, "--work_dir", osp.join(work, "eval")]
       + dflag, work)

    # the evaluation notebook on the artifacts the stages just wrote
    if importlib.util.find_spec("matplotlib") is None:
        print("notebook: not run (no matplotlib)", flush=True)
        print("FIVE-STAGE: 5 stages PASS; notebook not run", flush=True)
        return 0
    sh("eval notebook", [py, "-m", "treelearn_tpu_torch.utils.notebook",
                         NOTEBOOK], work, timeout=600,
       env=child_env(FIVE_STAGE_DIR=work, MPLBACKEND="Agg"))
    print("FIVE-STAGE E2E: ALL PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
