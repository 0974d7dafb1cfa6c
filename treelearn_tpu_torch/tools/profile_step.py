"""Ablation profile of the model's eval step on the bench plot, and the
training step (port of tools/profile_step.py and
scripts/profile_trainstep.py).

    python -m treelearn_tpu_torch.tools.profile_step [--bf16] [--device cpu]
    python -m treelearn_tpu_torch.tools.profile_step --train [--bf16]
        [--steps N] [--trace DIR] [--device cpu]

Without ``--train``: the plot voxelized as the whole-plot path does (one
point per 0.1 m voxel, at its centre) and each successive slice of the
forward timed on the card (voxelize, + level plans, + U-Net and heads; CUDA
events, two warm-up calls, then the mean of ``--reps``), so the differences
say where the forward's time goes.

With ``--train``: ``--steps`` training steps of ``train/loop.py`` (of the
U-Net, or with ``--backbone ptv3`` of Point Transformer V3 at its published
widths under the same heads, or with ``--head spformer`` of SPFormer's query
decoder at its published widths on the U-Net's ``--levels``) on synthetic
crops of the ``BENCH_RECIPE``
geometry (24 m crops, 10,000-16,000 points a tree, 80 % hard forests, lr
1.5e-3, AdamW, warmup cosine, clip 1.0), host clock around each step (it
ends when its loss is read, which waits for the card); the first step apart
from the median of steps 2..N.
``--trace DIR`` then traces the last timed step's batch once more
(utils/trace.py), beside that batch's own step time; with ``--head
spformer`` it also prints each decoder layer's open share (the
``spformer.open_pairs.l<l>`` counters over the queries times the keys).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import bench_points, card_line, model_inputs, timed_ms

SEED = 101    # train/selftrain.py's seed0: its crops and initial weights


def whole_plot_voxels(points=None, vs: float = 0.1):
    """The JAX profiler's input: the plot's occupied voxels' centres
    relative to their minimum, and the spatial shape around them."""
    pts = bench_points(points).astype(np.float64)
    pts = pts - pts.mean(0)
    vox = np.unique(np.floor((pts - pts.min(0)) / vs).astype(np.int32),
                    axis=0)
    vox_pts = (vox + 0.5) * vs + pts.min(0)
    ext = vox_pts.max(0) - vox_pts.min(0)
    ss = tuple(int(np.ceil((np.ceil(e / vs) + 2) / 64)) * 64 for e in ext)
    return (vox_pts - vox_pts.min(0)).astype(np.float32), ss


def ablation(args, dev, dtype) -> dict:
    from ..model import TreeLearn
    from ..model.network import build_level_plans
    from ..ops.sparse import grid_from_sorted_keys
    from ..ops.voxelize import voxelize_points

    coords, ss = whole_plot_voxels(args.points)
    print(f"voxels={len(coords)} spatial_shape={ss}")
    inputs = model_inputs(coords, dev)
    model = TreeLearn(channels=args.channels, num_blocks=args.levels,
                      spatial_shape=list(ss), voxel_size=0.1)
    model = model.init(0).to(dev).eval()

    def stage_vox():
        return voxelize_points(*inputs, batch_size=1, voxel_size=0.1,
                               max_pts=3, spatial_shape=ss)

    def stage_plans():
        vb = stage_vox()
        return build_level_plans(
            grid_from_sorted_keys(vb.voxel_keys, vb.spatial_shape),
            args.levels)

    def full():
        with torch.no_grad():
            return model(*inputs, batch_size=1, compute_dtype=dtype)

    res = {"voxels": len(coords)}
    res["voxelize_ms"] = timed_ms(stage_vox, dev, args.reps)
    print(f"voxelize            : {res['voxelize_ms']:8.2f} ms", flush=True)
    res["voxels_per_level"] = [p.grid.n_active for p in stage_plans()]
    print(f"n_voxels_per_level = {res['voxels_per_level']}")
    res["plans_ms"] = timed_ms(stage_plans, dev, args.reps)
    print(f"voxelize + plans    : {res['plans_ms']:8.2f} ms   (plans alone "
          f"~{res['plans_ms'] - res['voxelize_ms']:.2f} ms)", flush=True)
    res["forward_ms"] = timed_ms(full, dev, args.reps)
    print(f"full forward ({str(dtype)[6:]}): {res['forward_ms']:8.2f} ms   "
          f"(unet+heads alone ~{res['forward_ms'] - res['plans_ms']:.2f} ms)")
    return res


def train_steps(args, dev, dtype) -> dict:
    from ..data import TreeDataset, TreeLoader
    from ..model import TreeLearn
    from ..train.loop import build_optimizer, make_train_step
    from ..train.selftrain import BENCH_RECIPE, write_synthetic_crops

    extent = args.crop_extent or BENCH_RECIPE["crop_extent"]
    ppt = tuple(args.ppt) if args.ppt else BENCH_RECIPE["ppt"]
    side = int(np.ceil((extent + 4) / 0.1 / 64)) * 64
    if args.backbone == "ptv3":
        from ..model.ptv3 import PUBLISHED

        model = TreeLearn(backbone="ptv3", ptv3=dict(PUBLISHED),
                          spatial_shape=[side, side, 256])
    elif args.head == "spformer":
        from ..model.spformer import PUBLISHED

        model = TreeLearn(channels=args.channels, num_blocks=args.levels,
                          spatial_shape=[side, side, 256], head="spformer",
                          spformer=dict(PUBLISHED))
    else:
        model = TreeLearn(channels=args.channels, num_blocks=args.levels,
                          spatial_shape=[side, side, 256])
    model = model.init(np.random.SeedSequence(SEED)).to(dev)
    lr = BENCH_RECIPE["lr"]
    optimizer, scheduler = build_optimizer(
        model.parameters(), {"type": "AdamW", "lr": lr, "weight_decay": 1e-3},
        scheduler_cfg={"t_initial": BENCH_RECIPE["steps"], "warmup_t": 30,
                       "lr_min": lr / 20, "warmup_lr_init": lr / 100},
        steps_per_epoch=1)
    step_fn = make_train_step(model, optimizer, scheduler, batch_size=1,
                              compute_dtype=dtype, grad_norm_clip=True,
                              device=dev)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        write_synthetic_crops(d, args.crops, extent, SEED,
                              BENCH_RECIPE["hard_frac"], ppt)
        dataset = TreeDataset(
            d, inner_square_edge_length=extent, training=True,
            data_augmentations={"jitter": True, "flip": True, "rot": True,
                                "scaled": False, "point_jitter": False},
            seed=SEED)
        loader = TreeLoader(dataset, batch_size=1, training=True, seed=SEED)
        batches = []
        while len(batches) < args.steps + 1:
            batches.extend(loader)
        loader.close()      # its producer would read on in a removed folder
    losses, seconds = [], []
    for b in batches[:args.steps]:
        t0 = time.perf_counter()
        loss, _ = step_fn(b)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    res = {"points": [int(b["n_points"]) for b in batches[:args.steps]],
           "losses": losses, "step_seconds": seconds,
           "first_step_s": seconds[0],
           "median_step_s": (float(np.median(seconds[1:]))
                             if len(seconds) > 1 else None)}
    print(f"train: {args.steps} steps ({str(dtype)[6:]}, crops of "
          f"{res['points']} points), first step {seconds[0]:.4f} s, "
          f"median of steps 2..{args.steps} "
          + (f"{res['median_step_s']:.4f} s" if len(seconds) > 1 else "-"))
    print(f"  losses {[round(x, 4) for x in losses]}", flush=True)
    if dev.type == "cuda":
        res["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        print(f"  peak device memory {res['peak_bytes']} B", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if args.trace:
        from ..utils.trace import trace_parts

        last = batches[args.steps - 1]
        print(f"\ntrace of one warm training step (the last timed batch: "
              f"{int(last['n_points'])} points, {seconds[-1]:.4f} s "
              f"untraced):")
        res["trace"] = trace_parts(lambda: float(step_fn(last)[0]),
                                   args.trace, "train_step", dev)
        if args.head == "spformer":
            res["open_share"] = open_shares(res["trace"]["counters"],
                                            model.spformer.num_query)
            print("open share of each decoder layer's mask: "
                  + ", ".join(f"l{i + 1} {v:.4f}" for i, v in
                              enumerate(res["open_share"])), flush=True)
    return res


def open_shares(counters: dict, n_query: int) -> list:
    """Per decoder layer, the share of (query, key) pairs its attention
    mask left open, from one traced step's counters."""
    keys = counters.get("spformer.keys", 0) * n_query
    out, layer = [], 1
    while f"spformer.open_pairs.l{layer}" in counters:
        out.append(counters[f"spformer.open_pairs.l{layer}"] / max(keys, 1))
        layer += 1
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="time training steps instead of the forward slices")
    ap.add_argument("--points", type=int, default=None,
                    help="the plot's first N points (default all)")
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--backbone", choices=("unet", "ptv3"), default="unet",
                    help="with --train: the model's backbone (ptv3: the "
                    "published widths; --levels and --channels unused)")
    ap.add_argument("--head", choices=("offset", "spformer"),
                    default="offset",
                    help="with --train: the model's head (spformer: "
                    "SPFormer's decoder at its published widths)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--crops", type=int, default=4)
    ap.add_argument("--crop-extent", type=float, default=None,
                    help="crop edge in metres (BENCH_RECIPE: 24)")
    ap.add_argument("--ppt", type=int, nargs=2, default=None,
                    metavar=("LO", "HI"), help="points a tree (BENCH_RECIPE)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="with --train: trace one warm step into DIR")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    print(f"device: {dev}; card: {card_line(dev)}", flush=True)
    res = train_steps(args, dev, dtype) if args.train else ablation(
        args, dev, dtype)
    res["card"] = card_line(dev)
    return res


if __name__ == "__main__":
    main()
