"""Model profiler: splits the forward into voxelize / plans / U-Net + heads on
the card, gives the forward's MFU, and times the submanifold conv of every
level two ways (port of tools/profile_model.py).

    python -m treelearn_tpu_torch.tools.profile_model [--points N]
        [--levels L] [--reps R] [--bf16] [--trace DIR] [--device cpu]

Voxelize alone, voxelize + the level plans (rulebooks and downsample
rulebooks) and the full forward are timed apart (CUDA events: two warm-up
calls, then the mean of ``--reps``), so their differences put the time on
each stage.  Forward MFU is ``model/network.py:analytic_model_flops`` with
the exact rule nnz over the H100's dense bf16 peak.  Then each level's conv
at (V, C = channels (l + 1)) runs through kernel 2's routed plan and
through the plain gather conv, each with its MFU; a kernel that disagrees
with the plain conv fails the run.  ``--trace DIR`` adds a
``torch.profiler`` trace of one warm forward as the pipeline runs it
(``pipeline/inference.py:forward_harvest`` on the plot as one batch: pinned
H2D, forward, the packed float16 + int32 D2H, the wait on it, host arrays) and prints its summary (utils/trace.py).  ``--device cpu`` runs the plain versions on the host
clock at a small ``--points``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import (H100_BF16_PEAK_FLOPS, bench_points, card_line,
                               conv_row_text, conv_rows, mfu_text,
                               model_inputs, timed_ms)


def spatial_shape_of(pts: np.ndarray, voxel_size: float = 0.1) -> tuple:
    """The JAX profiler's spatial shape: each extent in voxels, one spare
    64-block, rounded up to 64."""
    span = pts.max(axis=0)
    return tuple(int(np.ceil(s / voxel_size / 64) + 1) * 64 for s in span)


def plot_batch(pts: np.ndarray) -> dict:
    """The plot as one loader batch (every point valid and inner, no
    labels): what ``forward_harvest`` reads."""
    n = len(pts)
    zeros = lambda *shape, t=np.float32: np.zeros(shape, t)  # noqa: E731
    return {"coords": pts, "input_feats": zeros(n, 1),
            "batch_ids": zeros(n, t=np.int32), "valid": np.ones(n, bool),
            "masks_inner": np.ones(n, bool), "centers": zeros(n, 3),
            "semantic_labels": zeros(n, t=np.int64),
            "offset_labels": zeros(n, 3),
            "instance_labels": zeros(n, t=np.int64), "batch_size": 1,
            "n_points": n}


def stage_split(model, inputs, dev, dtype, reps: int,
                with_model: bool = True) -> dict:
    """Milliseconds of voxelize alone, voxelize + the level plans (rulebooks
    and downsample rulebooks) and, with ``with_model``, the full forward of
    ``model`` (eval mode) on one batch ``inputs`` (:func:`timed_ms`: CUDA
    events on a card, the host clock on the CPU); their differences put the
    time on each stage.  Also returns the level plans, the active voxels
    per level and the full forward's output (``out``)."""
    from ..model.network import build_level_plans
    from ..ops.sparse import grid_from_sorted_keys
    from ..ops.voxelize import voxelize_points

    def stage_vox():
        vb = voxelize_points(*inputs, batch_size=1,
                             voxel_size=model.voxel_size,
                             max_pts=model.max_pts,
                             spatial_shape=model.spatial_shape,
                             use_coords=model.use_coords,
                             use_feats=model.use_feats)
        return vb, grid_from_sorted_keys(vb.voxel_keys, vb.spatial_shape)

    def stage_plans():
        return build_level_plans(stage_vox()[1], model.num_blocks,
                                 model.kernel_size)

    def full():
        with torch.no_grad():
            return model(*inputs, batch_size=1, compute_dtype=dtype)

    res = {"voxelize_ms": timed_ms(stage_vox, dev, reps)}
    res["plans"] = stage_plans()
    res["voxels_per_level"] = [p.grid.n_active for p in res["plans"]]
    res["plans_ms"] = timed_ms(stage_plans, dev, reps)
    if with_model:
        res["out"] = full()
        res["forward_ms"] = timed_ms(full, dev, reps)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=968000)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true",
                    help="compute in bf16, as the pipeline's fp16: true")
    ap.add_argument("--skip-model", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="also trace one warm forward into DIR")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from ..model import TreeLearn
    from ..model.network import analytic_model_flops
    from ..pipeline.inference import level_counts, split_counts

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    card = card_line(dev)
    print(f"device: {dev}; card: {card}; H100_BF16_PEAK_FLOPS "
          f"{H100_BF16_PEAK_FLOPS:.3e}", flush=True)
    pts = bench_points(args.points)
    pts -= pts.min(axis=0)
    sshape = spatial_shape_of(pts)
    inputs = model_inputs(pts, dev)
    print(f"points={len(pts)} spatial_shape={sshape} compute "
          f"{str(dtype)[6:]}")
    model = TreeLearn(num_blocks=args.levels,
                      spatial_shape=sshape).init(0).to(dev).eval()

    res = {"card": card, "points": len(pts)}
    split = stage_split(model, inputs, dev, dtype, args.reps,
                        with_model=not args.skip_model)
    plans = split.pop("plans")
    out = split.pop("out", None)
    res.update(split)
    print(f"voxelize:           {res['voxelize_ms']:9.2f} ms")
    print(f"active voxels/level: {res['voxels_per_level']}")
    print(f"voxelize+plans:     {res['plans_ms']:9.2f} ms  (plans "
          f"~{res['plans_ms'] - res['voxelize_ms']:.2f} ms)")
    if not args.skip_model:
        n_vox, nnz = split_counts(level_counts(out).cpu().numpy())
        res["flops"] = analytic_model_flops(
            n_vox, len(pts), channels=model.channels,
            num_blocks=args.levels, rule_nnz_per_level=nnz)
        res["mfu"] = (res["flops"] / (res["forward_ms"] * 1e-3)
                      / H100_BF16_PEAK_FLOPS if dev.type == "cuda" else None)
        print(f"full forward:       {res['forward_ms']:9.2f} ms  (unet+heads "
              f"~{res['forward_ms'] - res['plans_ms']:.2f} ms, "
              f"{res['flops'] / 1e9:.1f} GFLOP, "
              f"{mfu_text(res['flops'], res['forward_ms'], dev)})")

    print("\nper-level submanifold conv (kernel 2 routed / plain gather; "
          "MFU of the bf16 peak):", flush=True)
    rng = np.random.default_rng(0)
    res["levels"] = []
    for lvl, plan in enumerate(plans):
        c = model.block_channels[lvl]
        v = plan.grid.n_active
        x = torch.from_numpy(rng.standard_normal((v, c)).astype(
            np.float32)).to(dev, dtype)
        w = torch.from_numpy((rng.standard_normal((27, c, c)) * 0.05).astype(
            np.float32)).to(dev, dtype)
        row = dict(conv_rows(x, w, plan.rule, dev, args.reps), level=lvl, v=v,
                   c=c)
        res["levels"].append(row)
        print(f"  L{lvl}: V={v} C={c} nnz={int(row['flops'] / 2 / c / c)}  "
              f"{conv_row_text(row, dev)}", flush=True)

    if args.trace and not args.skip_model:
        from ..pipeline.inference import forward_harvest
        from ..utils.trace import trace_parts

        batch = plot_batch(pts)
        tm = {}
        harvest = lambda: forward_harvest(model, batch, dev, dtype,  # noqa
                                          timings=tm)
        harvest()
        res["ship_bytes"] = tm["d2h_bytes"]
        print(f"\npacked ship of one forward_harvest: {res['ship_bytes']} B "
              f"(float16 predictions + int32 level counts)")
        print("trace of one warm forward (forward_harvest):")
        res["trace"] = trace_parts(harvest, args.trace, "forward", dev)
    return res


if __name__ == "__main__":
    main()
