"""Per-op device times at the level-0 shapes of the 1M-point plot (port of
tools/profile_kernels.py).

    python -m treelearn_tpu_torch.tools.profile_kernels [--reps R]
        [--points N] [--device cpu]

Each row is the mean of ``--reps`` launches between two CUDA events, after
two warm-up launches: the JAX tool iterated each op inside one ``lax.scan``
to hide its per-dispatch cost; a loop of launches timed by events on the
card's stream is the same measurement.  Rows: ``voxelize_points``; kernel 1
(the band-form rulebook) beside the 27-probe kernel it replaced and the
plain ``searchsorted`` builder; ``build_downsample`` (its ``torch.unique``)
and the whole 7-level plan build; the subm conv at C 32 and 64 over the
level-0 rule (kernel 2 routed, the SIMT kernel, the plain gather conv);
BatchNorm + ReLU on (V, 32) float32 with batch statistics; the devoxelize
gather of every point from (V, 32).  ``--device cpu`` runs the plain
versions on the host clock.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import (bench_points, card_line, conv_row_text,
                               conv_rows, model_inputs, timed_ms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--points", type=int, default=None,
                    help="the plot's first N points (default all)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from ..model.blocks import BatchNorm
    from ..model.network import build_level_plans
    from ..ops.rulebook import subm_rulebook, subm_rulebook_probes
    from ..ops.sparse import (build_downsample, build_subm_rulebook,
                              grid_from_sorted_keys)
    from ..ops.voxelize import devoxelize, voxelize_points
    from .profile_model import spatial_shape_of

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(f"device: {dev}; card: {card_line(dev)}", flush=True)
    pts = bench_points(args.points)
    pts -= pts.min(axis=0)
    sshape = spatial_shape_of(pts)
    inputs = model_inputs(pts, dev)
    vox = lambda: voxelize_points(  # noqa: E731
        *inputs, batch_size=1, voxel_size=0.1, max_pts=3,
        spatial_shape=sshape)
    vb = vox()
    grid0 = grid_from_sorted_keys(vb.voxel_keys, vb.spatial_shape)
    v = grid0.n_active
    print(f"points={len(pts)} spatial_shape={sshape} L0 active voxels: {v}")
    rows = {}

    def bench(name, fn):
        rows[name] = timed_ms(fn, dev, args.reps)
        print(f"  {name:<52} {rows[name]:9.3f} ms", flush=True)

    print("\n-- plan-build components (level 0) --")
    bench(f"voxelize_points ({len(pts)} pts)", vox)
    if cuda:
        bench("rulebook, band form (kernel 1)", lambda: subm_rulebook(grid0))
        bench("rulebook, 27-probe kernel (replaced)",
              lambda: subm_rulebook_probes(grid0))
    bench("rulebook, plain (27 searchsorted probe rows)",
          lambda: build_subm_rulebook(grid0, 3))
    bench("build_downsample (torch.unique)", lambda: build_downsample(grid0))
    print("\n-- full plan build (all 7 levels) --")
    bench("build_level_plans (depth 7)", lambda: build_level_plans(grid0, 7))

    print("\n-- conv path (level-0 rule; kernel 2 routed / SIMT / plain, bf16 "
          "on the card) --")
    rule = subm_rulebook(grid0)
    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if cuda else torch.float32
    convs = {}
    for c in (32, 64):
        x = torch.from_numpy(rng.standard_normal((v, c)).astype(
            np.float32)).to(dev, dtype)
        w = torch.from_numpy((rng.standard_normal((27, c, c)) * 0.05).astype(
            np.float32)).to(dev, dtype)
        convs[c] = conv_rows(x, w, rule, dev, args.reps)
        print(f"  subm conv V={v} C={c}: {conv_row_text(convs[c], dev)}",
              flush=True)

    print("\n-- elementwise / gather costs --")
    x32 = torch.from_numpy(rng.standard_normal((v, 32)).astype(
        np.float32)).to(dev)
    bn = BatchNorm(32).to(dev).train()
    bench("BN+ReLU (V, 32) f32, batch statistics",
          lambda: torch.relu(bn(x32)))
    bench(f"devoxelize gather ({len(pts)} pts from (V, 32))",
          lambda: devoxelize(x32, vb.v2p_map))
    return {"card": card_line(dev), "voxels": v, "rows_ms": rows,
            "convs": convs}


if __name__ == "__main__":
    main()
