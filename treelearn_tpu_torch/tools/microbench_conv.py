"""Micro-benchmark of kernel 2, the submanifold conv, on the card (port of
tools/microbench_conv.py).

    python -m treelearn_tpu_torch.tools.microbench_conv [V] [C]
        [--reps R] [--device cpu]

Kernel 2 through the route its shape takes (``ops/subm_conv.py:subm_conv``)
against the plain gather conv (``ops/sparse.py:subm_conv``), both bf16 with
float32 sums, on a voxel set shaped like one forest tile at 0.1 m (default
V = 2^17 slots at 35 % occupancy, C = 32 -> 32); the relative error of the
kernel's output must stay under 0.05 of the plain output's max, and each
side's rate is ``2 nnz Cin Cout`` over its time (two warm-up calls, then
the mean of ``--reps``; CUDA events on the card, the host clock on the
CPU, where the wrapper runs the plain conv too).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import card_line, timed_ms

SHAPE = (350, 350, 220)


def make_case(v_cap, cin, cout, density=0.35, seed=0, device="cpu"):
    """Sorted voxel grid shaped like one forest tile at 0.1 m voxels: the
    JAX tool's ``make_case`` (same seed, same clustered columns, so the same
    voxel set and the same features and weights).  Returns (grid, rule,
    feats, w, n) with exactly ``n`` live rows: the JAX case's zero rows past
    them stand for its capacity padding, which eager shapes do not need."""
    from ..ops.hashing import encode_keys
    from ..ops.rulebook import subm_rulebook
    from ..ops.sparse import grid_from_sorted_keys

    rng = np.random.default_rng(seed)
    n = int(v_cap * density)
    seen = set()
    # clustered columns (trees) so the key distribution resembles real tiles
    while len(seen) < n:
        cx, cy = rng.integers(20, 330, 2)
        for _ in range(rng.integers(40, 200)):
            x = int(np.clip(cx + rng.normal(0, 4), 0, 349))
            y = int(np.clip(cy + rng.normal(0, 4), 0, 349))
            z = int(rng.integers(0, 220))
            seen.add((0, x, y, z))
            if len(seen) >= n:
                break
    coords = torch.from_numpy(np.array(sorted(seen), np.int32))
    grid = grid_from_sorted_keys(encode_keys(coords, SHAPE).to(device), SHAPE)
    rule = subm_rulebook(grid)
    feats = rng.normal(size=(v_cap, cin)).astype(np.float32)[:n]
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    return (grid, rule,
            torch.from_numpy(feats).to(device, torch.bfloat16),
            torch.from_numpy(w).to(device, torch.bfloat16), n)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("v_cap", nargs="?", type=int, default=1 << 17)
    ap.add_argument("c", nargs="?", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from ..ops.sparse import subm_conv as plain_conv
    from ..ops.subm_conv import conv_plan, cout_pad, subm_conv, tensor_core_pad

    dev = resolve_device(args.device)
    cin = cout = args.c
    print(f"device: {dev}; card: {card_line(dev)}; V={args.v_cap} "
          f"C={cin}->{cout}")
    grid, rule, feats, w, n = make_case(args.v_cap, cin, cout, device=dev)
    route = (conv_plan(cin + tensor_core_pad(cin, cout, n, feats.dtype),
                       cout + cout_pad(cout, feats.dtype), n,
                       feats.dtype).route
             if dev.type == "cuda" else "plain on the CPU")
    print(f"live={n} route={route}")
    t_p = timed_ms(lambda: plain_conv(feats, w, rule), dev, args.reps)
    t_k = timed_ms(lambda: subm_conv(feats, w, rule), dev, args.reps)
    want = plain_conv(feats, w, rule).float()
    got = subm_conv(feats, w, rule).float()
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-6)
    flops = 2.0 * float((rule >= 0).sum()) * cin * cout
    clock = "" if dev.type == "cuda" else " (host clock)"
    print(f"plain   : {t_p:8.3f} ms  {flops / t_p / 1e9:7.2f} TF/s{clock}")
    print(f"kernel 2: {t_k:8.3f} ms  {flops / t_k / 1e9:7.2f} TF/s{clock}  "
          f"speedup {t_p / t_k:.1f}x  rel_err {err:.2e}")
    if not err < 0.05:
        raise AssertionError(f"kernel 2 wrong: rel_err={err}")
    return {"card": card_line(dev), "live": n, "route": route,
            "plain_ms": t_p, "kernel_ms": t_k, "rel_err": err,
            "flops": flops}


if __name__ == "__main__":
    main()
