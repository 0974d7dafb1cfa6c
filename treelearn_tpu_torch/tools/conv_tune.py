"""Time the tensor-core subm-conv kernels under explicit launch plans:

    python -m treelearn_tpu_torch.tools.conv_tune [--reps 20] [--only conv|dw]

Needs a CUDA device.  Forward conv: for each U-Net level of the default model (channels
32 x 7 levels) it builds a random sparse grid with about the bench plot's
voxel count and neighbor density, and launches csrc/subm_conv_wgmma.cu on it
directly (weights packed once, outside the timing) under every tile
(rows x channels per block), producer-warp count and ring depth the library
holds, next to the plan ``ops/subm_conv.py:conv_plan`` picks for that shape.
Each launch is checked against the plain conv (2e-2 of max |out|) before it
is timed with CUDA events.  This is the measurement behind ``conv_plan``'s
rules; rerun it when the kernel changes.

Weight gradient: at the level sizes of the training crops (channels 32 x 7
levels, C -> C and the decoder's 2C -> C) it launches
csrc/subm_conv_dw_wgmma.cu under every ring-slot size (producer warps: a slot
holds 8 rows a warp), ring depth and block target (which sets the row
chunks) that ``ops/subm_conv.py:dw_plan_wgmma`` can express, next to the
plan ``dw_plan`` picks and to the SIMT kernel (csrc/subm_conv_dw.cu), each
checked against the plain dW (1e-3 of max |dW|).  This is the measurement
behind ``dw_plan``'s constants.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops.rulebook import subm_rulebook
from ..ops.sparse import grid_from_sorted_keys
from ..ops.sparse import subm_conv as plain_conv
from ..ops.sparse import subm_conv_dw as plain_dw
from ..ops.subm_conv import (BK, SMEM_LIMIT, conv_plan, dw_plan,
                             dw_plan_wgmma, pack_weight, plan_smem_bytes,
                             subm_conv_dw_simt)

# (grid shape, voxels, channels): the bench plot's level sizes, ~40 % dense
LEVELS = [((128, 128, 64), 420575, 32), ((96, 96, 48), 176561, 64),
          ((64, 64, 32), 42437, 96), ((32, 32, 24), 9961, 128),
          ((20, 20, 16), 2341, 160), ((12, 12, 10), 561, 192),
          ((8, 8, 6), 136, 224)]


# level sizes of a 24 m training crop (chip_smoke.py phase 6) and channels
TRAIN_LEVELS = [(58000, 32), (24000, 64), (5900, 96), (1400, 128),
                (330, 160), (80, 192), (20, 224)]


def cuda_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("conv", "dw"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tune: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.only != "dw":
        tune_conv(dev, args.reps)
    if args.only != "conv":
        tune_dw(dev, args.reps)


def random_rule(rng, dev, ss, n):
    keys = np.sort(rng.choice(int(np.prod(ss)), n, replace=False))
    return subm_rulebook(grid_from_sorted_keys(
        torch.from_numpy(keys.astype(np.int32)).to(dev), ss))


def tune_dw(dev, reps):
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(1)
    for n, c in TRAIN_LEVELS:
        side = max(3, int(np.ceil((n / 0.4) ** (1 / 3))))
        rule = random_rule(rng, dev, (side, side, side), n)
        for cin in (c, 2 * c) if c < 224 else (c,):
            gen = torch.Generator().manual_seed(cin + c)
            x = torch.randn(n, cin, generator=gen).to(dev, torch.bfloat16)
            g = torch.randn(n, c, generator=gen).to(dev, torch.bfloat16)
            want = plain_dw(x, g, rule)
            scale = float(want.abs().max())
            chosen = dw_plan(cin, c, n)
            simt = cuda_ms(lambda: subm_conv_dw_simt(x, g, rule), reps)
            print(f"dW V={n} {cin}x{c}, {int((rule >= 0).sum()) / n:.1f} "
                  f"inputs per voxel; dw_plan: {chosen}; SIMT kernel "
                  f"(through its wrapper) {simt:.4f} ms")
            dw = torch.empty(27, cin, c, dtype=torch.float32, device=dev)
            seen = set()
            for producers in (128, 256):
                for stages in (2, 4, 8):
                    for target in (132, 264, 528, 1056):
                        plan = dw_plan_wgmma(cin, c, n, producers, stages,
                                             target)
                        if plan in seen or plan.smem_bytes > SMEM_LIMIT:
                            continue
                        seen.add(plan)
                        partial = torch.empty(
                            (plan.n_chunks, 27, cin, c), dtype=torch.float32,
                            device=dev)

                        def launch():
                            _cuda.check(lib.tl_subm_conv_dw_wgmma(
                                x.data_ptr(), g.data_ptr(), rule.data_ptr(),
                                partial.data_ptr(), dw.data_ptr(), n, cin, c,
                                27, plan.bn, plan.producers, plan.stages,
                                plan.n_chunks, plan.rows_per_chunk,
                                plan.smem_bytes, stream),
                                "tl_subm_conv_dw_wgmma")

                        dw.fill_(7.0)
                        launch()
                        err = float((dw - want).abs().max()) / scale
                        if err > 1e-3:
                            raise AssertionError(f"{plan}: err {err} of max "
                                                 "|dW|")
                        mark = " <- dw_plan" if plan == chosen else ""
                        print(f"  {producers // 32} producer warps, "
                              f"{plan.stages} stages, {plan.n_chunks} "
                              f"chunk(s) x {plan.rows_per_chunk} rows: "
                              f"{cuda_ms(launch, reps):.4f} ms{mark}")


def tune_conv(dev, reps):
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    for ss, n, c in LEVELS:
        keys = np.sort(rng.choice(int(np.prod(ss)), n, replace=False))
        rule = subm_rulebook(grid_from_sorted_keys(
            torch.from_numpy(keys.astype(np.int32)).to(dev), ss))
        gen = torch.Generator().manual_seed(c)
        x = torch.randn(n, c, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(27, c, c, generator=gen) * 0.1).to(dev,
                                                             torch.bfloat16)
        want = plain_conv(x, w, rule).float()
        scale = float(want.abs().max())
        chosen = conv_plan(c, c, n)
        print(f"V={n} {c}->{c}, {int((rule >= 0).sum()) / n:.1f} inputs per "
              f"voxel; conv_plan: {chosen.bm}x{chosen.bn}, "
              f"{chosen.producers // 32} producer warps, {chosen.stages} "
              f"stages")
        out = torch.empty(n, c, dtype=torch.bfloat16, device=dev)
        for bm, bn in dict.fromkeys([(64, c), (64, 32), (128, 32)]):
            wpack = pack_weight(w, bn)
            for producers in (128, 256) if bm == 64 else (128,):
                for stages in (2, 4, 8):
                    smem = plan_smem_bytes(bm, bn, stages)
                    if (smem > SMEM_LIMIT
                            or bm * (bn + 8) * 2 > stages * (bm + bn) * BK * 2):
                        continue

                    def launch():
                        _cuda.check(lib.tl_subm_conv_wgmma(
                            x.data_ptr(), wpack.data_ptr(), rule.data_ptr(),
                            out.data_ptr(), n, n, c, c, 27, bm, bn,
                            stages, producers, smem, stream),
                            "tl_subm_conv_wgmma")

                    out.fill_(7.0)
                    launch()
                    err = float((out.float() - want).abs().max()) / scale
                    if err > 2e-2:
                        raise AssertionError(
                            f"{bm}x{bn} producers {producers} stages "
                            f"{stages}: err {err} of max |out|")
                    mark = " <- conv_plan" if (
                        bm, bn, producers, stages) == (
                        chosen.bm, chosen.bn, chosen.producers,
                        chosen.stages) else ""
                    print(f"  {bm}x{bn}, {producers // 32} producer warps, "
                          f"{stages} stages: {cuda_ms(launch, reps):.4f} "
                          f"ms, err {err:.1e}{mark}")


if __name__ == "__main__":
    main()
