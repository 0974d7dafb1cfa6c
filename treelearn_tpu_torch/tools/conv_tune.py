"""Time the tensor-core subm-conv kernel under explicit launch plans:

    python -m treelearn_tpu_torch.tools.conv_tune [--reps 20]

Needs a CUDA device.  For each U-Net level of the default model (channels
32 x 7 levels) it builds a random sparse grid with about the bench plot's
voxel count and neighbor density, and launches csrc/subm_conv_wgmma.cu on it
directly (weights packed once, outside the timing) under every tile
(rows x channels per block), producer-warp count and ring depth the library
holds, next to the plan ``ops/subm_conv.py:conv_plan`` picks for that shape.
Each launch is checked against the plain conv (2e-2 of max |out|) before it
is timed with CUDA events.  This is the measurement behind ``conv_plan``'s
rules; rerun it when the kernel changes.
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
from ..ops.subm_conv import (BK, SMEM_LIMIT, conv_plan, pack_weight,
                             plan_smem_bytes)

# (grid shape, voxels, channels): the bench plot's level sizes, ~40 % dense
LEVELS = [((128, 128, 64), 420575, 32), ((96, 96, 48), 176561, 64),
          ((64, 64, 32), 42437, 96), ((32, 32, 24), 9961, 128),
          ((20, 20, 16), 2341, 160), ((12, 12, 10), 561, 192),
          ((8, 8, 6), 136, 224)]


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tune: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
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
                            out.data_ptr(), n, n, c, c, bm, bn, stages,
                            producers, smem, stream), "tl_subm_conv_wgmma")

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
                          f"{stages} stages: {cuda_ms(launch, args.reps):.4f} "
                          f"ms, err {err:.1e}{mark}")


if __name__ == "__main__":
    main()
