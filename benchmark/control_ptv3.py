"""Readings that the limits of ``benchmark/limits/train_ptv3_crops_35m.json``
are set from (the PTv3 training cell's counterpart of ``control.py``).

    python3 -m benchmark.control_ptv3 --seeds <n> ... [--program S]
        [--fault NAME] [--no-control]

For each seed, at the cell's own size, on the card:

- the control: the plain reference computed in float8 (``reference/ptv3.py``
  with ``quant="fp8"``, one step below the configuration's bfloat16) put in
  the program's place and held to the float32 reference by the cell's own
  numbers;
- with ``--program S``: a whole run of the cell (set-up, an S-second window,
  the check) and its numbers: the program's readings;
- with ``--fault NAME`` as well: the same run with that fault of
  ``benchmark/faults.py`` or ``benchmark/faults_ptv3.py`` planted.

One process for all seeds; prints one JSON line per reading.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run
from .cells.train_ptv3 import TrainPTv3Cell

CELL = "train_ptv3_crops_35m"


def control(cfg, work, seed, device, run_dir, config_cls):
    from .reference import ptv3 as ref_ptv3

    cell = TrainPTv3Cell(cfg, work, seed, device, run_dir, config_cls)
    cell.setup()
    cell.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = (cell.weights, cell.spec, cell.first, cell.first_draws, cfg,
            device)
    losses8, g8, after8, out8 = ref_ptv3.train_steps(*args, quant="fp8")
    cell.first_losses, cell.first_grad = losses8, g8
    cell.after_first, cell.first_out = after8, out8
    cell.ref_grads = []
    nums = cell.compare(*ref_ptv3.train_steps(*args,
                                              step_grads=cell.ref_grads))
    for k in ("grad_gap_median", "update_worst_leaves", "key_bias_grad"):
        print(f"info control {k}: {cell.info[k]}", file=sys.stderr)
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, default=None,
                    help="also a whole run of the cell with this window (s)")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        from .faults import FAULTS
        from .faults_ptv3 import FAULTS as PTV3_FAULTS

        dict(FAULTS, **PTV3_FAULTS)[args.fault](setattr)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    import tempfile

    from treelearn_tpu_torch.config import ConfigDict

    man = run.load_manifest()
    wentry, centry = run.cell_entries(man, CELL)
    work = run.read_json(f"{run.HERE}/workloads/{wentry['traffic']}.json")
    cfg = run.read_json(f"{run.ROOT}/{centry['file']}")
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if not args.no_control:
            with tempfile.TemporaryDirectory() as d:
                nums = control(cfg, work, seed, dev, d, ConfigDict)
            print(json.dumps({"reading": "control", "seed": seed,
                              **{k: run.finite(v) for k, v in nums.items()}}),
                  flush=True)
        if args.program is not None:
            out = run.run_cell(CELL, seed, args.program, False, dev, man,
                               log=lambda s: print(s, file=sys.stderr))
            print(json.dumps({"reading": args.fault or "program",
                              "seed": seed,
                              **{k: c["value"] for k, c in
                                 out["checks"].items()},
                              "metrics": {k: v["value"] for k, v in
                                          out["metrics"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
