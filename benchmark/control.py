"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... [--program S]

For each seed, at the cell's own size, on the card:

- the control: the plain reference computed in float8 e4m3 operands (one
  step below the configuration's bfloat16) put in the program's place and
  held to the float32 reference by the cell's own numbers;
- with ``--program S``: a whole run of the cell (set-up, an S-second
  window, the check) and its numbers: the program's readings;
- with ``--fault NAME`` as well: the same run with that fault of
  ``benchmark/faults.py`` planted in the program (``--no-control`` skips
  the control).

One process for all seeds; prints one JSON line per reading.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run
from .cells.segment import SegmentCell, forward_gaps
from .cells.train import TrainCell


def control_segment(cfg, work, seed, device, run_dir, config_cls):
    cell = SegmentCell(cfg, work, seed, device, run_dir, config_cls)
    cell.make_inputs()
    vox, sem, off = cell.ref
    _, sem8, off8 = cell.reference_outputs(quant="fp8")
    dump = {"coords": vox, "semantic_prediction_logits": sem8,
            "offset_predictions": off8}
    return forward_gaps(dump, vox, sem, off)


def control_train(cfg, work, seed, device, run_dir, config_cls):
    from .reference import training as ref_train
    from .reference.unet import param_spec

    cell = TrainCell(cfg, work, seed, device, run_dir, config_cls)
    cell.setup()
    cell.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = param_spec(cfg["model"]["channels"], cfg["model"]["num_blocks"])
    losses8, g8, after8, out8 = ref_train.train_steps(
        cell.weights, spec, cell.first, cfg, device, quant="fp8")
    cell.first_losses, cell.first_grad = losses8, g8
    cell.after_first, cell.first_out = after8, out8
    losses, g1, after, out = ref_train.train_steps(
        cell.weights, spec, cell.first, cfg, device)
    nums = cell.compare(losses, g1, after, out)
    print(f"info control grad_gap_median: {cell.info['grad_gap_median']}",
          file=sys.stderr)
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, default=None,
                    help="also a whole run of the cell with this window (s)")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        from .faults import FAULTS

        FAULTS[args.fault](setattr)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    import tempfile

    from treelearn_tpu_torch.config import ConfigDict

    man = run.load_manifest()
    wentry, centry = run.cell_entries(man, args.workload)
    work = run.read_json(f"{run.HERE}/workloads/{wentry['traffic']}.json")
    cfg = run.read_json(f"{run.ROOT}/{centry['file']}")
    dev = torch.device("cuda", 0)
    fn = {"segment": control_segment, "train": control_train}[work["kind"]]
    for seed in args.seeds:
        if not args.no_control:
            with tempfile.TemporaryDirectory(dir=None) as d:
                nums = fn(cfg, work, seed, dev, d, ConfigDict)
            print(json.dumps({"reading": "control", "seed": seed,
                              **{k: run.finite(v) for k, v in nums.items()}}),
                  flush=True)
        if args.program is not None:
            out = run.run_cell(args.workload, seed, args.program, False, dev,
                               man, log=lambda s: print(s, file=sys.stderr))
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
