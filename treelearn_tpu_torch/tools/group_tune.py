"""Take the two grouping kernels' times apart on the bench plot:

    python -m treelearn_tpu_torch.tools.group_tune [--reps 20]

Needs a CUDA device, and the repository's ``configs/pipeline/pipeline.yaml``
in the current directory's ``configs``.  The problems are the pipeline's own
verticality and found-bits calls on the bench plot (as
``tools/knn_tune.py:run_bench_plot`` runs it), and for found bits also the
trained-like grouping input (``data/synthetic.py:trained_like_xy``).

* Verticality moments (csrc/vert.cu): the work items in the order
  ``ops/vert.py:group_items`` ships (longest walk first) beside group order,
  the warp-steps of the walk (one staged record for a warp's 32 lanes) and
  their rate.
* Found bits (csrc/cc.cu): the whole launch beside one work item alone (the
  wrapper's floor), the launch with ``eps2 = -1`` (neighbor lookup and box
  tests, every walk rejected) and with ``eps2 = 1e9`` (every neighbor cell
  walked, each walk over after its first tile), after a check against the
  plain found bits on the kernel's route.

Each time is the least of three means over ``--reps`` launches.  This is the
measurement behind the item order and behind what PERF.md says is left in
the found-bits kernel; rerun it when either source changes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile

import torch

from ..data.synthetic import trained_like_xy
from ..ops import cc, vert
from .knn_tune import cuda_ms, run_bench_plot


def least_ms(fn, reps):
    return min(cuda_ms(fn, reps) for _ in range(3))


def tune_vert(p, reps):
    items = p.items.long()
    by_group = p._replace(
        items=p.items[torch.argsort(items[:, 0], stable=True)].contiguous())
    want = vert.moments(p)
    if not torch.equal(vert.moments(by_group), want):
        raise AssertionError("vert: the item order changed the moments")
    cand = (p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum(1).long()
    steps = int((-(-cand[items[:, 3]] * items[:, 2] // 32)).sum())
    ms = least_ms(lambda: vert.moments(p), reps)
    print(f"vert Q={p.queries.shape[0]} R={p.refs4.shape[0]}: "
          f"{p.items.shape[0]} items, longest walk first {ms:.4f} ms, group "
          f"order {least_ms(lambda: vert.moments(by_group), reps):.4f} ms; "
          f"{steps} warp-steps, {steps / ms / 1e6:.2f}e9 a second")


def tune_cc(p, what, reps):
    if not torch.equal(cc.found_bits(p), cc.found_bits_plain(p, banded=True)):
        raise AssertionError(f"cc {what}: the kernel differs from the plain "
                             "found bits")
    one = p._replace(items=p.items[:1].contiguous())
    print(f"cc {what} N={p.pts.shape[0]}: {p.items.shape[0]} items, kernel "
          f"{least_ms(lambda: cc.found_bits(p), reps):.4f} ms, one item "
          f"{least_ms(lambda: cc.found_bits(one), reps):.4f} ms, lookup and "
          f"box tests only "
          f"{least_ms(lambda: cc.found_bits(p._replace(eps2=-1.0)), reps):.4f}"
          f" ms, every walk one tile "
          f"{least_ms(lambda: cc.found_bits(p._replace(eps2=1e9)), reps):.4f}"
          f" ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("group_tune: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    seen = {}

    def keep(name, kernel_args):
        if name in ("vert", "cc"):
            seen[name] = kernel_args["problem"]

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        data, positions = run_bench_plot(tmp, keep)
    tune_vert(seen["vert"], args.reps)
    tune_cc(seen["cc"], "plot", args.reps)
    eps = float(seen["cc"].eps2) ** 0.5
    xy = torch.from_numpy(trained_like_xy(data, positions)).to("cuda")
    tune_cc(cc.prepare(xy, eps), "trained-like", args.reps)


if __name__ == "__main__":
    main()
