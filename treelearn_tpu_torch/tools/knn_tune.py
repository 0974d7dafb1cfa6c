"""Time the banded k-NN kernel under each split rule:

    python -m treelearn_tpu_torch.tools.knn_tune [--reps 10]

Needs a CUDA device, and the repository's ``configs/pipeline/pipeline.yaml``
in the current directory's ``configs``.  The problem is the pipeline's own
``assign_remaining`` call on the bench plot (``make_synthetic_forest(
n_trees=48, extent=60, points_per_tree=16000, ground_points=200000,
seed=0)``, full-width model, seed-0 weights, DBSCAN grouping), recorded at
``knn_classify`` and cut to its first 131,072 queries, as chip_smoke.py's
phase 3b cuts it.  The escalation rounds are run as
``ops/knn.py:banded_knn_classify`` runs them (first cell, 4x coarser each
round, the undone queries go on), and each round's pass is timed with CUDA
events under every (``CANDS_PER_PART``, ``MIN_SLICE``) pair beside the pair
``ops/knn.py`` ships and the one-thread-a-query kernel.  Every answer is
checked against the shipped pair's.  This is the measurement behind those
two constants; rerun it when csrc/knn.cu changes.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import tempfile

import numpy as np
import torch

from ..config import ConfigDict, get_config
from ..data.synthetic import make_synthetic_forest
from ..ops import _cuda, knn
from ..pipeline import run_treelearn_pipeline


def cuda_ms(fn, reps):
    for _ in range(2):
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


def pipeline_problem(tmp):
    """(refs, labels, queries, k) of the bench plot's assign_remaining."""
    data, _ = make_synthetic_forest(n_trees=48, extent=60,
                                    points_per_tree=16000,
                                    ground_points=200000, seed=0)
    d = osp.join(tmp, "plot", "forest")
    os.makedirs(d)
    path = osp.join(d, "tune.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    config = get_config(osp.join("configs", "pipeline", "pipeline.yaml"))
    config.forest_path = path
    config.pretrain = None
    config.fp16 = True
    config.grouping.use_hdbscan = False
    config.save_cfg = ConfigDict.from_dict({
        "save_formats": ["las"], "save_treewise": False,
        "save_pointwise": False, "return_type": "original",
        "results_dir": "results"})
    seen = {}

    def keep(name, args):
        if name == "knn_problem":
            seen.update(args)

    _cuda.set_recorder(keep)
    run_treelearn_pipeline(config, device="cuda")
    _cuda.set_recorder(None)
    return (seen["ref_pts"], seen["ref_labels"], seen["query_pts"],
            seen["k"])


def rounds(refs, labels, queries, k, max_rounds=6):
    """The passes of the escalation: [(cell, KnnPass)]."""
    cell = knn._first_cell(refs.cpu().numpy())
    out = []
    for _ in range(max_rounds):
        if queries.shape[0] == 0:
            break
        p = knn.prepare_pass(refs, labels, queries, float(cell), k)
        _, found = knn.knn_pass(p)
        done = torch.empty_like(found, dtype=torch.bool)
        done[p.q_order] = found >= k
        out.append((cell, p))
        if float(done.float().mean()) < 0.25:
            break
        queries = queries[~done]
        cell *= 4.0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("knn_tune: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        ref_pts, ref_labels, query_pts, k = pipeline_problem(tmp)
    enc = np.asarray(ref_labels).astype(np.int64)
    refs = torch.from_numpy(np.asarray(ref_pts, np.float32)).to(dev)
    labels = torch.from_numpy(enc - enc.min() + 1).to(dev)
    queries = torch.from_numpy(
        np.asarray(query_pts, np.float32)[:1 << 17]).to(dev)
    print(f"{refs.shape[0]} refs x {queries.shape[0]} queries (of "
          f"{len(query_pts)}), k {k}")
    shipped = (knn.CANDS_PER_PART, knn.MIN_SLICE)
    passes = rounds(refs, labels, queries, k)
    want = [knn.knn_pass(p) for _, p in passes]
    torch.cuda.synchronize()
    serial = [cuda_ms(lambda p=p: knn.knn_pass_serial(p), args.reps)
              for _, p in passes]
    for i, ((cell, p), ms) in enumerate(zip(passes, serial)):
        cand = (p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum(1)
        print(f"round {i}: {p.queries.shape[0]} queries, cell {cell:.3f} m, "
              f"{p.groups.shape[0] - 1} groups, {int(cand.sum())} candidate "
              f"refs, one-thread-a-query kernel {ms:.4f} ms")
    print(f"one-thread-a-query kernel, all rounds: {sum(serial):.4f} ms")
    for cpp in (64, 128, 256, 512, 1024):
        for min_slice in (8, 16, 32, 64, 128):
            knn.CANDS_PER_PART, knn.MIN_SLICE = cpp, min_slice
            times = []
            for (_, p), (w, f) in zip(passes, want):
                q = p._replace(items=knn.pass_items(p.groups, p.ranges))
                got_w, got_f = knn.knn_pass(q)
                if not (torch.equal(got_w, w) and torch.equal(got_f, f)):
                    raise AssertionError(f"{cpp}, {min_slice}: answers differ")
                times.append((cuda_ms(lambda q=q: knn.knn_pass(q), args.reps),
                              q.items.shape[0]))
            mark = " <- shipped" if (cpp, min_slice) == shipped else ""
            print(f"CANDS_PER_PART {cpp}, MIN_SLICE {min_slice}: "
                  + ", ".join(f"{ms:.4f} ms ({n} blocks)" for ms, n in times)
                  + f"; all rounds {sum(ms for ms, _ in times):.4f} ms{mark}")
    knn.CANDS_PER_PART, knn.MIN_SLICE = shipped


if __name__ == "__main__":
    main()
