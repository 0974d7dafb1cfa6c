"""Time the grouping and assignment stages of a pipeline run, sub-step by
sub-step, from its pointwise dump (counterpart of
scripts/profile_cluster.py):

    python -m treelearn_tpu_torch.tools.profile_cluster [pointwise_results.npz] [--forest FILE] [--device cpu]

The default dump is the bench's (``bench_workdir_torch/plot/results/
pointwise_results/pointwise_results.npz`` under the current directory).
Sub-steps, each timed on the host clock after a device sync: the
confidence and offset masks, the deferred verticality of the candidates
(kernel 4 on the card), the eps-graph components (kernel 5 + host
union-find) and the size filter, ``get_instances`` whole, the 5-NN
assignment of the remaining points (with the k-NN route and sizes
``ops/cluster.py:knn_classify`` chose) and, when the original cloud is
found (``--forest``, default the bench's centered plot), the 5-NN
propagation onto it.  The labels assembled from the sub-steps are held to
``get_instances`` + ``assign_remaining_points_nearest_neighbor`` on the
same dump.  Grouping is DBSCAN mode with the script's settings.  Runs on
the card unless given ``--device cpu``; launches (zeroed just before) go
to stderr, one JSON line to stdout.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np
import torch

BENCH_DUMP = osp.join("bench_workdir_torch", "plot", "results",
                      "pointwise_results", "pointwise_results.npz")
BENCH_FOREST = osp.join("bench_workdir_torch", "plot", "forest",
                        "bench_forest_centered.npz")
# scripts/profile_cluster.py:31-34
GROUPING = {"tree_conf_thresh": 0.5, "tau_vert": 0.6, "tau_off": 4.0,
            "tau_group": 0.15, "tau_min": 50, "use_hdbscan": False}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def profile_cluster(pointwise_npz: str, forest: str = None, device=None,
                    grouping=None) -> dict:
    """Sub-step seconds of grouping, assignment and propagation of the dump
    on ``device``; ``labels`` are the sub-steps' labels after assignment,
    ``labels_equal`` whether they equal ``get_instances`` +
    ``assign_remaining_points_nearest_neighbor`` on the same dump."""
    from ..config import ConfigDict
    from ..device import resolve_device
    from ..ops.cc import cc_labels
    from ..ops.cluster import KNN_LOG, relabel_components_np
    from ..ops.features import compute_verticality
    from ..pipeline.instances import (
        assign_remaining_points_nearest_neighbor, get_instances,
        propagate_preds)
    from ..pipeline.run import (NON_TREES_LABEL_IN_GROUPING,
                                NOT_ASSIGNED_LABEL_IN_GROUPING,
                                START_NUM_PREDS)

    dev = resolve_device(device)
    g = ConfigDict.from_dict(dict(grouping or GROUPING))
    non_tree, not_assigned = (NON_TREES_LABEL_IN_GROUPING,
                              NOT_ASSIGNED_LABEL_IN_GROUPING)
    z = np.load(pointwise_npz)
    coords = z["coords"]
    offs = z["offset_predictions"]
    logits = z["semantic_prediction_logits"]
    n = len(coords)
    sec = {}
    t = [time.perf_counter()]

    def clock(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        sec[name] = round(now - t[0], 4)
        t[0] = now

    # the confidence test of pipeline/instances.py:get_instances (the
    # binary head's logit margin) and the offset filter
    thr = float(g.tree_conf_thresh)
    margin = logits[:, 0].astype(np.float64) - logits[:, 1].astype(np.float64)
    tree_mask = margin >= np.log(thr / (1.0 - thr))
    offset_mask = np.abs(offs[:, 2]) < g.tau_off
    pre = np.where(tree_mask & offset_mask)[0]
    clock("masks")
    vertical_mask = np.zeros(n, bool)
    if len(pre):
        vert = compute_verticality(coords[:, :3].astype(np.float32),
                                   search_radius=0.6, query_idx=pre,
                                   device=dev)
        vertical_mask[pre] = vert[:, 0] > g.tau_vert
    clock("deferred_verticality")
    mask_cluster = tree_mask & vertical_mask & offset_mask
    ind_cluster = np.where(mask_cluster)[0]
    xy = np.ascontiguousarray(
        ((coords + offs)[:, :3])[ind_cluster][:, :2], np.float32)
    clock("candidates")
    comp = (cc_labels(torch.from_numpy(xy).to(dev), float(g.tau_group))
            if len(xy) else np.zeros(0, np.int64))
    clock("cc_labels")
    clusters = relabel_components_np(comp, g.tau_min, not_assigned,
                                     START_NUM_PREDS)
    clock("relabel")
    preds = non_tree * np.ones(n)
    preds[tree_mask] = not_assigned
    preds[ind_cluster] = clusters
    preds = preds.astype(np.int64)

    ref = get_instances(coords, offs, logits, g, None, 0, non_tree,
                        not_assigned, START_NUM_PREDS, search_radius=0.6,
                        device=dev)
    clock("get_instances_total")

    del KNN_LOG[:]
    tm = preds != non_tree
    out = preds.copy()
    out[tm] = assign_remaining_points_nearest_neighbor(
        (coords + offs)[tm], preds[tm], not_assigned, device=dev)
    clock("assign_remaining")
    knn = [{"route": c.route, "refs": c.n_refs, "queries": c.n_queries,
            "rounds": len(c.rounds), "brute": c.n_brute} for c in KNN_LOG]
    want = ref.copy()
    rm = ref != non_tree
    want[rm] = assign_remaining_points_nearest_neighbor(
        (coords + offs)[rm], ref[rm], not_assigned, device=dev)
    clock("assign_remaining_again")

    n_orig = None
    if forest and osp.isfile(forest):
        orig = np.load(forest)["points"]
        n_orig = len(orig)
        clock("load_forest")
        propagate_preds(coords, out, orig[:, :3], device=dev)
        clock("propagate")
    res = {
        "n_points": int(n), "n_precandidates": int(len(pre)),
        "n_candidates": int(len(ind_cluster)),
        "n_clusters": int(clusters.max()) if len(clusters) else 0,
        "n_remaining": int((preds == not_assigned).sum()),
        "n_propagated": n_orig, "seconds": sec, "knn": knn,
        "labels_equal": bool(np.array_equal(out, want)),
        "initial_equal": bool(np.array_equal(preds, ref)),
        "labels": out,
    }
    if "instance_preds" in z.files:
        res["dump_equal"] = bool(np.array_equal(out, z["instance_preds"]))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pointwise", nargs="?", default=BENCH_DUMP,
                    help="a pipeline run's pointwise_results.npz")
    ap.add_argument("--forest", default=BENCH_FOREST,
                    help="the original cloud (npz with 'points') for the "
                         "propagation step; skipped when missing")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..ops import _cuda
    from ..utils.profiling import card_line

    dev = resolve_device(args.device)
    _cuda.reset_launches()
    out = profile_cluster(args.pointwise, args.forest, device=dev)
    log(f"profile_cluster: launches {json.dumps(_cuda.LAUNCHES)}")
    log(f"points {out['n_points']}, pre-filter candidates "
        f"{out['n_precandidates']}, cluster candidates {out['n_candidates']}"
        f", clusters {out['n_clusters']}, remaining {out['n_remaining']}")
    for name, s in out["seconds"].items():
        log(f"  {name:<24} {s:8.4f} s")
    for c in out["knn"]:
        log(f"  k-NN route {c['route']}: {c['refs']} refs, "
            f"{c['queries']} queries")
    log(f"labels equal to get_instances + assign_remaining: "
        f"{out['labels_equal']}; to the dump: {out.get('dump_equal')}")
    line = {k: v for k, v in out.items() if k != "labels"}
    line.update(card=card_line(dev), launches=dict(_cuda.LAUNCHES))
    print(json.dumps(line), flush=True)
    if not out["labels_equal"]:
        raise SystemExit("profile_cluster: the sub-steps' labels differ "
                         "from get_instances + assign_remaining")
    return out


if __name__ == "__main__":
    main()
