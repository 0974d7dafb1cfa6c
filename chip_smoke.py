#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (treelearn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full width, the bench plot (~968k points)

Phases (any failure exits nonzero; nothing is swallowed):

1. card:     name and power limit as nvidia-smi reports them;
2. build:    the eight CUDA sources of treelearn_tpu_torch/csrc (one nvcc per
             source, all started together), build seconds and each kernel's
             ptxas registers / shared memory;
3. pipeline: the port's main path, ``run_treelearn_pipeline`` in DBSCAN mode,
             at full model width (channels 32, 7 levels, bf16) with seed-0
             random weights on ``make_synthetic_forest(n_trees=48, extent=60,
             points_per_tree=16000, ground_points=200000, seed=0)``; launch
             counts are zeroed just before and read just after, and every
             kernel of the path must have launched; the wrappers' inputs are
             recorded (first call of each shape) for phase 4; CUDA events
             around each model forward give the card's milliseconds beside
             the inference stage's host seconds;
3b. knn:     the serving path's banded k-NN route on the main path's own
             ``assign_remaining`` problem (its refs, the first
             min(2^17, 2e10 / refs) of its queries, so the route is
             ``banded``) through the public ``knn_classify``, counts zeroed
             just before; the vote against the exact host KD-tree vote
             (mismatches only on float-equal distance ties, at most a 1e-4
             share); rounds, done shares, stragglers and wall time, and per
             round the queries, cell groups, work items and candidates per
             query (median, max).  Then, outside the counted run and with no
             default changed, the banded route on the whole problem (pairs
             threshold lifted for that call only) beside the host KD-tree
             the default route takes: wall seconds of each, votes compared;
4. kernels:  each kernel against its plain PyTorch version on the inputs its
             path gave it (rulebook exact, timed beside the 27-probe kernel
             it replaced; subm conv in float32 with rtol 1e-4 on the SIMT
             route and in bf16 within 2e-2 of the output's max magnitude on
             the route its shape takes, the tensor-core kernel also timed
             beside the SIMT kernel at the same shape (``previous_ms``), its
             repeat launch bit-equal, and its gather traffic printed beside
             the compulsory bytes;
             verticality counts exact, moments within 1e-4 of each column's
             scale, |dvert| <= 1e-3 after the float16 rounding but on a 1e-3
             share of ill-conditioned neighborhoods; found bits exact; every
             recorded k-NN pass: winners and found counts exact, timed
             beside the one-thread-a-query kernel it replaced
             (``previous_ms``), no pass more than 1.1x slower and the total
             lower), timed with CUDA events (means of 10 launches; a
             redesigned kernel and the one it replaced in turns, the least
             of 3 to 5 such means each);
5. check:    the port's pipeline on a small plot, on the card and with the
             plain versions on the CPU, must give the same partition
             (ARI >= 0.999) and tree count;
6. train:    ``train_synthetic_checkpoint`` at full width (configs/_modular/
             model.yaml: channels 32, 7 levels, block_reps 2), bf16, batch 1,
             the JAX package's BENCH_RECIPE crop geometry (24 m crops, 10000-
             16000 points per tree, hard_frac 0.8), 4 crops, 20 steps, counts
             zeroed just before: the rulebook, both subm conv kernels and
             both dW kernels must launch, every loss be finite and the mean of the
             last 5 losses below that of the first 5; step time, steps/s,
             peak memory;
7. grads:    on the first training step's inputs, one per shape: the dW
             kernels against the plain dW (float32, SIMT route: rtol 1e-4 of
             max |dW|; bf16 on the route its shape takes: 1e-3 of max |dW|,
             repeat launch bit-equal), the tensor-core route timed beside
             the SIMT kernel at the same shape (``previous_ms``; no shape
             more than 1.1x slower, the per-step total lower) with its
             TFLOP/s and gathered bytes; the conv's dx (kernel 2 with the
             mirrored weights) in float32 against autograd through the plain
             conv (1e-4 of max |dx|) and in bf16 against the plain conv with
             the mirrored weights (2e-2), timed beside its bound, its plain
             version and the SIMT kernel; the forward convs timed at the
             training shapes;
8. step:     one float32 training step at small width (channels 8, 3
             levels), card against CPU from the same seed weights and batch:
             the loss within rtol 1e-5, each parameter's gradient within
             1e-3 of its max, its update within 1e-2 of the learning rate
             wherever |g| >= 1e-3 of that max (elsewhere AdamW's first step
             lr * g / (|g| + 1e-8) amplifies rounding noise), the running
             statistics within 1e-4; the Linear biases before a BatchNorm,
             whose gradient is zero in exact arithmetic, are left out.

The line before the card line's JSON trailer is ``{"kernels": [...]}``; the
last line is the device record.  Exits nonzero without CUDA, and when run
outside the repository (the port's package is not importable then).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
REPO = osp.dirname(osp.abspath(__file__))
TRAIN_STEPS = 20
CARD = "cuda"
MAIN_PATH_KERNELS = ("rulebook", "subm_conv", "subm_conv_wgmma", "vert", "cc")
SLOWER_LIMIT = 1.1            # a redesigned kernel vs the one it replaced,
                              # per shape or pass


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
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


def race(new_fn, old_fn, rounds=3, reps=10):
    """(new ms, old ms) of a redesigned kernel and the one it replaced: each
    the least of ``rounds`` means over ``reps`` launches, taken in turns
    (new, old, new, old, ...).  Kernels of a few hundredths of a millisecond
    run as fast as the host can launch them, so one mean of ten carries the
    host's hiccups; the least of several does not."""
    new_ms, old_ms = [], []
    for _ in range(rounds):
        new_ms.append(cuda_ms(new_fn, reps))
        old_ms.append(cuda_ms(old_fn, reps))
    return min(new_ms), min(old_ms)


def bound(bytes_moved, flops=0.0, dtype="float32"):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pipeline_config(forest_path, fp16=True, channels=32, num_blocks=7):
    from treelearn_tpu_torch.config import ConfigDict, get_config

    config = get_config(osp.join(REPO, "configs", "pipeline", "pipeline.yaml"))
    config.forest_path = forest_path
    config.pretrain = None
    config.fp16 = fp16
    config.model.channels = channels
    config.model.num_blocks = num_blocks
    config.grouping.use_hdbscan = False
    config.save_cfg = ConfigDict.from_dict({
        "save_formats": ["las"], "save_treewise": True,
        "save_pointwise": False, "return_type": "original",
        "results_dir": "results"})
    return config


def write_plot(root, seed, **kw):
    import numpy as np

    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(seed=seed, **kw)
    d = osp.join(root, "plot", "forest")
    os.makedirs(d, exist_ok=True)
    path = osp.join(d, "smoke.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    return path, data


class Recorder:
    """Keeps the first input of each kernel shape and counts calls per
    shape during the main path."""

    def __init__(self):
        self.inputs = {}
        self.calls = {}

    def __call__(self, name, args):
        if name == "subm_conv":
            key = (name, tuple(args["feats"].shape), tuple(args["weight"].shape),
                   str(args["feats"].dtype))
        elif name == "rulebook":
            key = (name, int(args["grid"].keys.shape[0]))
        elif name == "knn":
            key = (name, int(args["problem"].queries.shape[0]))
        else:
            key = (name,)
        self.calls[key] = self.calls.get(key, 0) + 1
        if key not in self.inputs:
            self.inputs[key] = {k: (v.clone() if hasattr(v, "clone") else v)
                                for k, v in args.items()}


class ForwardTimer:
    """CUDA events and the host clock around every TreeLearn forward, through
    global module hooks: measurement only, nothing in the path changes."""

    def __init__(self):
        import torch
        from torch.nn.modules import module as nn_module

        from treelearn_tpu_torch.model import TreeLearn

        self.events, self.host_s, self._t0 = [], [], 0.0

        def before(mod, args):
            if isinstance(mod, TreeLearn):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self.events.append([start, None])
                self._t0 = time.time()

        def after(mod, args, output):
            if isinstance(mod, TreeLearn):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events[-1][1] = end
                self.host_s.append(time.time() - self._t0)

        self._handles = [nn_module.register_module_forward_pre_hook(before),
                         nn_module.register_module_forward_hook(after)]

    def remove(self):
        for h in self._handles:
            h.remove()

    def device_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def check_rulebook(rec, lib_rows):
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.hashing import encode_keys
    from treelearn_tpu_torch.ops.rulebook import (subm_rulebook,
                                                  subm_rulebook_probes)
    from treelearn_tpu_torch.ops.sparse import build_subm_rulebook, kernel_offsets

    keys = sorted(k for k in rec.inputs if k[0] == "rulebook")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 previous_ms=0.0)
    err = 0
    for key in keys:
        grid = rec.inputs[key]["grid"]
        calls = rec.calls[key]
        got = subm_rulebook(grid)
        want = build_subm_rulebook(grid, 3)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        err = max(err, mism)
        if mism or not torch.equal(subm_rulebook_probes(grid), want):
            raise AssertionError(f"rulebook V={key[1]}: {mism} entries differ")
        offs = kernel_offsets(3, grid.keys.device)
        probes = torch.stack([
            encode_keys(torch.cat([grid.coords[:, :1],
                                   grid.coords[:, 1:] + offs[k]], 1),
                        grid.spatial_shape) for k in range(27)])
        ms = cuda_ms(lambda: subm_rulebook(grid))
        previous = cuda_ms(lambda: subm_rulebook_probes(grid))
        plain = cuda_ms(lambda: build_subm_rulebook(grid, 3), reps=3)
        library = cuda_ms(lambda: torch.searchsorted(grid.keys, probes))
        v = key[1]
        b, _ = bound(4 * v + 27 * 4 * v)
        log(f"  rulebook V={v}: exact, kernel {ms:.4f} ms, 27-probe kernel "
            f"{previous:.4f} ms, plain {plain:.4f} ms, searchsorted "
            f"{library:.4f} ms, bound {b:.4f} ms (bytes), {calls} call(s) on "
            f"the main path")
        for name, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b),
                          ("library_ms", library), ("previous_ms", previous)):
            total[name] += val * calls
    lib_rows.append(dict(
        name="rulebook", route="cuda",
        source="treelearn_tpu_torch/csrc/rulebook.cu",
        replaces="treelearn_tpu/ops/pallas_rd.py:145",
        launches=_cuda.LAUNCHES["rulebook"], max_abs_err=float(err),
        bound_by="bytes", **total))


def conv_bound(feats, weight, rule):
    """(bound ms, by, flops, compulsory bytes, gathered bytes) of one conv
    call: every input read once and the output written once, against
    2 nnz Cin Cout operations; the gather moves nnz rows of Cin values."""
    import torch

    nnz = int((rule >= 0).sum())
    cin, cout = weight.shape[1], weight.shape[2]
    s = feats.element_size()
    flops = 2.0 * nnz * cin * cout
    bytes_moved = (feats.numel() * s + weight.numel() * s + rule.numel() * 4
                   + rule.shape[1] * cout * s)
    dtype = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    b, by = bound(bytes_moved, flops, dtype)
    return b, by, flops, bytes_moved, nnz * cin * s


def check_subm_conv(rec, lib_rows):
    """The recorded conv shapes: float32 on the SIMT route, the working type
    on the route its shape takes; one row per kernel."""
    import torch

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, pack_weight,
                                                   subm_conv, subm_conv_simt)

    keys = sorted((k for k in rec.inputs if k[0] == "subm_conv"),
                  key=lambda k: (k[1][0], k[2]))
    csrc = "treelearn_tpu_torch/csrc/"
    sources = {"subm_conv": csrc + "subm_conv.cu",
               "subm_conv_wgmma": csrc + "subm_conv_wgmma.cu"}
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, by_ops=0,
                      shapes=0) for n in sources}
    totals["subm_conv_wgmma"]["previous_ms"] = 0.0
    for key in keys:
        a = rec.inputs[key]
        feats, weight, rule = a["feats"], a["weight"], a["rule"]
        calls = rec.calls[key]
        cin, cout = weight.shape[1], weight.shape[2]
        # float32: same algorithm, float32 products and sums (SIMT route)
        f32 = subm_conv(feats.float(), weight.float(), rule)
        r32 = plain_conv(feats.float(), weight.float(), rule)
        torch.cuda.synchronize()
        if not torch.allclose(f32, r32, rtol=1e-4, atol=1e-4 * float(
                r32.abs().max().clamp(min=1e-6))):
            raise AssertionError(f"subm_conv f32 {cin}->{cout}: max err "
                                 f"{float((f32 - r32).abs().max())}")
        # working type: bf16 inputs and output, float32 sums in both; the
        # outputs differ by summation order before the final bf16 rounding
        plan = conv_plan(cin, cout, rule.shape[1], feats.dtype)
        name = "subm_conv_wgmma" if plan.route == "wgmma" else "subm_conv"
        tot = totals[name]
        first = subm_conv(feats, weight, rule)
        if not torch.equal(first, subm_conv(feats, weight, rule)):
            raise AssertionError(f"subm_conv {cin}->{cout}: two launches "
                                 "differ")
        got = first.float()
        want = plain_conv(feats, weight, rule).float()
        scale = float(want.abs().max().clamp(min=1e-6))
        abs_err = float((got - want).abs().max())
        rel = abs_err / scale
        if rel > 2e-2:
            raise AssertionError(f"subm_conv {feats.dtype} {cin}->{cout}: "
                                 f"max err {rel} of max |out|")
        tot["err"] = max(tot["err"], abs_err)
        if name == "subm_conv_wgmma":
            ms, previous = race(lambda: subm_conv(feats, weight, rule),
                                lambda: subm_conv_simt(feats, weight, rule))
        else:
            ms = cuda_ms(lambda: subm_conv(feats, weight, rule))
        plain = cuda_ms(lambda: plain_conv(feats, weight, rule), reps=3)
        b, by, flops, compulsory, gathered = conv_bound(feats, weight, rule)
        tot["by_ops"] += by == "operations"
        tot["shapes"] += 1
        line = (f"  {name} {str(feats.dtype)[6:]} V={feats.shape[0]} "
                f"{cin}->{cout} {plan.bm}x{plan.bn}: err {rel:.2e} of "
                f"max|out|, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s), plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
                f"compulsory {compulsory / 1e6:.2f} MB, gathered "
                f"{gathered / 1e6:.2f} MB "
                f"({gathered / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
                f"rate), {calls} call(s)")
        if name == "subm_conv_wgmma":
            for mirror in (False, True):   # the pack kernel, exactly
                if not torch.equal(
                        pack_weight(weight, 32, mirror).cpu(),
                        pack_weight(weight.cpu(), 32, mirror)):
                    raise AssertionError(f"pack_weight {cin}->{cout} "
                                         f"mirror={mirror} differs")
            tot["previous_ms"] += previous * calls
            line += f", SIMT kernel {previous:.4f} ms"
            if ms > SLOWER_LIMIT * previous:
                raise AssertionError(
                    f"subm_conv {cin}->{cout} V={feats.shape[0]}: the wgmma "
                    f"route takes {ms:.4f} ms, the SIMT kernel {previous:.4f}")
        log(line)
        for col, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * calls
    for name, tot in totals.items():
        if not tot["shapes"]:
            raise AssertionError(f"no recorded conv shape took {name}")
        by_ops, shapes = tot.pop("by_ops"), tot.pop("shapes")
        err = tot.pop("err")
        lib_rows.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces="treelearn_tpu/ops/pallas_conv.py:355", launches=0,
            max_abs_err=err,
            bound_by="operations" if by_ops * 2 >= shapes else "bytes",
            library_ms=None, **tot))


def check_vert(rec, lib_rows):
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.vert import moments, moments_plain, vert_from_moments

    p = rec.inputs[("vert",)]["problem"]
    m = moments(p)
    mp = moments_plain(p)
    torch.cuda.synchronize()
    v, c = vert_from_moments(m)
    vp, cp = vert_from_moments(mp)
    if not torch.equal(m[:, 0], mp[:, 0]):
        raise AssertionError("verticality neighbor counts differ: "
                             f"{int((m[:, 0] != mp[:, 0]).sum())} queries")
    # the moments are float32 sums in another order: hold them to 1e-4 of
    # each column's scale; the verticality derived from them must agree
    # within 1e-3 except on a 1e-3 share of ill-conditioned neighborhoods
    scale = mp.abs().amax(0).clamp(min=1e-12)
    mom_err = float(((m - mp).abs() / scale).max())
    if mom_err > 1e-4:
        raise AssertionError(f"verticality moments differ by {mom_err}")
    ok = cp >= 3
    dv = (v[ok] - vp[ok]).abs()
    err = float(dv.max()) if bool(ok.any()) else 0.0
    far = int((dv > 1e-3).sum())
    if far > max(1, int(1e-3 * int(ok.sum()))):
        raise AssertionError(f"verticality: {far} queries differ by > 1e-3")
    ms = cuda_ms(lambda: moments(p))
    plain = cuda_ms(lambda: moments_plain(p), reps=2, warmup=1)
    nq, nr = p.queries.shape[0], p.refs.shape[0]
    pairs = float(m[:, 0].sum())
    b, by = bound(12 * nr + 12 * nq + 8 * nq + 40 * nq
                  + 4 * p.cell_start.numel(), 30.0 * pairs)
    log(f"  vert Q={nq} R={nr}: counts exact, moments within {mom_err:.1e} of "
        f"scale, max |dvert| {err:.2e} ({far} > 1e-3), kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
        f"{pairs:.0f} in-radius pairs")
    lib_rows.append(dict(
        name="vert", route="cuda", source="treelearn_tpu_torch/csrc/vert.cu",
        replaces="treelearn_tpu/ops/pallas_vert.py:137",
        launches=_cuda.LAUNCHES["vert"], max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None))


def check_cc(rec, lib_rows):
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cc import found_bits, found_bits_plain

    p = rec.inputs[("cc",)]["problem"]
    got = found_bits(p)
    want = found_bits_plain(p)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"cc found bits differ for {mism} points")
    ms = cuda_ms(lambda: found_bits(p))
    plain = cuda_ms(lambda: found_bits_plain(p), reps=2, warmup=1)
    n, c = p.pts.shape[0], p.cell_keys.shape[0]
    b, by = bound(8 * n + 8 * n + 4 * n + 8 * c)
    log(f"  cc N={n} cells={c}: found bits exact, kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    lib_rows.append(dict(
        name="cc", route="cuda", source="treelearn_tpu_torch/csrc/cc.cu",
        replaces="treelearn_tpu/ops/pallas_cc.py:116",
        launches=_cuda.LAUNCHES["cc"], max_abs_err=float(mism), ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None))


class GradRecorder(Recorder):
    """Keeps the first input of each backward kernel shape (the first
    training step's) and counts calls per shape over the whole run."""

    def __call__(self, name, args):
        if name not in ("subm_conv_dw", "subm_conv_dx", "subm_conv"):
            return
        if name == "subm_conv":
            key = (name, int(args["weight"].shape[1]),
                   int(args["weight"].shape[2]), str(args["feats"].dtype))
            self.calls[key] = self.calls.get(key, 0) + 1
            if key not in self.inputs:
                self.inputs[key] = {k: v.clone() for k, v in args.items()}
            return
        g = args["g"]
        if name == "subm_conv_dw":
            key = (name, int(args["x"].shape[1]), int(g.shape[1]),
                   str(g.dtype))
        else:     # the forward conv's (Cin, Cout): dx is Cin <- Cout
            key = (name, int(args["weight"].shape[1]),
                   int(args["weight"].shape[2]), str(g.dtype))
        self.calls[key] = self.calls.get(key, 0) + 1
        if key not in self.inputs:
            self.inputs[key] = {k: v.clone() for k, v in args.items()}


def knn_phase(rec):
    """Phase 3b: the banded route on the main path's assign_remaining
    problem through the public knn_classify; returns (launches, passes
    recorder)."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cluster import (KNN_LOG, kdtree_knn,
                                                 knn_classify, vote)

    prob = rec.inputs[("knn_problem",)]
    refs, labels, k = prob["ref_pts"], prob["ref_labels"], prob["k"]
    nr = len(refs)
    if nr <= 1 << 17:
        raise AssertionError(f"the main path's k-NN problem has {nr} refs, "
                             "not more than 2^17: the banded route would "
                             "not be taken")
    queries = prob["query_pts"][:min(1 << 17, int(2e10 // nr))]
    nq = len(queries)
    knn_rec = Recorder()
    _cuda.set_recorder(knn_rec)
    del KNN_LOG[:]
    _cuda.reset_launches()
    t0 = time.time()
    got = knn_classify(refs, labels, queries, k=k, device=CARD)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _cuda.LAUNCHES["knn"]
    _cuda.set_recorder(None)
    (call,) = KNN_LOG
    log(f"knn: {nr} refs x {nq} queries (of {len(prob['query_pts'])}), "
        f"route {call.route}, {wall:.3f} s, {launches} kernel launches, "
        f"{call.n_brute} brute-force stragglers")
    if call.route != "banded" or launches == 0:
        raise AssertionError(f"banded k-NN not taken: {call}, launches "
                             f"{launches}")
    passes = [knn_rec.inputs[key]["problem"] for key in knn_rec.inputs
              if key[0] == "knn"]
    if len(passes) != len(call.rounds):
        raise AssertionError(f"{len(passes)} recorded passes for "
                             f"{len(call.rounds)} rounds")
    for i, ((n, cell, done, sec), p) in enumerate(zip(call.rounds, passes)):
        cand = (p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum(1).float()
        log(f"  round {i}: {n} queries, cell {cell:.4f} m, done {done:.4f}, "
            f"{sec:.3f} s; {p.groups.shape[0] - 1} cell groups, "
            f"{p.items.shape[0]} work items, candidates per query median "
            f"{int(cand.median())}, max {int(cand.max())}")
    want = vote(labels[kdtree_knn(refs, queries, k)])
    bad = np.flatnonzero(got != want)
    ties = 0
    if len(bad):
        from scipy.spatial import cKDTree

        d, _ = cKDTree(refs).query(queries[bad], k=k + 1)
        ties = int((d[:, k] - d[:, k - 1] <= 1e-6 * d[:, k]).sum())
    log(f"  vs exact host KD-tree vote: {len(bad)} mismatches, {ties} on "
        f"float-equal distance ties")
    if ties < len(bad) or len(bad) > 1e-4 * nq:
        raise AssertionError(f"banded k-NN vote: {len(bad)} mismatches "
                             f"({ties} ties) in {nq} queries")
    whole_problem_routes(prob)
    return launches, knn_rec


def whole_problem_routes(prob):
    """The banded route on the main path's whole assign_remaining problem
    (the pairs threshold lifted for this call only, the probe gate and all
    else as they are) beside the host KD-tree the default route takes there.
    Measurement only: the defaults stay, the launches are not counted."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.ops.cluster import kdtree_knn, vote
    from treelearn_tpu_torch.ops.knn import banded_knn_classify

    refs, labels, k = prob["ref_pts"], prob["ref_labels"], prob["k"]
    queries = prob["query_pts"]
    t0 = time.time()
    want = vote(labels[kdtree_knn(refs, queries, k)])
    kd_s = time.time() - t0
    kept = os.environ.get("TL_KNN_KDTREE_MIN_PAIRS")
    os.environ["TL_KNN_KDTREE_MIN_PAIRS"] = "1e30"
    try:
        info = {}
        t0 = time.time()
        got = banded_knn_classify(refs, labels, queries, k=k,
                                  small_refs_kdtree=False, device=CARD,
                                  log=info)
        torch.cuda.synchronize()
        banded_s = time.time() - t0
    finally:
        if kept is None:
            del os.environ["TL_KNN_KDTREE_MIN_PAIRS"]
        else:
            os.environ["TL_KNN_KDTREE_MIN_PAIRS"] = kept
    bad = int((np.asarray(got) != want).sum())
    log(f"  whole problem ({len(refs)} refs x {len(queries)} queries): "
        f"banded route {banded_s:.3f} s ({len(info['rounds'])} rounds, "
        f"{info['n_brute']} stragglers), host KD-tree (the default route "
        f"above 2e10 pairs) {kd_s:.3f} s, {bad} votes differ")
    if bad > 1e-4 * len(queries):
        raise AssertionError(f"banded route on the whole problem: {bad} "
                             "votes differ from the KD-tree's")


def check_knn(knn_rec, lib_rows, launches):
    import torch

    from treelearn_tpu_torch.ops.knn import (knn_pass, knn_pass_plain,
                                             knn_pass_serial)

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, previous_ms=0.0)
    by_ops = 0
    keys = sorted(k for k in knn_rec.inputs if k[0] == "knn")
    for key in keys:
        p = knn_rec.inputs[key]["problem"]
        w, f = knn_pass(p)
        wp, fp = knn_pass_plain(p)
        torch.cuda.synchronize()
        mism = int((w != wp).sum() + (f != fp).sum())
        if mism:
            raise AssertionError(f"knn pass Q={key[1]}: {mism} winners or "
                                 "found counts differ")
        ws, fs = knn_pass_serial(p)
        torch.cuda.synchronize()
        off = int((w != ws).sum() + (f != fs).sum())
        ms, previous = race(lambda: knn_pass(p), lambda: knn_pass_serial(p))
        plain = cuda_ms(lambda: knn_pass_plain(p), reps=2, warmup=1)
        nq, nr = p.queries.shape[0], p.refs.shape[0]
        cand = float((p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum())
        b, by = bound(16 * nr + 12 * nq + 24 * nq + 8 * nq, 10.0 * cand)
        by_ops += by == "operations"
        log(f"  knn pass Q={nq} R={nr}: winners and found counts exact, "
            f"kernel {ms:.4f} ms, one-thread-a-query kernel {previous:.4f} "
            f"ms ({off} of its answers differ), plain {plain:.4f} ms, bound "
            f"{b:.4f} ms ({by}), {cand:.0f} candidate refs, "
            f"{p.items.shape[0]} blocks")
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(f"knn pass Q={nq}: {ms:.4f} ms, the kernel "
                                 f"it replaced {previous:.4f} ms")
        for name, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b),
                          ("previous_ms", previous)):
            total[name] += val
    if not total["ms"] < total["previous_ms"]:
        raise AssertionError(f"knn: {total['ms']:.4f} ms a call, the kernel "
                             f"it replaced {total['previous_ms']:.4f} ms")
    lib_rows.append(dict(
        name="knn", route="cuda", source="treelearn_tpu_torch/csrc/knn.cu",
        replaces="treelearn_tpu/ops/pallas_knn.py:125", launches=launches,
        max_abs_err=0.0,
        bound_by="operations" if by_ops * 2 >= len(keys) else "bytes",
        library_ms=None, **total))


def train_phase(tmp):
    """Phase 6: full-width bf16 self-training; returns (info, launches,
    recorder)."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.config import load_yaml_file
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.train.selftrain import (
        BENCH_RECIPE, train_synthetic_checkpoint)

    model_cfg = dict(load_yaml_file(osp.join(
        REPO, "configs", "_modular", "model.yaml"))["model"])
    rec = GradRecorder()
    _cuda.set_recorder(rec)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.time()
    _, info = train_synthetic_checkpoint(
        model_cfg, cache_dir=osp.join(tmp, "selftrain"), steps=TRAIN_STEPS,
        lr=BENCH_RECIPE["lr"], n_crops=4,
        crop_extent=BENCH_RECIPE["crop_extent"], ppt=BENCH_RECIPE["ppt"],
        hard_frac=BENCH_RECIPE["hard_frac"], batch_size=1, log_every=5,
        logger=lambda m: log("  " + m), return_info=True, device=CARD,
        compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    _cuda.set_recorder(None)
    losses = np.asarray(info["losses"])
    step_s = np.asarray(info["step_seconds"])
    log(f"train: {len(losses)} steps in {wall:.2f} s (crops included), "
        f"median step {np.median(step_s):.4f} s, "
        f"{1.0 / np.median(step_s):.2f} steps/s (median), peak memory "
        f"{torch.cuda.max_memory_allocated()} B")
    log(f"  losses {[round(float(x), 3) for x in losses]}")
    log(f"  launches {json.dumps(launches)}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if not losses[-5:].mean() < losses[:5].mean():
        raise AssertionError(f"loss did not fall: first 5 mean "
                             f"{losses[:5].mean()}, last 5 mean "
                             f"{losses[-5:].mean()}")
    zero = [k for k in ("rulebook", "subm_conv", "subm_conv_wgmma",
                        "subm_conv_dw", "subm_conv_dw_wgmma")
            if launches[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched in training: {zero}")
    return info, launches, rec


def check_grads(rec, lib_rows, launches, n_steps):
    """Phase 7: both dW kernels and the conv's dx against their plain
    versions at every recorded shape, the forward convs at the training
    shapes; times per training step.  ``launches``: the training run's
    counts."""
    import torch

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (dw_plan, mirrored,
                                                   subm_conv, subm_conv_dw,
                                                   subm_conv_dw_simt,
                                                   subm_conv_dx,
                                                   subm_conv_simt)

    csrc = "treelearn_tpu_torch/csrc/"
    sources = {"subm_conv_dw": csrc + "subm_conv_dw.cu",
               "subm_conv_dw_wgmma": csrc + "subm_conv_dw_wgmma.cu"}
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, shapes=0)
              for n in sources}
    totals["subm_conv_dw_wgmma"]["previous_ms"] = 0.0
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dw"):
        a = rec.inputs[key]
        x, g, rule = a["x"], a["g"], a["rule"]
        per_step = rec.calls[key] / n_steps
        cin, cout = x.shape[1], g.shape[1]
        plan = dw_plan(cin, cout, x.shape[0], x.dtype)
        name = ("subm_conv_dw_wgmma" if plan.route == "wgmma"
                else "subm_conv_dw")
        tot = totals[name]
        # float32: the SIMT route at every shape; working type: the route
        # the shape takes
        got = subm_conv_dw(x.float(), g.float(), rule)
        want = plain_dw(x.float(), g.float(), rule)
        got16 = subm_conv_dw(x, g, rule)
        if not torch.equal(got16, subm_conv_dw(x, g, rule)):
            raise AssertionError(f"subm_conv_dw {key}: two launches differ")
        want16 = plain_dw(x, g, rule)
        torch.cuda.synchronize()
        scale = float(want.abs().max().clamp(min=1e-12))
        err32 = float((got - want).abs().max()) / scale
        scale16 = float(want16.abs().max().clamp(min=1e-12))
        abs16 = float((got16 - want16).abs().max())
        if err32 > 1e-4 or abs16 > 1e-3 * scale16:
            raise AssertionError(f"subm_conv_dw {key}: f32 err {err32}, "
                                 f"bf16 err {abs16 / scale16} of max |dW|")
        tot["err"] = max(tot["err"], abs16)
        tot["shapes"] += 1
        if name == "subm_conv_dw_wgmma":
            ms, previous = race(lambda: subm_conv_dw(x, g, rule),
                                lambda: subm_conv_dw_simt(x, g, rule),
                                rounds=5)
        else:
            ms = cuda_ms(lambda: subm_conv_dw(x, g, rule))
        plain = cuda_ms(lambda: plain_dw(x, g, rule), reps=3)
        nnz = int((rule >= 0).sum())
        s = x.element_size()
        flops = 2.0 * nnz * cin * cout
        b, _ = bound(x.numel() * s + g.numel() * s + rule.numel() * 4
                     + 27 * cin * cout * 4, flops, "bfloat16")
        line = (f"  {name} {key[3][6:]} V={x.shape[0]} {cin}x{cout}: f32 "
                f"err {err32:.1e}, bf16 err {abs16 / scale16:.1e} of max "
                f"|dW|, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain:.4f} ms, bound {b:.4f} ms, gathered "
                f"{nnz * cin * s / 1e6:.2f} MB, {per_step:.1f} call(s) per "
                f"step")
        if name == "subm_conv_dw_wgmma":
            tot["previous_ms"] += previous * per_step
            line += (f", {plan.n_chunks} chunk(s) of {plan.rows_per_chunk} "
                     f"rows, SIMT kernel {previous:.4f} ms")
            if ms > SLOWER_LIMIT * previous:
                raise AssertionError(
                    f"subm_conv_dw {cin}x{cout} V={x.shape[0]}: the wgmma "
                    f"route takes {ms:.4f} ms, the SIMT kernel {previous:.4f}")
        log(line)
        for col, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * per_step
    for name, tot in totals.items():
        if not tot.pop("shapes"):
            raise AssertionError(f"no recorded dW shape took {name}")
        lib_rows.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces="treelearn_tpu/ops/pallas_conv.py:438",
            launches=launches[name], max_abs_err=tot.pop("err"),
            bound_by="operations", library_ms=None, **tot))
    new, old = (totals["subm_conv_dw_wgmma"][c] for c in ("ms",
                                                          "previous_ms"))
    log(f"  dW per training step on the tensor-core route: {new:.4f} ms, "
        f"the SIMT kernel at the same shapes {old:.4f} ms")
    if not new < old:
        raise AssertionError("the wgmma dW route is not faster per step")
    fwd = 0.0
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv"):
        a = rec.inputs[key]
        feats, w, rule = a["feats"], a["weight"], a["rule"]
        per_step = rec.calls[key] / n_steps
        ms = cuda_ms(lambda: subm_conv(feats, w, rule))
        b, by, flops, _, _ = conv_bound(feats, w, rule)
        log(f"  forward conv {key[3][6:]} V={feats.shape[0]} {key[1]}->"
            f"{key[2]}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"bound {b:.4f} ms ({by}), {per_step:.1f} call(s) per step")
        fwd += ms * per_step
    log(f"  forward convs per training step: {fwd:.4f} ms")
    dx = dict(dx_ms=0.0, dx_bound_ms=0.0, dx_previous_ms=0.0,
              dx_plain_ms=0.0, dx_launches_per_step=0.0)
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dx"):
        a = rec.inputs[key]
        g, w, rule = a["g"], a["weight"], a["rule"]
        per_step = rec.calls[key] / n_steps
        # float32: dx is the conv with the mirrored weights, held to autograd
        # through the plain conv; working type: the kernel against its plain
        # version, that conv (float32 sums, one bf16 rounding).  Autograd in
        # bf16 would add the 27 offsets' parts in bf16 and is no reference.
        x0 = torch.zeros((rule.shape[1], w.shape[1]), device=g.device,
                         requires_grad=True)
        (want32,) = torch.autograd.grad(
            (plain_conv(x0, w.float(), rule) * g.float()).sum(), x0)
        want = plain_conv(g, mirrored(w), rule).float()
        for got, ref, tol in (
                (subm_conv_dx(g.float(), w.float(), rule), want32, 1e-4),
                (subm_conv_dx(g, w, rule).float(), want, 2e-2)):
            torch.cuda.synchronize()
            err = float((got - ref).abs().max()) / float(
                ref.abs().max().clamp(min=1e-12))
            if err > tol:
                raise AssertionError(f"dx {key}: err {err} of max, limit "
                                     f"{tol}")
        ms, previous = race(
            lambda: subm_conv_dx(g, w, rule),
            lambda: subm_conv_simt(g, w, rule, mirror=True))
        wm = mirrored(w)
        plain = cuda_ms(lambda: plain_conv(g, wm, rule), reps=3)
        b, by, flops, _, gathered = conv_bound(g, wm, rule)
        log(f"  dx {key[3]} V={g.shape[0]} {key[1]}<-{key[2]}: matches "
            f"the plain versions, kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), SIMT kernel {previous:.4f} "
            f"ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), gathered "
            f"{gathered / 1e6:.2f} MB, {per_step:.1f} call(s) per step")
        for col, val in (("dx_ms", ms), ("dx_bound_ms", b),
                         ("dx_previous_ms", previous),
                         ("dx_plain_ms", plain),
                         ("dx_launches_per_step", 1.0)):
            dx[col] += val * per_step
    dx["train_forward_ms"] = fwd
    log(f"  dx per training step: {json.dumps(dx)}")
    next(r for r in lib_rows if r["name"] == "subm_conv_wgmma").update(dx)


def train_step_check(tmp):
    """Phase 8: one float32 step at small width, card against CPU."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.data import TreeDataset, collate_padded
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    d = osp.join(tmp, "step_crop")
    os.makedirs(d)
    data, _ = make_synthetic_forest(n_trees=4, extent=12,
                                    points_per_tree=1500, ground_points=6000,
                                    seed=5)
    data[:, :2] -= data[:, :2].mean(0)
    make_crop_npz(osp.join(d, "c.npz"), data, verticality_proxy(data))
    batch = collate_padded([TreeDataset(d, inner_square_edge_length=10.0,
                                        training=True)[0]])
    cfg = dict(channels=8, num_blocks=3, spatial_shape=[256, 256, 128],
               use_coords=True, use_feats=True)
    lr = 1e-3
    out = {}
    for dev in (CARD, "cpu"):
        model = TreeLearn(**cfg).init(0).to(dev)
        opt, sch = build_optimizer(model.parameters(), {
            "type": "AdamW", "lr": lr, "weight_decay": 1e-3})
        step = make_train_step(model, opt, sch, batch_size=1,
                               compute_dtype=torch.float32,
                               grad_norm_clip=True, device=dev)
        loss, _ = step(batch)
        out[dev] = (float(loss),
                    {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()},
                    {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()})
    init = TreeLearn(**cfg).init(0).state_dict()
    worst_g = worst_u = worst_s = 0.0
    for k, g_cpu in out["cpu"][2].items():
        if k.endswith("_linear.0.bias"):
            continue      # zero in exact arithmetic: both sides hold noise
        scale = max(float(g_cpu.abs().max()), 1e-12)
        err_g = float((out[CARD][2][k] - g_cpu).abs().max()) / scale
        # AdamW's first step is lr * g / (|g| + 1e-8): only where |g| is
        # well above the rounding noise does it not amplify that noise
        strong = g_cpu.abs() >= max(1e-3 * scale, 1e-6)
        du = (out[CARD][1][k] - init[k]) - (out["cpu"][1][k] - init[k])
        err_u = float(du[strong].abs().max()) if bool(strong.any()) else 0.0
        if err_g > 1e-3 or err_u > 1e-2 * lr:
            raise AssertionError(f"train step card vs CPU: {k}: gradient "
                                 f"err {err_g} of max, update err {err_u}")
        worst_g, worst_u = max(worst_g, err_g), max(worst_u, err_u)
    for k, v in out["cpu"][1].items():
        if k.endswith(("running_mean", "running_var")):
            err_s = float((out[CARD][1][k] - v).abs().max())
            if err_s > 1e-4:
                raise AssertionError(f"train step card vs CPU: {k} differs "
                                     f"by {err_s}")
            worst_s = max(worst_s, err_s)
    rel = abs(out[CARD][0] - out["cpu"][0]) / abs(out["cpu"][0])
    log(f"train step card vs CPU: loss {out[CARD][0]:.6f} vs "
        f"{out['cpu'][0]:.6f} (rel {rel:.1e}); gradients within "
        f"{worst_g:.1e} of each tensor's max; updates where |g| >= 1e-3 of "
        f"max within {worst_u:.2e} (lr {lr}); running stats within "
        f"{worst_s:.1e}; {int(batch['n_points'])} points")
    if rel > 1e-5:
        raise AssertionError("train step losses differ")


def adjusted_rand(a, b):
    """Adjusted Rand index of two labelings (numpy only)."""
    import numpy as np

    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    comb = lambda x: (x * (x - 1) / 2.0).sum()  # noqa: E731
    s_ij = comb(table.astype(np.float64))
    s_a = comb(table.sum(1).astype(np.float64))
    s_b = comb(table.sum(0).astype(np.float64))
    expected = s_a * s_b / comb(np.float64(len(a)))
    top = 0.5 * (s_a + s_b)
    return 1.0 if top == expected else (s_ij - expected) / (top - expected)


def small_plot_check(tmp):
    """The port's pipeline on a small plot: card vs the plain versions on
    the CPU, float32 both, same seed weights."""
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    out = {}
    for dev in ("cuda", "cpu"):
        root = osp.join(tmp, f"small_{dev}")
        path, data = write_plot(root, 3, n_trees=6, extent=20,
                                points_per_tree=800, ground_points=4000)
        config = pipeline_config(path, fp16=False, channels=8, num_blocks=3)
        res = run_treelearn_pipeline(config, device=dev)
        labels = load_data(res["output_path"])[:, 3]
        if len(labels) != len(data):
            raise AssertionError(f"{dev}: {len(labels)} output rows for "
                                 f"{len(data)} input points")
        out[dev] = (labels, res["n_trees"])
    ari = adjusted_rand(out["cuda"][0], out["cpu"][0])
    log(f"small plot: n_trees cuda {out['cuda'][1]} cpu {out['cpu'][1]}, "
        f"ARI {ari:.6f}")
    if ari < 0.999 or out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("card and CPU pipelines disagree")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-trees", type=int, default=48)
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--points-per-tree", type=int, default=16000)
    ap.add_argument("--ground-points", type=int, default=200000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import treelearn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 3
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cluster import KNN_LOG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    # 2. build
    info = _cuda.build_info()
    log(f"build: {info['build_s']:.1f} s (cached: {info['cached']})")
    for src, text in info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        # 3. main path
        path, data = write_plot(
            tmp, args.seed, n_trees=args.n_trees, extent=args.extent,
            points_per_tree=args.points_per_tree,
            ground_points=args.ground_points)
        log(f"plot: {len(data)} points, {args.n_trees} trees, "
            f"{args.extent} m")
        config = pipeline_config(path)
        from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

        rec = Recorder()
        _cuda.set_recorder(rec)
        forwards = ForwardTimer()
        torch.cuda.reset_peak_memory_stats()
        del KNN_LOG[:]
        _cuda.reset_launches()
        t0 = time.time()
        res = run_treelearn_pipeline(config, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        _cuda.set_recorder(None)
        forwards.remove()
        log(f"pipeline: {wall:.2f} s, n_points {res['n_points']}, "
            f"n_trees {res['n_trees']}")
        log(f"  stage seconds {json.dumps(res['stage_seconds'])}")
        log(f"  model forward: {len(forwards.host_s)} call(s), "
            f"{sum(forwards.device_ms()):.1f} ms between CUDA events on the "
            f"card's stream, {sum(forwards.host_s):.3f} s on the host, "
            f"inside an inference stage of "
            f"{res['stage_seconds'].get('inference', float('nan')):.3f} s")
        mt = res["model_timings"]
        log(f"  voxels per level {[int(x) for x in mt['n_vox_levels']]}, "
            f"rule nnz per level {[int(x) for x in mt['rule_nnz']]}")
        for call in KNN_LOG:
            log(f"  knn route {call.route}: {call.n_refs} refs, "
                f"{call.n_queries} queries")
        log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        log(f"  launches {json.dumps(launches)}")
        zero = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched on the main path: {zero}")
        from treelearn_tpu_torch.io.pointcloud import load_data

        out = load_data(res["output_path"])
        if out.shape != (len(data), 4) or not torch.isfinite(
                torch.from_numpy(out)).all():
            raise AssertionError(f"full-cloud output shape {out.shape}")

        # 3b. the banded k-NN route on the main path's own problem
        knn_launches, knn_rec = knn_phase(rec)

        # 4. kernels against their plain versions, main-path inputs
        rows = []
        check_rulebook(rec, rows)
        check_subm_conv(rec, rows)
        check_vert(rec, rows)
        check_cc(rec, rows)
        for r in rows:
            r["launches"] = launches[r["name"]]
        check_knn(knn_rec, rows, knn_launches)
        del rec, knn_rec

        # 5. end-to-end agreement on a small plot
        small_plot_check(tmp)

        # 6. training at full width; 7. its backward kernels
        info, train_launches, grad_rec = train_phase(tmp)
        check_grads(grad_rec, rows, train_launches, len(info["losses"]))
        del grad_rec

        # 8. one training step, card against CPU
        train_step_check(tmp)

    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
