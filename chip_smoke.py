#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (treelearn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full width, the bench plot (~968k points)

Phases (any failure exits nonzero; nothing is swallowed):

1. card:     name and power limit as nvidia-smi reports them;
2. build:    the ten CUDA sources of treelearn_tpu_torch/csrc (one nvcc per
             source, all started together), build seconds and each kernel's
             ptxas registers / shared memory;
3. pipeline: the port's main path, ``run_treelearn_pipeline`` in DBSCAN mode,
             at full model width (channels 32, 7 levels, bf16) with seed-0
             random weights on ``make_synthetic_forest(n_trees=48, extent=60,
             points_per_tree=16000, ground_points=200000, seed=0)``; launch
             counts are zeroed just before and read just after, and every
             kernel of the path must have launched (the rulebook, the
             tensor-core conv, verticality, found bits; the 3xTF32 kernels'
             path is the float32 one of phases 5, 5b, 8 and 8b; no shipped
             path reaches the SIMT kernels, which stay as the yardstick
             every tensor-core route is raced against); the wrappers'
             inputs are recorded (first call of each shape) for phase 4;
             CUDA events around each model forward give the card's
             milliseconds beside the inference stage's host seconds; its
             pointwise dump is kept for phase 14.  This first (cold) run is
             followed by a warm one in the same process, with no recorder:
             wall time, stage seconds and the forward's card milliseconds
             and host seconds are printed cold and warm side by side;
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
3c. hdbscan: the same plot, warm, in the repository's default grouping mode
             (``use_hdbscan: true``) with the pointwise dump; counts zeroed
             just before: the rulebook, tensor-core conv and verticality
             kernels must launch; wall time, stage seconds, tree count, the
             HDBSCAN candidates and the route ``hdbscan_cluster`` took (above
             ``TL_HDBSCAN_DEVICE_MAX`` the host ``hdbscan_cluster_large``,
             and then kernel 5 does not launch, which is printed);
3d. ladder:  the eps-ladder on the card, device limit lifted, on (a) those
             candidates and (b) the 220,000-point knot layout of
             ``utils/smoke.py:knot_layout``: min_cluster_size 50, 32 levels,
             counts zeroed just before; seconds of the core distances, the
             ladder and condense/extract, kernel 5's launches (one per level
             with active points), active points and representatives per
             level; the ladder's (L, N) rows again with ``ops/cc.py``'s
             ``found_bits`` swapped for the plain version of the kernel's
             route, on the same card tensors: the rows must be equal.  For
             (a) the host route's seconds and its ARI against the ladder;
             for (b) the knots recovered;
3e. eval:    detection F1 and the partition summary of 3c's pointwise dump,
             and ``tools/evaluate.py`` on 3c's full-cloud output against the
             plot's labels, on the card and on the CPU: the propagated labels
             may differ only on float-equal k-NN distance ties (at most a
             1e-4 share), else the summaries must be equal.  Random weights:
             the scores are smoke values, not quality;
3f. smoke:   ``utils/smoke.py:run_gpu_smoke``: every check must pass;
4. kernels:  each kernel against its plain PyTorch version on the inputs its
             path gave it (rulebook exact, timed beside the 27-probe kernel
             it replaced; subm conv in float32 with rtol 1e-4 on the route
             float32 takes (3xTF32) and in bf16 within 2e-2 of the output's
             max magnitude on the tensor-core route, also timed beside the
             SIMT kernel at the same shape (``previous_ms``; the SIMT output
             held to the same gate), its repeat launch bit-equal, and its
             gather traffic printed beside the compulsory bytes; the 4 -> 32
             input conv in bf16 zero-padded onto the tensor cores beside the
             SIMT kernel over the first 1024 .. all rows of its shape, the
             pad's time counted;
             verticality counts exact, moments within 1e-4 of each column's
             scale, |dvert| <= 1e-3 after the float16 rounding but on a 1e-3
             share of ill-conditioned neighborhoods, repeat launch bit-equal,
             timed beside the one-thread-a-query kernel on the xy table of
             the same points, candidates per query under both tables, the
             whole ``verticality()`` call's wall seconds; found bits exact on
             the plot's problem and on a trained-like grouping input
             (``data/synthetic.py:trained_like_xy``: every tree point's xy on
             its tree's position plus sigma 0.05 m noise, numpy seed 0, the
             dense clumps a trained offset head makes), each timed
             beside the one-thread-a-point kernel, with cells, points per
             cell, neighbor-cell candidates before and after the box test
             and the whole ``cc_labels()`` call's wall seconds: two ``cc``
             rows, ``problem`` plot and trained-like; every
             recorded k-NN pass: winners and found counts exact, timed
             beside the one-thread-a-query kernel it replaced
             (``previous_ms``), no pass more than 1.1x slower and the total
             lower), timed with CUDA events (means of 10 launches; a
             redesigned kernel and the one it replaced in turns, the least
             of 3 to 5 such means each);
5. check:    the port's pipeline on a small plot in float32, on the card and
             with the plain versions on the CPU, must give the same
             partition (ARI >= 0.999) and tree count; the card run's counts,
             zeroed just before it, must show the 3xTF32 conv;
5b. k=5:     the same small plot with a ``kernel_size: 5`` model (2 levels,
             channels 32, float32, seed-0 weights), card against CPU as in
             phase 5; the card run's counts, zeroed just before it, must
             show the 3xTF32 conv (K = 125 offsets) and no rulebook, SIMT or
             bf16 tensor-core launch; each recorded conv shape: the 3xTF32
             and the SIMT kernel held to the plain conv (rtol 1e-4), timed
             in turns; then one float32 training step of that model on
             phase 8's crop, counts zeroed just before it: the 3xTF32 dW
             must launch, each of its shapes held likewise (1e-4 of max
             |dW|); then the same plot and step in bf16 on the card, counts
             zeroed just before each: the bf16 tensor-core conv and dW must
             launch at K = 125 and no SIMT, rulebook or 3xTF32 kernel; each
             conv, dx and dW shape held to the plain version (2e-2 of max
             |out|, 1e-3 of max |dW|), its repeat launch bit-equal, raced
             against the SIMT kernel (none more than 1.1x slower, the
             totals lower); the totals printed beside the 3xTF32 ones; the
             ``kernel_size 5`` rows of the ``kernels`` line (``problem``),
             timed per run and per step;
5c. narrow:  bf16 widths that are no multiple of 32: phase 3's plot with a
             ``channels: 16`` model (levels 16..112, seed-0 weights), counts
             zeroed just before: the rulebook and the bf16 tensor-core conv
             must launch and no SIMT conv; the same plot with the SIMT route
             forced in-process (every conv, and the widths it took before):
             the same tree count and ARI >= 0.999, or at least the ARI of
             the shipped channels 32 model between its tensor-core and SIMT
             routes where bf16 summation order moves that one further; each
             conv shape held and raced as in 5b, its outputs off the
             once-rounded exact sum counted for both routes, at Cin = 16
             (mod 32) also the design that zero-pads to full 32-channel
             slices in the call; then 3 bf16 training steps of that model on
             phase 6's crops: dx and dW on the tensor cores, no SIMT launch,
             each shape held and raced as in phase 7; the ``channels 16``
             rows of the ``kernels`` line;
6. train:    ``train_synthetic_checkpoint`` at full width (configs/_modular/
             model.yaml: channels 32, 7 levels, block_reps 2), bf16, batch 1,
             the JAX package's BENCH_RECIPE crop geometry (24 m crops, 10000-
             16000 points per tree, hard_frac 0.8), 4 crops, 20 steps, counts
             zeroed just before: the rulebook and the tensor-core conv and
             dW kernels must launch, every loss be finite and the mean of
             the last 5 losses below that of the first 5; the first step's
             seconds apart from the median of the others, steps/s, peak
             memory;
7. grads:    on the first training step's inputs, one per shape: the dW
             kernels against the plain dW (float32, 3xTF32 route: rtol 1e-4
             of max |dW|; bf16 on the tensor-core route: 1e-3 of max |dW|,
             repeat launch bit-equal), the tensor-core route timed beside
             the SIMT kernel at the same shape (``previous_ms``, the SIMT
             output held to the same gate; no shape more than 1.1x slower,
             the per-step total lower) with its TFLOP/s and gathered bytes;
             the input conv's dW padded beside SIMT over the first 1024 ..
             all rows; the conv's dx (kernel 2 with the
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
             whose gradient is zero in exact arithmetic, are left out; the
             card step's counts, zeroed just before it, must show both
             3xTF32 kernels;
8b. float32: the float32 route at full width (channels 32, 7 levels,
             ``fp16: False``): phase 3's plot, counts zeroed just before:
             the rulebook, the 3xTF32 conv, verticality and found bits must
             launch and no other conv; at each recorded conv shape the
             3xTF32 kernel and the SIMT kernel it replaced held to the plain
             conv (rtol 1e-4), the tf32 pack to the torch pack exactly,
             timed in turns (``previous_ms``: no shape more than 1.1x
             slower, the total lower): the ``subm_conv_tf32`` row, per run
             and per shape; the plot again warm, then with the SIMT route
             forced in-process: the same partition (ARI >= 0.999) and tree
             count, wall time and the forward's CUDA-event ms of each beside
             the bf16 plot's; then phase 6's training in float32 (20 steps,
             counts zeroed just before): the rulebook and both 3xTF32
             kernels must launch, every loss be finite and the last 5 below
             the first 5, the median step beside the bf16 one; each dW shape
             held as phase 5b holds them (the ``subm_conv_dw_tf32`` row, per
             step) and each dx shape, the 3xTF32 and the SIMT kernel, to
             autograd through the plain conv (1e-4 of max |dx|; the row's
             ``dx_*`` fields);
9. datagen:  phase 3's plot written as ``train/forests/plot.npz`` and
             ``val/forest/plot.npz`` through ``tools/gen_val_data`` and
             ``tools/gen_train_data`` on the card with the shipped configs,
             ``n_samples_total`` cut from 25,000 to 32; counts zeroed just
             before: kernel 4 must launch (once per tool, over every voxel
             of the plot); seconds per stage, tiles and crops written, the
             whole-plot call's queries; that call's kernel timed with CUDA
             events and held to its plain version on the same card tensors
             as phase 4 holds the ``vert`` row: the ``whole_plot`` row of
             the ``kernels`` line;
10. dp:      (a) ``tools/train.py --dist`` as 2 gloo ranks sharing the card
             (``parallel/launch.py:spawn_ranks``, a file store), full width
             (configs/training/train.yaml), phase 9's crops and tiles, one
             epoch, ``examples_per_epoch`` cut to 16 (4 steps a rank),
             validation on: the rulebook and the tensor-core conv and dW
             kernels must launch in each rank, every loss be finite and
             equal across ranks, the parameters bit-equal across ranks,
             ``epoch_1.pth`` written by rank 0 alone; step seconds per rank;
             (b) one float32 DP step at world size 1 on nccl against
             ``make_train_step`` on the same card, seed weights and batch,
             held as phase 8 holds card to CPU; (c) the pipeline with
             ``dist: true, whole_plot: false`` as 2 gloo ranks on the card
             against the same config single-process on the card, on the
             whole plot (one tile-mode run of it takes under 30 s):
             pointwise arrays within 1e-6,
             instance labels and tree count equal, wall time of each;
11. demo:    ``python -m treelearn_tpu_torch.tools.demo`` with its defaults
             on the card: exit 0, at least one tree, the labeled cloud and
             the per-tree files written;
12. profile: ``tools/profile_model.py --bf16 --trace`` on the plot at full
             width (channels 32, 7 levels), warm: voxelize / plans / full
             forward in ms (CUDA events), voxels per level, forward MFU
             (``analytic_model_flops`` with the exact rule nnz over the bf16
             peak), each level's conv through kernel 2's routed plan, the
             SIMT kernel and the plain gather conv (a kernel that disagrees
             with the plain conv beyond phase 4's tolerance fails the
             phase); then ``tools/profile_step.py --train --bf16 --trace``
             (6 steps on ``BENCH_RECIPE`` crops, the first apart); for one
             warm forward and one warm step the ``torch.profiler`` summary
             (device ms by kernel family and by launching op, host ms per
             named part, host waits on the card per part, device-idle share
             of the window) and the span split without the profiler; counts
             zeroed just before: the rulebook, both convs and the tensor-core
             dW must launch; one ``profile:`` JSON line (the traces go to
             ``--trace-dir``, default the run's temporary directory);
13. bench:   ``python -m treelearn_tpu_torch.tools.bench`` as a subprocess
             on the card at a reduced budget (``BENCH_TRAIN_STEPS=200
             BENCH_TRAIN_CROPS=8 BENCH_STEADY_PASSES=1 TL_GPU_SMOKE=0
             BENCH_BUDGET_S=300``; phase 3f runs the smoke), its own HOME and
             work directory under the run's temporary directory: exit 0, a
             last line that parses, ``device`` the card's name,
             ``detection_f1``, ``hard_detection_f1``,
             ``hdbscan_detection_f1`` and ``model_mfu`` (in (0, 1]) present,
             no ``exception_*``, ``watchdog_*`` or ``interrupted_*`` in
             ``degraded``, and its stderr showing the rulebook, the
             tensor-core conv and verticality launched in its cold pass; the
             bench's line is printed as ``bench:``;
14. quality: the quality and toolchain tools on the card: (a)
             ``tools/oracle_ceiling.py:run_oracle`` on the script's default
             hard forest (24 trees, 42 m, seed 7777), counts zeroed just
             before: verticality and found bits must launch, and its labels
             equal the CPU port's on the same input as a partition (ARI >=
             0.999, same tree count), F1 and seconds per stage of both;
             (b) ``python -m treelearn_tpu_torch.tools.hard_quality`` as a
             subprocess at a tiny recipe (``QUALITY_RECIPE``: 60 steps, 4
             crops, a 16 m eval forest; its own HOME): exit 0, a last line
             that parses, every ``quality_chain`` key finite; (c)
             ``tools/profile_cluster.py`` on phase 3's dump: the sub-steps'
             labels equal ``get_instances`` + assignment and the dump's own
             labels, seconds per sub-step and the k-NN route; (d)
             ``python -m treelearn_tpu_torch.tools.five_stage`` as a
             subprocess on the card (the script's plots, ``--samples 24``):
             every stage PASS (the notebook runs where ``matplotlib``
             imports, else its line says so).

The line before the card line's JSON trailer is ``{"kernels": [...]}``; the
last line is the device record.  Exits nonzero without CUDA, and when run
outside the repository (the port's package is not importable then).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
# dense peaks; "tf32" is the tensor cores' TF32 rate, which the 3xTF32
# kernels spend three products of per float32 multiply
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
REPO = osp.dirname(osp.abspath(__file__))
TRAIN_STEPS = 20
CARD = "cuda"
MAIN_PATH_KERNELS = ("rulebook", "subm_conv_wgmma", "vert", "cc")
SLOWER_LIMIT = 1.1            # a redesigned kernel vs the one it replaced,
                              # per shape or pass
DATAGEN_CROPS = 32            # gen_train_data's n_samples_total (shipped 25,000)
DP_WORLD = 2                  # data-parallel ranks, sharing the one card
DP_EXAMPLES = 16              # examples_per_epoch of phase 10a: 4 steps a rank
# phase 14b's recipe: hard_quality's flags
QUALITY_RECIPE = ["--steps", "60", "--crops", "4", "--trees", "4",
                  "--extent", "16"]


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


def pipeline_config(forest_path, fp16=True, channels=32, num_blocks=7,
                    use_hdbscan=False, save_pointwise=False):
    from treelearn_tpu_torch.config import ConfigDict, get_config

    config = get_config(osp.join(REPO, "configs", "pipeline", "pipeline.yaml"))
    config.forest_path = forest_path
    config.pretrain = None
    config.fp16 = fp16
    config.model.channels = channels
    config.model.num_blocks = num_blocks
    config.grouping.use_hdbscan = use_hdbscan
    config.save_cfg = ConfigDict.from_dict({
        "save_formats": ["las"], "save_treewise": True,
        "save_pointwise": save_pointwise, "save_backbone_feats": False,
        "return_type": "original", "results_dir": "results"})
    return config


def run_plot(path, **cfg):
    """One run of the port's main path on the plot at ``path`` on the card,
    counts zeroed just before and read just after; returns (result, wall
    seconds, launches, forward timer)."""
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cluster import KNN_LOG
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline
    from treelearn_tpu_torch.utils.profiling import ForwardTimer

    config = pipeline_config(path, **cfg)
    forwards = ForwardTimer()
    torch.cuda.reset_peak_memory_stats()
    del KNN_LOG[:]
    _cuda.reset_launches()
    t0 = time.time()
    res = run_treelearn_pipeline(config, device=CARD)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    forwards.remove()
    return res, wall, launches, forwards


def write_plot(root, seed, **kw):
    import numpy as np

    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, positions = make_synthetic_forest(seed=seed, **kw)
    d = osp.join(root, "plot", "forest")
    os.makedirs(d, exist_ok=True)
    path = osp.join(d, "smoke.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    return path, data, positions


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


def conv_bound(feats, weight, rule, tf32x3=False):
    """(bound ms, by, flops, compulsory bytes, gathered bytes) of one conv
    call: every input read once and the output written once, against
    2 nnz Cin Cout operations (with ``tf32x3`` three TF32 products each, at
    the TF32 peak); the gather moves nnz rows of Cin values."""
    import torch

    nnz = int((rule >= 0).sum())
    cin, cout = weight.shape[1], weight.shape[2]
    s = feats.element_size()
    flops = 2.0 * nnz * cin * cout
    bytes_moved = (feats.numel() * s + weight.numel() * s + rule.numel() * 4
                   + rule.shape[1] * cout * s)
    dtype = "bfloat16" if feats.dtype == torch.bfloat16 else "float32"
    if tf32x3:
        b, by = bound(bytes_moved, 3 * flops, "tf32")
    else:
        b, by = bound(bytes_moved, flops, dtype)
    return b, by, flops, bytes_moved, nnz * cin * s


def dw_bound(x, g, rule, tf32x3=False):
    """(bound ms, by, flops) of one weight-gradient call: x, g and the rule
    read once, dW written once, against 2 nnz Cin Cout operations (three
    TF32 products each with ``tf32x3``)."""
    import torch

    k, cin, cout = rule.shape[0], x.shape[1], g.shape[1]
    s = x.element_size()
    flops = 2.0 * int((rule >= 0).sum()) * cin * cout
    bytes_moved = (x.numel() * s + g.numel() * s + rule.numel() * 4
                   + k * cin * cout * 4)
    if tf32x3:
        return (*bound(bytes_moved, 3 * flops, "tf32"), flops)
    dtype = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    return (*bound(bytes_moved, flops, dtype), flops)


def rel_err(got, want):
    """Max |got - want| over max |want| (float32)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / float(
        want.abs().max().clamp(min=1e-12))


def held(what, got, want, limit):
    """Fails unless ``got`` is within ``limit`` of max |want|; returns the
    max abs error."""
    err = rel_err(got, want)
    if not err <= limit:
        raise AssertionError(f"{what}: max err {err:.3e} of max |ref|, "
                             f"limit {limit}")
    return float((got.float() - want.float()).abs().max())


def pad_sweep(feats, weight, rule, g=None):
    """The 4 -> 32 input conv (with ``g`` its weight gradient) in bf16 on
    the SIMT kernel and zero-padded onto the tensor-core route, the pad's
    own time counted, over the first v rows of the recorded shape: the
    measurement behind padding it at any row count
    (``ops/subm_conv.py:tensor_core_pad``), the SIMT kernel held to the
    plain version at each size (bf16 gates).  Measurement only."""
    import torch
    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (subm_conv, subm_conv_dw,
                                                   subm_conv_dw_simt,
                                                   subm_conv_simt)

    pad = 32 - feats.shape[1]
    full = rule.shape[1]
    what = "conv" if g is None else "dW"
    for v in sorted({min(n, full) for n in (1024, 4096, 8192, 16384, 65536,
                                            full)}):
        r = rule[:, :v]
        r = torch.where(r < v, r, -1).contiguous()
        x = feats[:v].contiguous()
        if g is None:
            held(f"SIMT input conv V={v}", subm_conv_simt(x, weight, r),
                 plain_conv(x, weight, r), 2e-2)
            new, old = race(
                lambda: subm_conv(F.pad(x, (0, pad)),
                                  F.pad(weight, (0, 0, 0, pad)), r),
                lambda: subm_conv_simt(x, weight, r))
        else:
            gv = g[:v].contiguous()
            held(f"SIMT input dW V={v}", subm_conv_dw_simt(x, gv, r),
                 plain_dw(x, gv, r), 1e-3)
            new, old = race(
                lambda: subm_conv_dw(F.pad(x, (0, pad)), gv,
                                     r)[:, :x.shape[1]].contiguous(),
                lambda: subm_conv_dw_simt(x, gv, r))
        log(f"    input {what} bf16 V={v}: padded onto the tensor cores "
            f"{new:.4f} ms (pad included), SIMT {old:.4f} ms")


def check_subm_conv(rec, lib_rows):
    """The recorded conv shapes: float32 on the route float32 takes (the
    3xTF32 kernel; its row comes from phase 8b's float32 plot), the working
    type on the route its shape takes; the tensor-core kernel's row."""
    import torch

    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, pack_weight,
                                                   subm_conv, subm_conv_simt,
                                                   tensor_core_pad)

    keys = sorted((k for k in rec.inputs if k[0] == "subm_conv"),
                  key=lambda k: (k[1][0], k[2]))
    csrc = "treelearn_tpu_torch/csrc/"
    sources = {"subm_conv_wgmma": csrc + "subm_conv_wgmma.cu"}
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, by_ops=0,
                      shapes=0) for n in sources}
    totals["subm_conv_wgmma"]["previous_ms"] = 0.0
    for key in keys:
        a = rec.inputs[key]
        feats, weight, rule = a["feats"], a["weight"], a["rule"]
        calls = rec.calls[key]
        cin, cout = weight.shape[1], weight.shape[2]
        # float32: same algorithm, float32 sums (the 3xTF32 route)
        x32, w32 = feats.float(), weight.float()
        f32 = subm_conv(x32, w32, rule)
        r32 = plain_conv(x32, w32, rule)
        torch.cuda.synchronize()
        if not torch.allclose(f32, r32, rtol=1e-4, atol=1e-4 * float(
                r32.abs().max().clamp(min=1e-6))):
            raise AssertionError(f"subm_conv f32 {cin}->{cout}: max err "
                                 f"{float((f32 - r32).abs().max())}")
        if cin < 32:
            pad_sweep(feats, weight, rule)
        del x32, w32, f32, r32
        # working type: bf16 inputs and output, float32 sums in both; the
        # outputs differ by summation order before the final bf16 rounding
        pad = tensor_core_pad(cin, cout, rule.shape[1], feats.dtype)
        plan = conv_plan(cin + pad, cout, rule.shape[1], feats.dtype)
        name = "subm_conv_wgmma"
        if plan.route != "wgmma":
            raise AssertionError(f"bf16 conv {cin}->{cout} took {plan.route}")
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
        held(f"SIMT conv {cin}->{cout}", subm_conv_simt(feats, weight, rule),
             want, 2e-2)
        ms, previous = race(lambda: subm_conv(feats, weight, rule),
                            lambda: subm_conv_simt(feats, weight, rule))
        plain = cuda_ms(lambda: plain_conv(feats, weight, rule), reps=3)
        b, by, flops, compulsory, gathered = conv_bound(feats, weight, rule)
        tot["by_ops"] += by == "operations"
        tot["shapes"] += 1
        line = (f"  {name} {str(feats.dtype)[6:]} V={feats.shape[0]} "
                f"{cin}->{cout}{f' (+{pad} zero channels)' if pad else ''} "
                f"{plan.bm}x{plan.bn}: err {rel:.2e} of "
                f"max|out|, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s), plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
                f"compulsory {compulsory / 1e6:.2f} MB, gathered "
                f"{gathered / 1e6:.2f} MB "
                f"({gathered / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
                f"rate), {calls} call(s)")
        w_in = F.pad(weight, (0, 0, 0, pad))
        for mirror in (False, True):   # the pack kernel, exactly
            if not torch.equal(
                    pack_weight(w_in, 32, mirror).cpu(),
                    pack_weight(w_in.cpu(), 32, mirror)):
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


def vert_against_plain(p):
    """Kernel 4 on problem ``p`` against its plain version on the same card
    tensors; returns (moments, max |dvert|, queries > 1e-3 off, moments'
    error of scale, plain ms, bound ms, bound by, in-radius pairs)."""
    import torch

    from treelearn_tpu_torch.ops.vert import (moments, moments_plain,
                                              vert_from_moments)

    m = moments(p)
    if not torch.equal(m, moments(p)):
        raise AssertionError("verticality: two launches differ")
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
    plain = cuda_ms(lambda: moments_plain(p), reps=2, warmup=1)
    nq, nr = p.queries.shape[0], p.refs4.shape[0]
    pairs = float(m[:, 0].sum())
    b, by = bound(16 * nr + 12 * nq + 40 * nq + 4 * p.ranges.numel()
                  + 4 * p.items.numel(), 30.0 * pairs)
    return m, err, far, mom_err, plain, b, by, pairs


def check_vert(rec, lib_rows):
    """Kernel 4 on the main path's own problem: against its plain version,
    raced against the first kernel on the xy table of the same points."""
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.vert import (moments, moments_serial,
                                              prepare_xy, verticality)

    p = rec.inputs[("vert",)]["problem"]
    if p.table != "xyz":
        raise AssertionError(f"the plot's verticality table is {p.table}")
    m, err, far, mom_err, plain, b, by, pairs = vert_against_plain(p)
    # the first kernel, on the xy table of the same points
    refs = p.refs4[:, :3].contiguous()
    pxy = prepare_xy(refs, p.queries, p.radius)
    old = torch.empty_like(m)
    old[pxy.q_order] = moments_serial(pxy)    # p.queries' order
    if not torch.equal(old[:, 0], m[:, 0]):
        raise AssertionError("verticality: the first kernel's counts differ")
    ms, previous = race(lambda: moments(p), lambda: moments_serial(pxy))
    nq, nr = p.queries.shape[0], p.refs4.shape[0]
    # candidates a query: the 9 ranges of the 3-D table, the 3 x 3 whole
    # columns of the xy table
    per_group = (p.ranges[:, 1::2] - p.ranges[:, 0::2]).sum(1)
    new_cand = torch.repeat_interleave(
        per_group, (p.groups[1:] - p.groups[:-1]).long()).float()
    cs = pxy.cell_start.long()
    qi, qj = pxy.q_cell[:, 0].long(), pxy.q_cell[:, 1].long()
    old_cand = torch.zeros(nq, device=cs.device)
    for di in (-1, 0, 1):
        row = torch.clamp(qi + di, 0, pxy.ni - 1) * pxy.nj
        span = (cs[row + torch.clamp(qj + 1, max=pxy.nj - 1) + 1]
                - cs[row + torch.clamp(qj - 1, min=0)])
        old_cand += torch.where((qi + di >= 0) & (qi + di < pxy.ni), span, 0)
    t0 = time.time()
    verticality(refs, p.queries, p.radius)
    torch.cuda.synchronize()
    whole = time.time() - t0
    log(f"  vert Q={nq} R={nr}: counts exact, moments within {mom_err:.1e} of "
        f"scale, max |dvert| {err:.2e} ({far} > 1e-3), kernel "
        f"{ms:.4f} ms, one-thread-a-query kernel {previous:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by}), {pairs:.0f} in-radius "
        f"pairs; {p.groups.shape[0] - 1} cell groups, {p.items.shape[0]} "
        f"work items; candidates per query 3-D table median "
        f"{int(new_cand.median())}, max {int(new_cand.max())}, sum "
        f"{float(new_cand.sum()):.4g}; xy table median "
        f"{int(old_cand.median())}, max {int(old_cand.max())}, sum "
        f"{float(old_cand.sum()):.4g}; whole verticality() call "
        f"{whole:.4f} s")
    if ms > SLOWER_LIMIT * previous:
        raise AssertionError(f"vert: {ms:.4f} ms, the kernel it replaced "
                             f"{previous:.4f} ms")
    lib_rows.append(dict(
        name="vert", route="cuda", source="treelearn_tpu_torch/csrc/vert.cu",
        replaces="treelearn_tpu/ops/pallas_vert.py:137",
        launches=_cuda.LAUNCHES["vert"], max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        previous_ms=previous, whole_call_s=whole))


def check_cc_problem(p, what, plain_reps):
    """Kernel 5 on one problem: exact against the plain version, raced
    against the first kernel; returns the row's numbers."""
    import torch

    from treelearn_tpu_torch.ops.cc import (box_rejects, found_bits,
                                            found_bits_plain,
                                            found_bits_serial,
                                            neighbor_cells_banded)

    got = found_bits(p)
    want = found_bits_plain(p)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    if mism or not torch.equal(found_bits_serial(p), want):
        raise AssertionError(f"cc {what}: found bits differ for {mism} points")
    ms, previous = race(lambda: found_bits(p), lambda: found_bits_serial(p))
    plain = cuda_ms(lambda: found_bits_plain(p), reps=plain_reps,
                    warmup=plain_reps - 1)
    n, c = p.pts.shape[0], p.cell_keys.shape[0]
    b, by = bound(8 * n + 4 * n + 28 * c + 12 * p.items.shape[0])
    # what a walk can meet: the points of the existing neighbor cells (the
    # own cell aside), before and after the box test (upper bounds: a walk
    # stops at its first hit)
    sizes = (p.cell_start[1:] - p.cell_start[:-1]).long()
    nbr = neighbor_cells_banded(p.cell_keys)
    nbr[:, 12] = -1
    cell = torch.repeat_interleave(torch.arange(c, device=sizes.device), sizes)
    offered = torch.where(nbr >= 0, sizes[nbr.clamp(min=0)], 0)[cell]
    kept = torch.where(box_rejects(p, nbr), 0, offered)
    log(f"  cc {what} N={n}: found bits exact, kernel {ms:.4f} ms, "
        f"one-thread-a-point kernel {previous:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.4f} ms ({by}); {c} cells, points per cell median "
        f"{int(sizes.median())}, max {int(sizes.max())}; "
        f"{p.items.shape[0]} work items; neighbor-cell candidates "
        f"{float(offered.sum()):.4g}, after the box test "
        f"{float(kept.sum()):.4g}")
    if ms > SLOWER_LIMIT * previous:
        raise AssertionError(f"cc {what}: {ms:.4f} ms, the kernel it "
                             f"replaced {previous:.4f} ms")
    return dict(max_abs_err=float(mism), ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, previous_ms=previous)


def check_cc(rec, lib_rows, trained_xy, eps):
    """Kernel 5 on the main path's own problem and on the trained-like
    grouping input (``eps``: the configuration's tau_group); the whole
    cc_labels call on each."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cc import cc_labels, prepare

    row = dict(name="cc", route="cuda",
               source="treelearn_tpu_torch/csrc/cc.cu",
               replaces="treelearn_tpu/ops/pallas_cc.py:116",
               launches=_cuda.LAUNCHES["cc"])
    for what, p, reps in (
            ("plot", rec.inputs[("cc",)]["problem"], 2),
            ("trained-like", None, 1)):
        if p is None:
            xy = torch.from_numpy(trained_xy).to(CARD)
            p = prepare(xy, eps)
        else:
            xy = torch.empty_like(p.pts)
            xy[p.order] = p.pts
        nums = check_cc_problem(p, what, reps)
        t0 = time.time()
        labels = cc_labels(xy, eps)
        whole = time.time() - t0
        log(f"    whole cc_labels() call {whole:.4f} s, "
            f"{len(np.unique(labels))} components")
        lib_rows.append(dict(row, problem=what, whole_call_s=whole, **nums))


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
        f"first step {step_s[0]:.4f} s, median of steps 2..{len(step_s)} "
        f"{np.median(step_s[1:]):.4f} s ({1.0 / np.median(step_s[1:]):.2f} "
        f"steps/s), peak memory {torch.cuda.max_memory_allocated()} B")
    log(f"  losses {[round(float(x), 3) for x in losses]}")
    log(f"  launches {json.dumps(launches)}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if not losses[-5:].mean() < losses[:5].mean():
        raise AssertionError(f"loss did not fall: first 5 mean "
                             f"{losses[:5].mean()}, last 5 mean "
                             f"{losses[-5:].mean()}")
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "subm_conv_dw_wgmma")
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
                                                   subm_conv_simt,
                                                   tensor_core_pad)

    name = "subm_conv_dw_wgmma"
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, shapes=0,
               previous_ms=0.0)
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dw"):
        a = rec.inputs[key]
        x, g, rule = a["x"], a["g"], a["rule"]
        per_step = rec.calls[key] / n_steps
        cin, cout = x.shape[1], g.shape[1]
        pad = tensor_core_pad(cin, cout, x.shape[0], x.dtype)
        plan = dw_plan(cin + pad, cout, x.shape[0], x.dtype)
        if plan.route != "wgmma":
            raise AssertionError(f"bf16 dW {cin}x{cout} took {plan.route}")
        # float32: the route float32 takes (3xTF32; its row is phase 8b's);
        # working type: the tensor-core route
        x32, g32 = x.float(), g.float()
        got = subm_conv_dw(x32, g32, rule)
        want = plain_dw(x32, g32, rule)
        if cin < 32:
            pad_sweep(x, None, rule, g=g)
        del x32, g32
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
        held(f"SIMT dW {key}", subm_conv_dw_simt(x, g, rule), want16, 1e-3)
        tot["err"] = max(tot["err"], abs16)
        tot["shapes"] += 1
        ms, previous = race(lambda: subm_conv_dw(x, g, rule),
                            lambda: subm_conv_dw_simt(x, g, rule),
                            rounds=5)
        plain = cuda_ms(lambda: plain_dw(x, g, rule), reps=3)
        nnz = int((rule >= 0).sum())
        b, _, flops = dw_bound(x, g, rule)
        line = (f"  {name} {key[3][6:]} V={x.shape[0]} {cin}x{cout}"
                f"{f' (+{pad} zero channels)' if pad else ''}: f32 "
                f"err {err32:.1e}, bf16 err {abs16 / scale16:.1e} of max "
                f"|dW|, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain:.4f} ms, bound {b:.4f} ms, gathered "
                f"{nnz * cin * x.element_size() / 1e6:.2f} MB, "
                f"{per_step:.1f} call(s) per step, {plan.n_chunks} chunk(s) "
                f"of {plan.rows_per_chunk} rows, SIMT kernel "
                f"{previous:.4f} ms")
        tot["previous_ms"] += previous * per_step
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(
                f"subm_conv_dw {cin}x{cout} V={x.shape[0]}: the wgmma "
                f"route takes {ms:.4f} ms, the SIMT kernel {previous:.4f}")
        log(line)
        for col, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * per_step
    if not tot.pop("shapes"):
        raise AssertionError(f"no recorded dW shape took {name}")
    totals = {name: tot}
    lib_rows.append(dict(
        name=name, route="cuda",
        source="treelearn_tpu_torch/csrc/subm_conv_dw_wgmma.cu",
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
        held(f"SIMT dx {key}", subm_conv_simt(g, w, rule, mirror=True),
             want, 2e-2)
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


STEP_CFG = dict(channels=8, num_blocks=3, spatial_shape=[256, 256, 128],
                use_coords=True, use_feats=True)
STEP_LR = 1e-3


def step_sample(tmp):
    """The training sample of phases 8 and 10b: one crop of a small plot."""
    from treelearn_tpu_torch.data import TreeDataset
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)

    d = osp.join(tmp, "step_crop")
    if not osp.isdir(d):
        os.makedirs(d)
        data, _ = make_synthetic_forest(n_trees=4, extent=12,
                                        points_per_tree=1500,
                                        ground_points=6000, seed=5)
        data[:, :2] -= data[:, :2].mean(0)
        make_crop_npz(osp.join(d, "c.npz"), data, verticality_proxy(data))
    return TreeDataset(d, inner_square_edge_length=10.0, training=True)[0]


def one_step(make_step, batch, dev, cfg=STEP_CFG):
    """One float32 step of ``make_step(model, optimizer, scheduler)`` from
    the seed-0 weights of ``TreeLearn(**cfg)``; returns (loss, state_dict,
    gradients) on the host and the step's launch counts."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.train.loop import build_optimizer

    model = TreeLearn(**cfg).init(0).to(dev)
    opt, sch = build_optimizer(model.parameters(), {
        "type": "AdamW", "lr": STEP_LR, "weight_decay": 1e-3})
    step = make_step(model, opt, sch)
    _cuda.reset_launches()
    loss, _ = step(batch)
    launches = dict(_cuda.LAUNCHES)
    return (float(loss),
            {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters()}), launches


def compare_steps(got, want, what):
    """Holds one step's (loss, state, gradients) to another's: the loss
    within rtol 1e-5, each parameter's gradient within 1e-3 of its max, its
    update within 1e-2 of the learning rate wherever |g| >= 1e-3 of that
    max (elsewhere AdamW's first step lr * g / (|g| + 1e-8) amplifies
    rounding noise), the running statistics within 1e-4; the Linear biases
    before a BatchNorm, whose gradient is zero in exact arithmetic, are
    left out."""
    from treelearn_tpu_torch.model import TreeLearn

    init = TreeLearn(**STEP_CFG).init(0).state_dict()
    worst_g = worst_u = worst_s = 0.0
    for k, g_want in want[2].items():
        if k.endswith("_linear.0.bias"):
            continue      # zero in exact arithmetic: both sides hold noise
        scale = max(float(g_want.abs().max()), 1e-12)
        err_g = float((got[2][k] - g_want).abs().max()) / scale
        strong = g_want.abs() >= max(1e-3 * scale, 1e-6)
        du = (got[1][k] - init[k]) - (want[1][k] - init[k])
        err_u = float(du[strong].abs().max()) if bool(strong.any()) else 0.0
        if err_g > 1e-3 or err_u > 1e-2 * STEP_LR:
            raise AssertionError(f"{what}: {k}: gradient err {err_g} of "
                                 f"max, update err {err_u}")
        worst_g, worst_u = max(worst_g, err_g), max(worst_u, err_u)
    for k, v in want[1].items():
        if k.endswith(("running_mean", "running_var")):
            err_s = float((got[1][k] - v).abs().max())
            if err_s > 1e-4:
                raise AssertionError(f"{what}: {k} differs by {err_s}")
            worst_s = max(worst_s, err_s)
    rel = abs(got[0] - want[0]) / abs(want[0])
    log(f"{what}: loss {got[0]:.6f} vs {want[0]:.6f} (rel {rel:.1e}); "
        f"gradients within {worst_g:.1e} of each tensor's max; updates "
        f"where |g| >= 1e-3 of max within {worst_u:.2e} (lr {STEP_LR}); "
        f"running stats within {worst_s:.1e}")
    if rel > 1e-5:
        raise AssertionError(f"{what}: losses differ")


def train_step_check(tmp):
    """Phase 8: one float32 step at small width, card against CPU.  Returns
    the card step's launch counts (zeroed just before it): float32 training
    is a path of the 3xTF32 conv and dW kernels."""
    import torch

    from treelearn_tpu_torch.data import collate_padded
    from treelearn_tpu_torch.train.loop import make_train_step

    batch = collate_padded([step_sample(tmp)])
    out = {}
    for dev in (CARD, "cpu"):
        out[dev], step_launches = one_step(
            lambda m, o, s, dev=dev: make_train_step(
                m, o, s, batch_size=1, compute_dtype=torch.float32,
                grad_norm_clip=True, device=dev), batch, dev)
        if dev == CARD:
            launches = step_launches
    compare_steps(out[CARD], out["cpu"], "train step card vs CPU")
    log(f"  {int(batch['n_points'])} points; launches on the card "
        f"{json.dumps(launches)}")
    zero = [k for k in ("rulebook", "subm_conv_tf32", "subm_conv_dw_tf32")
            if launches[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched in the float32 step: "
                             f"{zero}")
    return launches


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
    the CPU, float32 both, same seed weights.  Returns the card run's launch
    counts (zeroed just before it): the float32 path runs every conv on the
    3xTF32 kernel (the 4 -> 8 input conv padded to 8 channels)."""
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    out = {}
    for dev in ("cuda", "cpu"):
        root = osp.join(tmp, f"small_{dev}")
        path, data, _ = write_plot(root, 3, n_trees=6, extent=20,
                                   points_per_tree=800, ground_points=4000)
        config = pipeline_config(path, fp16=False, channels=8, num_blocks=3)
        _cuda.reset_launches()
        res = run_treelearn_pipeline(config, device=dev)
        if dev == "cuda":
            launches = dict(_cuda.LAUNCHES)
        labels = load_data(res["output_path"])[:, 3]
        if len(labels) != len(data):
            raise AssertionError(f"{dev}: {len(labels)} output rows for "
                                 f"{len(data)} input points")
        out[dev] = (labels, res["n_trees"])
    ari = adjusted_rand(out["cuda"][0], out["cpu"][0])
    log(f"small plot: n_trees cuda {out['cuda'][1]} cpu {out['cpu'][1]}, "
        f"ARI {ari:.6f}")
    log(f"  launches on the card {json.dumps(launches)}")
    if ari < 0.999 or out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("card and CPU pipelines disagree")
    zero = [k for k in ("rulebook", "subm_conv_tf32", "vert", "cc")
            if launches[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the float32 path: "
                             f"{zero}")
    return launches


K5_CFG = dict(channels=32, num_blocks=2, kernel_size=5)   # phase 5b's model


def tf32_conv_rows(rec, launches, lib_rows, problem, n_runs=1):
    """The ``subm_conv_tf32`` row of a float32 path's recorded conv shapes:
    at each, the 3xTF32 kernel (repeat launch bit-equal) and the SIMT kernel
    it replaced each held to the plain conv (rtol 1e-4, atol 1e-4 of max
    |out|: the SIMT row's float32 tolerance), the tf32 pack kernel to the
    torch pack exactly, both kernels timed in turns (``previous_ms``), none
    more than ``SLOWER_LIMIT`` slower, the total lower; ms per run
    (weighted by calls over ``n_runs``), per shape in ``per_shape``.
    ``launches``: the path's counts.  Returns the row."""
    import torch
    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan,
                                                   pack_weight_tf32,
                                                   subm_conv, subm_conv_simt,
                                                   tensor_core_pad)

    tot = dict(ms=0.0, previous_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    err, by_ops, shapes = 0.0, 0, []
    for key in sorted((k for k in rec.inputs if k[0] == "subm_conv"),
                      key=lambda k: (-k[1][0], k[2])):
        a = rec.inputs[key]
        feats, weight, rule = a["feats"], a["weight"], a["rule"]
        k, cin, cout = weight.shape
        v = rule.shape[1]
        pad = tensor_core_pad(cin, cout, v, feats.dtype, k)
        plan = conv_plan(cin + pad, cout, v, feats.dtype, k)
        if feats.dtype != torch.float32 or plan.route != "tf32x3":
            raise AssertionError(f"{problem}: conv {key} took {plan.route}")
        calls = rec.calls[key] / n_runs
        got = subm_conv(feats, weight, rule)
        if not torch.equal(got, subm_conv(feats, weight, rule)):
            raise AssertionError(f"{problem}: subm_conv_tf32 {key}: two "
                                 "launches differ")
        want = plain_conv(feats, weight, rule)
        simt = subm_conv_simt(feats, weight, rule)
        torch.cuda.synchronize()
        scale = float(want.abs().max().clamp(min=1e-6))
        for what, out in (("3xTF32", got), ("SIMT", simt)):
            if not torch.allclose(out, want, rtol=1e-4, atol=1e-4 * scale):
                raise AssertionError(
                    f"{problem}: {what} conv K={k} {cin}->{cout} V={v}: max "
                    f"err {float((out - want).abs().max())}")
        wp = F.pad(weight, (0, 0, 0, pad)).contiguous()
        if not torch.equal(pack_weight_tf32(wp, plan.bn, plan.bk).cpu(),
                           pack_weight_tf32(wp.cpu(), plan.bn, plan.bk)):
            raise AssertionError(f"{problem}: pack_weight_tf32 {key} differs")
        err = max(err, float((got - want).abs().max()))
        ms, previous = race(lambda: subm_conv(feats, weight, rule),
                            lambda: subm_conv_simt(feats, weight, rule))
        plain = cuda_ms(lambda: plain_conv(feats, weight, rule), reps=3)
        b, by, flops, _, gathered = conv_bound(feats, weight, rule,
                                               tf32x3=True)
        by_ops += by == "operations"
        log(f"  subm_conv_tf32 K={k} V={v} {cin}->{cout}"
            f"{f' (+{pad} zero channels)' if pad else ''} {plan.bm}x"
            f"{plan.bn}, {plan.bk}-channel slots: err "
            f"{rel_err(got, want):.1e} of max|out|, kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s of float32 work), SIMT kernel "
            f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
            f"({by}), gathered {gathered / 1e6:.2f} MB, {calls:g} call(s)")
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(
                f"{problem}: subm_conv_tf32 {cin}->{cout} V={v}: {ms:.4f} ms, "
                f"the SIMT kernel {previous:.4f}")
        shapes.append(dict(k=k, v=v, cin=cin, cout=cout, calls=calls, ms=ms,
                           previous_ms=previous, plain_ms=plain, bound_ms=b))
        for col, val in (("ms", ms), ("previous_ms", previous),
                         ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * calls
    if not shapes:
        raise AssertionError(f"{problem}: no conv recorded")
    log(f"  {problem}: 3xTF32 convs {tot['ms']:.4f} ms a run, the SIMT "
        f"kernel at the same shapes {tot['previous_ms']:.4f} ms")
    if not tot["ms"] < tot["previous_ms"]:
        raise AssertionError(f"{problem}: the 3xTF32 convs are not faster")
    row = dict(name="subm_conv_tf32", route="cuda",
               source="treelearn_tpu_torch/csrc/subm_conv_tf32.cu",
               replaces="treelearn_tpu/ops/pallas_conv.py:355",
               problem=problem, launches=launches["subm_conv_tf32"],
               max_abs_err=err,
               bound_by="operations" if by_ops * 2 >= len(shapes)
               else "bytes", library_ms=None, per_shape=shapes, **tot)
    lib_rows.append(row)
    return row


def tf32_dw_rows(rec, launches, lib_rows, problem, n_steps):
    """The ``subm_conv_dw_tf32`` row of a float32 training path's recorded
    dW shapes: the 3xTF32 kernel (repeat launch bit-equal) and the SIMT
    kernel each within 1e-4 of max |dW| of the plain dW (the SIMT row's
    float32 tolerance), timed in turns, none more than ``SLOWER_LIMIT``
    slower, the total lower; ms per step."""
    import torch

    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (dw_plan, subm_conv_dw,
                                                   subm_conv_dw_simt,
                                                   tensor_core_pad)

    tot = dict(ms=0.0, previous_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    err, by_ops, shapes = 0.0, 0, []
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dw"):
        a = rec.inputs[key]
        x, g, rule = a["x"], a["g"], a["rule"]
        k, (v, cin), cout = rule.shape[0], x.shape, g.shape[1]
        pad = tensor_core_pad(cin, cout, v, x.dtype, k)
        plan = dw_plan(cin + pad, cout, v, x.dtype, k)
        if x.dtype != torch.float32 or plan.route != "tf32x3":
            raise AssertionError(f"{problem}: dW {key} took {plan.route}")
        per_step = rec.calls[key] / n_steps
        got = subm_conv_dw(x, g, rule)
        if not torch.equal(got, subm_conv_dw(x, g, rule)):
            raise AssertionError(f"{problem}: subm_conv_dw_tf32 {key}: two "
                                 "launches differ")
        want = plain_dw(x, g, rule)
        held(f"{problem}: 3xTF32 dW K={k} {cin}x{cout} V={v}", got, want,
             1e-4)
        held(f"{problem}: SIMT dW K={k} {cin}x{cout} V={v}",
             subm_conv_dw_simt(x, g, rule), want, 1e-4)
        err = max(err, float((got - want).abs().max()))
        ms, previous = race(lambda: subm_conv_dw(x, g, rule),
                            lambda: subm_conv_dw_simt(x, g, rule), rounds=5)
        plain = cuda_ms(lambda: plain_dw(x, g, rule), reps=3)
        b, by, flops = dw_bound(x, g, rule, tf32x3=True)
        by_ops += by == "operations"
        log(f"  subm_conv_dw_tf32 K={k} V={v} {cin}x{cout}"
            f"{f' (+{pad} zero channels)' if pad else ''}: err "
            f"{rel_err(got, want):.1e} of max|dW|, kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s of float32 work), SIMT kernel "
            f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
            f"({by}), {plan.n_chunks} chunk(s) of {plan.rows_per_chunk} "
            f"rows, {per_step:g} call(s) per step")
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(
                f"{problem}: subm_conv_dw_tf32 {cin}x{cout} V={v}: "
                f"{ms:.4f} ms, the SIMT kernel {previous:.4f}")
        shapes.append(dict(k=k, v=v, cin=cin, cout=cout, per_step=per_step,
                           ms=ms, previous_ms=previous, plain_ms=plain,
                           bound_ms=b))
        for col, val in (("ms", ms), ("previous_ms", previous),
                         ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * per_step
    if not shapes:
        raise AssertionError(f"{problem}: no dW recorded")
    log(f"  {problem}: 3xTF32 dW {tot['ms']:.4f} ms a step, the SIMT kernel "
        f"at the same shapes {tot['previous_ms']:.4f} ms")
    if not tot["ms"] < tot["previous_ms"]:
        raise AssertionError(f"{problem}: the 3xTF32 dW is not faster")
    row = dict(name="subm_conv_dw_tf32", route="cuda",
               source="treelearn_tpu_torch/csrc/subm_conv_dw_tf32.cu",
               replaces="treelearn_tpu/ops/pallas_conv.py:438",
               problem=problem, launches=launches["subm_conv_dw_tf32"],
               max_abs_err=err,
               bound_by="operations" if by_ops * 2 >= len(shapes)
               else "bytes", library_ms=None, per_shape=shapes, **tot)
    lib_rows.append(row)
    return row


def tf32_dx_fields(rec, row, n_steps):
    """dx of a float32 training path (the conv with the mirrored weights on
    the 3xTF32 kernel, tiles packed mirrored): at each recorded shape held,
    and the SIMT kernel with it, to autograd through the plain conv (1e-4
    of max |dx|), the mirrored pack to the torch pack exactly, both timed in
    turns, none more than ``SLOWER_LIMIT`` slower, the total lower; the
    per-step sums go into ``row`` as ``dx_*``."""
    import torch

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, mirrored,
                                                   pack_weight_tf32,
                                                   subm_conv_dx,
                                                   subm_conv_simt)

    dx = dict(dx_ms=0.0, dx_previous_ms=0.0, dx_plain_ms=0.0,
              dx_bound_ms=0.0, dx_launches_per_step=0.0)
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dx"):
        a = rec.inputs[key]
        g, w, rule = a["g"], a["weight"], a["rule"]
        k, cin, cout = w.shape
        plan = conv_plan(cout, cin, rule.shape[1], g.dtype, k)
        if g.dtype != torch.float32 or plan.route != "tf32x3":
            raise AssertionError(f"dx {key} took {plan.route}")
        per_step = rec.calls[key] / n_steps
        x0 = torch.zeros((rule.shape[1], cin), device=g.device,
                         requires_grad=True)
        (want,) = torch.autograd.grad((plain_conv(x0, w, rule) * g).sum(),
                                      x0)
        held(f"3xTF32 dx {key}", subm_conv_dx(g, w, rule), want, 1e-4)
        held(f"SIMT dx {key}", subm_conv_simt(g, w, rule, mirror=True), want,
             1e-4)
        if not torch.equal(
                pack_weight_tf32(w, plan.bn, plan.bk, mirror=True).cpu(),
                pack_weight_tf32(w.cpu(), plan.bn, plan.bk, mirror=True)):
            raise AssertionError(f"mirrored pack_weight_tf32 {key} differs")
        ms, previous = race(lambda: subm_conv_dx(g, w, rule),
                            lambda: subm_conv_simt(g, w, rule, mirror=True))
        wm = mirrored(w)
        plain = cuda_ms(lambda: plain_conv(g, wm, rule), reps=3)
        b, by, flops, _, _ = conv_bound(g, wm, rule, tf32x3=True)
        log(f"  dx 3xTF32 V={g.shape[0]} {cin}<-{cout}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s of float32 work), SIMT kernel "
            f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
            f"({by}), {per_step:g} call(s) per step")
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(f"dx {key}: {ms:.4f} ms, the SIMT kernel "
                                 f"{previous:.4f}")
        for col, val in (("dx_ms", ms), ("dx_previous_ms", previous),
                         ("dx_plain_ms", plain), ("dx_bound_ms", b),
                         ("dx_launches_per_step", 1.0)):
            dx[col] += val * per_step
    log(f"  dx per float32 training step: {json.dumps(dx)}")
    if not dx["dx_ms"] < dx["dx_previous_ms"]:
        raise AssertionError("the 3xTF32 dx is not faster per step")
    row.update(dx)


def rounded_sum(feats, weight, rule):
    """The conv's exact value rounded once to feats' dtype: the products
    summed in float64 (exact for bf16 inputs at these depths), then one
    rounding; what a route's output is held to when its rounding flips are
    counted."""
    import torch

    acc = torch.zeros((rule.shape[1], weight.shape[2]), dtype=torch.float64,
                      device=feats.device)
    x, w = feats.double(), weight.double()
    for k in range(rule.shape[0]):
        idx = rule[k].long()
        rows = torch.nonzero(idx >= 0).squeeze(1)
        acc.index_add_(0, rows, x[idx[rows]] @ w[k])
    return acc.to(feats.dtype)


def bf16_conv_rows(rec, launches, lib_rows, problem, n_runs=1):
    """The ``subm_conv_wgmma`` row of a bf16 path's recorded conv shapes
    beside the SIMT kernel: at each, the tensor-core route (repeat launch
    bit-equal) and the SIMT kernel held to the plain conv (2e-2 of max
    |out|), the pack kernel to the torch pack exactly, both timed in turns,
    none more than ``SLOWER_LIMIT`` slower, the total lower; ms per run
    (weighted by calls over ``n_runs``), per shape in ``per_shape``, with
    the outputs of each route that differ from the once-rounded exact sum
    (:func:`rounded_sum`: ``flips``, ``simt_flips``, and how many of the
    route's are smaller in magnitude, ``flips_smaller``).  Where
    Cin % 32 is 16 the other design for such a Cin, feats zero-padded to
    full 32-channel slices in the call (the pad's time counted), is held
    and timed beside the 16-channel tail slice (``tail_ms``, ``pad_ms``).
    ``launches``: the path's counts.  Returns the row."""
    import torch
    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, cout_pad,
                                                   pack_weight, subm_conv,
                                                   subm_conv_simt,
                                                   tensor_core_pad)

    tot = dict(ms=0.0, previous_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               tail_ms=0.0, pad_ms=0.0)
    err, by_ops, shapes = 0.0, 0, []
    for key in sorted((k for k in rec.inputs if k[0] == "subm_conv"),
                      key=str):
        a = rec.inputs[key]
        feats, weight, rule = a["feats"], a["weight"], a["rule"]
        k, cin, cout = weight.shape
        v = rule.shape[1]
        pad_in = tensor_core_pad(cin, cout, v, feats.dtype, k)
        pad_out = cout_pad(cout, feats.dtype, k)
        plan = conv_plan(cin + pad_in, cout + pad_out, v, feats.dtype, k)
        if feats.dtype != torch.bfloat16 or plan.route != "wgmma":
            raise AssertionError(f"{problem}: conv {key} took {plan.route}")
        calls = rec.calls[key] / n_runs
        got = subm_conv(feats, weight, rule)
        if not torch.equal(got, subm_conv(feats, weight, rule)):
            raise AssertionError(f"{problem}: subm_conv_wgmma {key}: two "
                                 "launches differ")
        want = plain_conv(feats, weight, rule)
        what = f"K={k} {cin}->{cout} V={v}"
        err = max(err, held(f"{problem}: wgmma conv {what}", got, want,
                            2e-2))
        simt = subm_conv_simt(feats, weight, rule)
        held(f"{problem}: SIMT conv {what}", simt, want, 2e-2)
        exact = rounded_sum(feats, weight, rule)
        off = got != exact
        flips = dict(flips=int(off.sum()),
                     simt_flips=int((simt != exact).sum()),
                     flips_smaller=int((off & (got.float().abs()
                                               < exact.float().abs())).sum()))
        del simt, exact, off
        wp = F.pad(weight, (0, pad_out, 0, pad_in)).contiguous()
        if not torch.equal(pack_weight(wp, plan.bn).cpu(),
                           pack_weight(wp.cpu(), plan.bn)):
            raise AssertionError(f"{problem}: pack_weight {key} differs")
        ms, previous = race(lambda: subm_conv(feats, weight, rule),
                            lambda: subm_conv_simt(feats, weight, rule))
        plain = cuda_ms(lambda: plain_conv(feats, weight, rule), reps=3)
        b, by, flops, _, gathered = conv_bound(feats, weight, rule)
        by_ops += by == "operations"
        pads = f" (+{pad_in} / +{pad_out} zero channels)" if (
            pad_in or pad_out) else ""
        line = (f"  subm_conv_wgmma bf16 {what}{pads} {plan.bm}x{plan.bn}: "
                f"err {rel_err(got, want):.1e} of max|out|, kernel {ms:.4f} "
                f"ms ({flops / ms / 1e9:.1f} TFLOP/s), SIMT kernel "
                f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
                f"({by}), gathered {gathered / 1e6:.2f} MB, {calls:g} "
                f"call(s); of {got.numel()} outputs off the rounded exact "
                f"sum: wgmma {flips['flips']} ({flips['flips_smaller']} "
                f"smaller), SIMT {flips['simt_flips']}")
        shape = dict(k=k, v=v, cin=cin, cout=cout, calls=calls, ms=ms,
                     previous_ms=previous, plain_ms=plain, bound_ms=b,
                     outputs=got.numel(), **flips)
        if cin % 32 == 16:
            w16 = F.pad(weight, (0, 0, 0, 16))
            held(f"{problem}: padded-design conv {what}",
                 subm_conv(F.pad(feats, (0, 16)), w16, rule), want, 2e-2)
            tail, padded = race(
                lambda: subm_conv(feats, weight, rule),
                lambda: subm_conv(F.pad(feats, (0, 16)), w16, rule))
            line += (f"; Cin {cin} as a 16-channel tail slice {tail:.4f} ms, "
                     f"padded to {cin + 16} in the call {padded:.4f} ms")
            shape.update(tail_ms=tail, pad_ms=padded)
            tot["tail_ms"] += tail * calls
            tot["pad_ms"] += padded * calls
        log(line)
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(
                f"{problem}: subm_conv_wgmma {what}: {ms:.4f} ms, the SIMT "
                f"kernel {previous:.4f}")
        shapes.append(shape)
        for col, val in (("ms", ms), ("previous_ms", previous),
                         ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * calls
    if not shapes:
        raise AssertionError(f"{problem}: no conv recorded")
    log(f"  {problem}: bf16 tensor-core convs {tot['ms']:.4f} ms a run, the "
        f"SIMT kernel at the same shapes {tot['previous_ms']:.4f} ms"
        + (f"; the shapes with Cin % 32 = 16: tail slices "
           f"{tot['tail_ms']:.4f} ms, padded in the call {tot['pad_ms']:.4f}"
           f" ms" if tot["pad_ms"] else ""))
    if not tot["ms"] < tot["previous_ms"]:
        raise AssertionError(f"{problem}: the bf16 tensor-core convs are not "
                             "faster")
    if not tot["pad_ms"]:
        del tot["tail_ms"], tot["pad_ms"]
    row = dict(name="subm_conv_wgmma", route="cuda",
               source="treelearn_tpu_torch/csrc/subm_conv_wgmma.cu",
               replaces="treelearn_tpu/ops/pallas_conv.py:355",
               problem=problem, launches=launches["subm_conv_wgmma"],
               max_abs_err=err,
               bound_by="operations" if by_ops * 2 >= len(shapes)
               else "bytes", library_ms=None, per_shape=shapes, **tot)
    lib_rows.append(row)
    return row


def bf16_dw_rows(rec, launches, lib_rows, problem, n_steps):
    """The ``subm_conv_dw_wgmma`` row of a bf16 training path's recorded dW
    shapes: the tensor-core kernel (repeat launch bit-equal) and the SIMT
    kernel each within 1e-3 of max |dW| of the plain dW, timed in turns,
    none more than ``SLOWER_LIMIT`` slower, the total lower; where Cin % 32
    is 16 the design that zero-pads x to full slabs in the call (dW's extra
    rows dropped) held and timed beside the native one; ms per step."""
    import torch
    import torch.nn.functional as F

    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain_dw
    from treelearn_tpu_torch.ops.subm_conv import (cout_pad, dw_plan,
                                                   subm_conv_dw,
                                                   subm_conv_dw_simt,
                                                   tensor_core_pad)

    tot = dict(ms=0.0, previous_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               tail_ms=0.0, pad_ms=0.0)
    err, by_ops, shapes = 0.0, 0, []
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dw"):
        a = rec.inputs[key]
        x, g, rule = a["x"], a["g"], a["rule"]
        k, (v, cin), cout = rule.shape[0], x.shape, g.shape[1]
        pad_in = tensor_core_pad(cin, cout, v, x.dtype, k)
        pad_out = cout_pad(cout, x.dtype, k)
        plan = dw_plan(cin + pad_in, cout + pad_out, v, x.dtype, k)
        if x.dtype != torch.bfloat16 or plan.route != "wgmma":
            raise AssertionError(f"{problem}: dW {key} took {plan.route}")
        per_step = rec.calls[key] / n_steps
        got = subm_conv_dw(x, g, rule)
        if not torch.equal(got, subm_conv_dw(x, g, rule)):
            raise AssertionError(f"{problem}: subm_conv_dw_wgmma {key}: two "
                                 "launches differ")
        want = plain_dw(x, g, rule)
        what = f"K={k} {cin}x{cout} V={v}"
        err = max(err, held(f"{problem}: wgmma dW {what}", got, want, 1e-3))
        held(f"{problem}: SIMT dW {what}", subm_conv_dw_simt(x, g, rule),
             want, 1e-3)
        ms, previous = race(lambda: subm_conv_dw(x, g, rule),
                            lambda: subm_conv_dw_simt(x, g, rule), rounds=5)
        plain = cuda_ms(lambda: plain_dw(x, g, rule), reps=3)
        b, by, flops = dw_bound(x, g, rule)
        by_ops += by == "operations"
        line = (f"  subm_conv_dw_wgmma bf16 {what}"
                f"{f' (+{pad_in} zero channels)' if pad_in else ''}: err "
                f"{rel_err(got, want):.1e} of max|dW|, kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), SIMT kernel "
                f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
                f"({by}), {plan.n_chunks} chunk(s) of {plan.rows_per_chunk} "
                f"rows, {per_step:g} call(s) per step")
        shape = dict(k=k, v=v, cin=cin, cout=cout, per_step=per_step, ms=ms,
                     previous_ms=previous, plain_ms=plain, bound_ms=b)
        if cin % 32 == 16:
            def padded_dw():
                return subm_conv_dw(F.pad(x, (0, 16)), g,
                                    rule)[:, :cin].contiguous()

            held(f"{problem}: padded-design dW {what}", padded_dw(), want,
                 1e-3)
            tail, padded = race(lambda: subm_conv_dw(x, g, rule), padded_dw,
                                rounds=5)
            line += (f"; Cin {cin} in 8-channel chunks {tail:.4f} ms, padded "
                     f"to {cin + 16} in the call {padded:.4f} ms")
            shape.update(tail_ms=tail, pad_ms=padded)
            tot["tail_ms"] += tail * per_step
            tot["pad_ms"] += padded * per_step
        log(line)
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(
                f"{problem}: subm_conv_dw_wgmma {what}: {ms:.4f} ms, the "
                f"SIMT kernel {previous:.4f}")
        shapes.append(shape)
        for col, val in (("ms", ms), ("previous_ms", previous),
                         ("plain_ms", plain), ("bound_ms", b)):
            tot[col] += val * per_step
    if not shapes:
        raise AssertionError(f"{problem}: no dW recorded")
    log(f"  {problem}: bf16 tensor-core dW {tot['ms']:.4f} ms a step, the "
        f"SIMT kernel at the same shapes {tot['previous_ms']:.4f} ms"
        + (f"; the shapes with Cin % 32 = 16: native {tot['tail_ms']:.4f} "
           f"ms, padded in the call {tot['pad_ms']:.4f} ms"
           if tot["pad_ms"] else ""))
    if not tot["ms"] < tot["previous_ms"]:
        raise AssertionError(f"{problem}: the bf16 tensor-core dW is not "
                             "faster")
    if not tot["pad_ms"]:
        del tot["tail_ms"], tot["pad_ms"]
    row = dict(name="subm_conv_dw_wgmma", route="cuda",
               source="treelearn_tpu_torch/csrc/subm_conv_dw_wgmma.cu",
               replaces="treelearn_tpu/ops/pallas_conv.py:438",
               problem=problem, launches=launches["subm_conv_dw_wgmma"],
               max_abs_err=err,
               bound_by="operations" if by_ops * 2 >= len(shapes)
               else "bytes", library_ms=None, per_shape=shapes, **tot)
    lib_rows.append(row)
    return row


def bf16_dx_fields(rec, row, n_steps):
    """dx of a bf16 training path (the conv with the mirrored weights on the
    tensor-core kernel, tiles packed mirrored): at each recorded shape held,
    and the SIMT kernel with it, to the plain conv with the mirrored
    weights (2e-2 of max |dx|), repeat launch bit-equal, both timed in
    turns, none more than ``SLOWER_LIMIT`` slower, the total lower; the
    per-step sums go into ``row`` as ``dx_*``."""
    import torch

    from treelearn_tpu_torch.ops.sparse import subm_conv as plain_conv
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, cout_pad,
                                                   mirrored, subm_conv_dx,
                                                   subm_conv_simt,
                                                   tensor_core_pad)

    dx = dict(dx_ms=0.0, dx_previous_ms=0.0, dx_plain_ms=0.0,
              dx_bound_ms=0.0, dx_launches_per_step=0.0)
    for key in sorted(k for k in rec.inputs if k[0] == "subm_conv_dx"):
        a = rec.inputs[key]
        g, w, rule = a["g"], a["weight"], a["rule"]
        k, cin, cout = w.shape
        v = rule.shape[1]
        plan = conv_plan(cout + tensor_core_pad(cout, cin, v, g.dtype, k),
                         cin + cout_pad(cin, g.dtype, k), v, g.dtype, k)
        if g.dtype != torch.bfloat16 or plan.route != "wgmma":
            raise AssertionError(f"dx {key} took {plan.route}")
        per_step = rec.calls[key] / n_steps
        got = subm_conv_dx(g, w, rule)
        if not torch.equal(got, subm_conv_dx(g, w, rule)):
            raise AssertionError(f"dx {key}: two launches differ")
        wm = mirrored(w)
        want = plain_conv(g, wm, rule)
        held(f"bf16 dx {key}", got, want, 2e-2)
        held(f"SIMT dx {key}", subm_conv_simt(g, w, rule, mirror=True), want,
             2e-2)
        ms, previous = race(lambda: subm_conv_dx(g, w, rule),
                            lambda: subm_conv_simt(g, w, rule, mirror=True))
        plain = cuda_ms(lambda: plain_conv(g, wm, rule), reps=3)
        b, by, flops, _, _ = conv_bound(g, wm, rule)
        log(f"  dx bf16 K={k} V={v} {cin}<-{cout} {plan.bm}x{plan.bn}: "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SIMT "
            f"kernel {previous:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} "
            f"ms ({by}), {per_step:g} call(s) per step")
        if ms > SLOWER_LIMIT * previous:
            raise AssertionError(f"dx {key}: {ms:.4f} ms, the SIMT kernel "
                                 f"{previous:.4f}")
        for col, val in (("dx_ms", ms), ("dx_previous_ms", previous),
                         ("dx_plain_ms", plain), ("dx_bound_ms", b),
                         ("dx_launches_per_step", 1.0)):
            dx[col] += val * per_step
    log(f"  dx per bf16 training step: {json.dumps(dx)}")
    if not dx["dx_ms"] < dx["dx_previous_ms"]:
        raise AssertionError("the bf16 tensor-core dx is not faster per step")
    row.update(dx)


def k5_small_plot(tmp, dev, fp16, rec=None):
    """The ``kernel_size: 5`` model on the small plot on ``dev``; counts
    zeroed just before.  Returns (labels, n_trees, launches, n_points)."""
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    path, data, _ = write_plot(osp.join(tmp, f"k5_{dev}_{int(fp16)}"), 3,
                               n_trees=6, extent=20, points_per_tree=800,
                               ground_points=4000)
    config = pipeline_config(path, fp16=fp16, **{
        k: v for k, v in K5_CFG.items() if k != "kernel_size"})
    config.model.kernel_size = K5_CFG["kernel_size"]
    _cuda.set_recorder(rec)
    _cuda.reset_launches()
    res = run_treelearn_pipeline(config, device=dev)
    launches = dict(_cuda.LAUNCHES)
    _cuda.set_recorder(None)
    labels = load_data(res["output_path"])[:, 3]
    if len(labels) != len(data):
        raise AssertionError(f"k5 {dev}: {len(labels)} output rows")
    return labels, res["n_trees"], launches, len(data)


def k5_step(tmp, dtype, rec):
    """One training step of the ``kernel_size: 5`` model on the card in
    ``dtype`` with ``rec`` installed; returns (loss, launches)."""
    import torch

    from treelearn_tpu_torch.data import collate_padded
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.train.loop import make_train_step

    _cuda.set_recorder(rec)
    (loss, _, _), launches = one_step(
        lambda m, o, s: make_train_step(
            m, o, s, batch_size=1, compute_dtype=dtype,
            grad_norm_clip=True, device=CARD),
        collate_padded([step_sample(tmp)]), CARD,
        dict(STEP_CFG, **K5_CFG))
    _cuda.set_recorder(None)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"kernel_size 5 {dtype} step: loss {loss}")
    return loss, launches


def kernel_size5_check(tmp, lib_rows):
    """Phase 5b: a kernel_size 5 model (2 levels, channels 32, seed-0
    weights) on the small plot.  float32, card against CPU as phase 5 holds
    them; the card run's counts, zeroed just before it, must show the 3xTF32
    conv with K = 125 and no other conv kernel; its shapes make a
    ``subm_conv_tf32`` row.  One float32 training step, counts zeroed just
    before it: the 3xTF32 dW must launch (a ``subm_conv_dw_tf32`` row).
    Then bf16: the same plot and one step on the card, counts zeroed just
    before each: the bf16 tensor-core conv and dW must launch at K = 125
    and no SIMT, rulebook or 3xTF32 kernel; their shapes, held and raced
    against the SIMT kernels, make the ``subm_conv_wgmma`` (with the dx
    fields) and ``subm_conv_dw_wgmma`` rows of the problem, their totals
    printed beside the 3xTF32 ones of this process."""
    import torch

    t0 = time.time()
    problem = "kernel_size 5 (phase 5b)"
    rec = Recorder()
    card = k5_small_plot(tmp, CARD, False, rec)
    cpu = k5_small_plot(tmp, "cpu", False)
    launches = card[2]
    ari = adjusted_rand(card[0], cpu[0])
    log(f"kernel_size 5 small plot, float32: n_trees cuda {card[1]} cpu "
        f"{cpu[1]}, ARI {ari:.6f}; launches on the card "
        f"{json.dumps(launches)}")
    if ari < 0.999 or card[1] != cpu[1]:
        raise AssertionError("kernel_size 5: card and CPU pipelines disagree")
    if (launches["subm_conv_tf32"] == 0 or launches["subm_conv_wgmma"]
            or launches["subm_conv"] or launches["rulebook"]):
        raise AssertionError(f"kernel_size 5 launches {launches}")
    tf32_conv = tf32_conv_rows(rec, launches, lib_rows, problem)
    rec = GradRecorder()
    loss, step_launches = k5_step(tmp, torch.float32, rec)
    log(f"  kernel_size 5 float32 training step on the card: loss "
        f"{loss:.5f}, launches {json.dumps(step_launches)}")
    if (step_launches["subm_conv_dw_tf32"] == 0
            or step_launches["subm_conv_dw_wgmma"]
            or step_launches["subm_conv_dw"]):
        raise AssertionError(f"kernel_size 5 step launches {step_launches}")
    tf32_dw = tf32_dw_rows(rec, step_launches, lib_rows, problem, 1)
    # bf16: the tensor-core kernels at K = 125, no SIMT launch
    problem = "kernel_size 5, bf16 (phase 5b)"
    rec = Recorder()
    _, n_trees, launches, _ = k5_small_plot(tmp, CARD, True, rec)
    log(f"kernel_size 5 small plot, bf16, on the card: n_trees {n_trees}, "
        f"launches {json.dumps(launches)}")
    if (launches["subm_conv_wgmma"] == 0 or launches["subm_conv"]
            or launches["subm_conv_tf32"] or launches["rulebook"]):
        raise AssertionError(f"kernel_size 5 bf16 launches {launches}")
    conv = bf16_conv_rows(rec, launches, lib_rows, problem)
    rec = GradRecorder()
    loss, step_launches = k5_step(tmp, torch.bfloat16, rec)
    log(f"  kernel_size 5 bf16 training step on the card: loss {loss:.5f}, "
        f"launches {json.dumps(step_launches)}")
    if (step_launches["subm_conv_dw_wgmma"] == 0
            or step_launches["subm_conv_wgmma"] == 0
            or step_launches["subm_conv_dw"] or step_launches["subm_conv"]
            or step_launches["subm_conv_dw_tf32"]
            or step_launches["subm_conv_tf32"]):
        raise AssertionError(f"kernel_size 5 bf16 step launches "
                             f"{step_launches}")
    dw = bf16_dw_rows(rec, step_launches, lib_rows, problem, 1)
    bf16_dx_fields(rec, conv, 1)
    log(f"  kernel_size 5, K = 125, this process: convs per run bf16 "
        f"{conv['ms']:.4f} ms, 3xTF32 {tf32_conv['ms']:.4f} ms, SIMT (bf16) "
        f"{conv['previous_ms']:.4f} ms; dW per step bf16 {dw['ms']:.4f} ms, "
        f"3xTF32 {tf32_dw['ms']:.4f} ms, SIMT (bf16) "
        f"{dw['previous_ms']:.4f} ms; dx per step bf16 {conv['dx_ms']:.4f} "
        f"ms, SIMT (bf16) {conv['dx_previous_ms']:.4f} ms")
    conv.update(tf32_ms=tf32_conv["ms"])
    dw.update(tf32_ms=tf32_dw["ms"])
    log(f"  phase 5b: {time.time() - t0:.1f} s")


NARROW_CHANNELS = 16   # phase 5c's model: levels 16..112
NARROW_STEPS = 3       # phase 5c's training steps


@contextlib.contextmanager
def bf16_simt(every_width):
    """Within the block, bf16 convs take the SIMT kernel, unpadded: with
    ``every_width`` all of them; else the widths that took it before the
    bf16 tensor-core conv took every width, i.e. all but K = 27 with Cin
    and Cout in multiples of 32 (and the 4 -> 32 input conv from 32,768
    rows, padded onto the tensor cores), which keep the wgmma route
    (``ops/subm_conv.py``'s routing functions swapped in-process; float32
    keeps its routes)."""
    import torch

    from treelearn_tpu_torch.ops import subm_conv as sc

    plan, pad, pad_out = sc.conv_plan, sc.tensor_core_pad, sc.cout_pad
    bf = torch.bfloat16

    def conv_plan(cin, cout, v, dtype=bf, n_offsets=sc.N_OFFSETS):
        if dtype == bf and (every_width or n_offsets != 27 or cin <= 0
                            or cout <= 0 or cin % 32 or cout % 32):
            return sc.ConvPlan("simt", 64, 64, -(-cout // 64), 32, 1, 0, 0)
        return plan(cin, cout, v, dtype, n_offsets)

    def tensor_core_pad(cin, cout, v, dtype, n_offsets=sc.N_OFFSETS):
        if dtype == bf:
            return (32 - cin if not every_width and n_offsets == 27
                    and 0 < cin < 32 and cout and not cout % 32
                    and v >= 32768 else 0)
        return pad(cin, cout, v, dtype, n_offsets)

    def cout_pad(cout, dtype, n_offsets=sc.N_OFFSETS):
        return 0 if dtype == bf else pad_out(cout, dtype, n_offsets)

    sc.conv_plan, sc.tensor_core_pad, sc.cout_pad = (conv_plan,
                                                     tensor_core_pad,
                                                     cout_pad)
    try:
        yield
    finally:
        sc.conv_plan, sc.tensor_core_pad, sc.cout_pad = plan, pad, pad_out


def narrow_phase(tmp, path, lib_rows):
    """Phase 5c: bf16 widths that are no multiple of 32.  (a) Phase 3's
    plot with a ``channels: 16`` model (levels 16..112, decoder convs of
    32..224 input channels; seed-0 weights), counts zeroed just before: the
    rulebook and the bf16 tensor-core conv must launch, no SIMT or 3xTF32
    conv; (b) the same plot with the SIMT route forced in-process
    (:func:`bf16_simt`), for every conv and for the widths that took it
    before: the same tree count, and the same partition as far as bf16
    summation order lets two correct routes agree: ARI >= 0.999, or, where
    the shipped ``channels: 32`` model (whose bf16 routes are unchanged)
    already moves further between its tensor-core route and the SIMT one
    on the same plot, ARI at least that model's (the seed-0 model's
    semantic logits sit within bf16 rounding of the threshold); the
    recorded conv shapes make the ``subm_conv_wgmma`` row of the
    problem (held and raced against SIMT, the zero-pad design timed at
    Cin = 16 mod 32).  (c) ``NARROW_STEPS`` bf16 steps of
    ``train_synthetic_checkpoint`` of that model as phase 6 runs them (its
    crops), counts zeroed just before: the tensor-core conv and dW must
    launch and no SIMT kernel; its dW shapes make the
    ``subm_conv_dw_wgmma`` row, its dx shapes the conv row's ``dx_*``
    fields."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.config import load_yaml_file
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.train.selftrain import (
        BENCH_RECIPE, train_synthetic_checkpoint)

    t0 = time.time()
    problem = f"channels {NARROW_CHANNELS} (phase 5c)"
    rec = Recorder()
    _cuda.set_recorder(rec)
    res, wall, launches, fwd = run_plot(path, channels=NARROW_CHANNELS)
    _cuda.set_recorder(None)
    log_plot(f"channels {NARROW_CHANNELS} plot, bf16 (recorder installed)",
             res, wall, launches, fwd)
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "vert", "cc")
            if launches[k] == 0]
    if zero or launches["subm_conv"] or launches["subm_conv_tf32"]:
        raise AssertionError(f"channels {NARROW_CHANNELS} plot launches "
                             f"{launches}")
    labels = load_data(res["output_path"])[:, 3].copy()

    def forced(every_width, channels):
        with bf16_simt(every_width):
            out = run_plot(path, channels=channels)
        what = "every conv" if every_width else "the widths it took before"
        log_plot(f"channels {channels} plot, bf16, SIMT route forced for "
                 f"{what}", *out)
        if out[2]["subm_conv"] == 0 or (every_width
                                        and out[2]["subm_conv_wgmma"]):
            raise AssertionError(f"SIMT-forced plot launches {out[2]}")
        return out, load_data(out[0]["output_path"])[:, 3].copy()

    # how far bf16 summation order alone moves the shipped model's partition
    ship = load_data(run_plot(path)[0]["output_path"])[:, 3].copy()
    ari_ship = adjusted_rand(ship, forced(True, 32)[1])
    limit = min(0.999, ari_ship)
    log(f"channels 32 plot (the shipped width, its bf16 routes unchanged), "
        f"tensor-core vs SIMT convs: ARI {ari_ship:.6f}; the limit for "
        f"channels {NARROW_CHANNELS}: {limit:.6f}")
    plot = dict(plot_forward_ms=sum(fwd.device_ms()),
                plot_ari_shipped_width=ari_ship)
    for every_width, col in ((True, "simt"), (False, "before")):
        out, other = forced(every_width, NARROW_CHANNELS)
        ari = adjusted_rand(labels, other)
        share = float((labels != other).mean())
        log(f"channels {NARROW_CHANNELS} plot, tensor-core vs SIMT convs "
            f"({'every width' if every_width else 'the widths before'}): "
            f"ARI {ari:.6f}, labels differing {share:.6f}, n_trees "
            f"{res['n_trees']} / {out[0]['n_trees']}")
        if ari < limit or res["n_trees"] != out[0]["n_trees"]:
            raise AssertionError("the tensor-core and SIMT bf16 plots "
                                 "disagree")
        plot[f"plot_ari_{col}"] = ari
        plot[f"plot_{col}_forward_ms"] = sum(out[3].device_ms())
    row = bf16_conv_rows(rec, launches, lib_rows, problem)
    row.update(plot)
    del rec
    model_cfg = dict(load_yaml_file(osp.join(
        REPO, "configs", "_modular", "model.yaml"))["model"])
    model_cfg["channels"] = NARROW_CHANNELS
    rec = GradRecorder()
    _cuda.set_recorder(rec)
    _cuda.reset_launches()
    _, info = train_synthetic_checkpoint(
        model_cfg, cache_dir=osp.join(tmp, "selftrain_narrow"),
        steps=NARROW_STEPS, lr=BENCH_RECIPE["lr"], n_crops=4,
        crop_extent=BENCH_RECIPE["crop_extent"], ppt=BENCH_RECIPE["ppt"],
        hard_frac=BENCH_RECIPE["hard_frac"], batch_size=1, log_every=1,
        logger=lambda m: log("  " + m), return_info=True, device=CARD,
        compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    train_launches = dict(_cuda.LAUNCHES)
    _cuda.set_recorder(None)
    losses = np.asarray(info["losses"])
    log(f"channels {NARROW_CHANNELS} bf16 train: {len(losses)} steps, "
        f"losses {[round(float(x), 3) for x in losses]}, launches "
        f"{json.dumps(train_launches)}")
    if len(losses) != NARROW_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"channels {NARROW_CHANNELS} losses {losses}")
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "subm_conv_dw_wgmma")
            if train_launches[k] == 0]
    if zero or any(train_launches[k] for k in (
            "subm_conv", "subm_conv_dw", "subm_conv_tf32",
            "subm_conv_dw_tf32")):
        raise AssertionError(f"channels {NARROW_CHANNELS} training launches "
                             f"{train_launches}")
    n_steps = len(losses)
    bf16_dw_rows(rec, train_launches, lib_rows, problem, n_steps)
    bf16_dx_fields(rec, row, n_steps)
    log(f"  phase 5c: {time.time() - t0:.1f} s")


@contextlib.contextmanager
def simt_float32():
    """Within the block, float32 convs take the SIMT kernel, unpadded, as
    they did before the 3xTF32 route (``ops/subm_conv.py``'s routing
    functions swapped in-process; bf16 keeps its routes)."""
    import torch

    from treelearn_tpu_torch.ops import subm_conv as sc

    plan, pad = sc.conv_plan, sc.tensor_core_pad

    def conv_plan(cin, cout, v, dtype=torch.bfloat16,
                  n_offsets=sc.N_OFFSETS):
        if dtype == torch.float32:
            return sc.ConvPlan("simt", 64, 64, -(-cout // 64), 32, 1, 0, 0)
        return plan(cin, cout, v, dtype, n_offsets)

    def tensor_core_pad(cin, cout, v, dtype, n_offsets=sc.N_OFFSETS):
        if dtype == torch.float32:
            return 0
        return pad(cin, cout, v, dtype, n_offsets)

    sc.conv_plan, sc.tensor_core_pad = conv_plan, tensor_core_pad
    try:
        yield
    finally:
        sc.conv_plan, sc.tensor_core_pad = plan, pad


def float32_phase(tmp, path, bf16_plot, bf16_step_s, lib_rows):
    """Phase 8b: the float32 route at full width (channels 32, 7 levels,
    ``fp16: False``).  (a) The plot, counts zeroed just before: the
    rulebook, the 3xTF32 conv, verticality and found bits must launch, no
    other conv; its conv shapes make the ``subm_conv_tf32`` row (problem
    "plot, float32").  (b) The same run warm, then with the SIMT route
    forced in-process: the same partition (ARI >= 0.999) and tree count;
    wall time and the forward's CUDA-event ms of each beside the bf16
    plot's (``bf16_plot``: wall s, forward ms).  (c) ``TRAIN_STEPS`` float32
    steps of ``train_synthetic_checkpoint`` as phase 6 runs them, counts
    zeroed just before: the rulebook and both 3xTF32 kernels must launch,
    every loss be finite and the last 5 below the first 5; the median step
    beside the bf16 one (``bf16_step_s``); its dW shapes make the
    ``subm_conv_dw_tf32`` row, its dx shapes the row's ``dx_*`` fields."""
    import numpy as np
    import torch

    from treelearn_tpu_torch.config import load_yaml_file
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.train.selftrain import (
        BENCH_RECIPE, train_synthetic_checkpoint)

    t0 = time.time()
    problem = "plot, float32 (phase 8b)"
    rec = Recorder()
    _cuda.set_recorder(rec)
    cold = run_plot(path, fp16=False)
    _cuda.set_recorder(None)
    log_plot("float32 plot (cold, recorder installed)", *cold)
    launches = cold[2]
    zero = [k for k in ("rulebook", "subm_conv_tf32", "vert", "cc")
            if launches[k] == 0]
    if zero or launches["subm_conv"] or launches["subm_conv_wgmma"]:
        raise AssertionError(f"float32 plot launches {launches}")
    row = tf32_conv_rows(rec, launches, lib_rows, problem)
    del rec
    runs = {}
    for what in ("3xTF32", "SIMT"):
        if what == "SIMT":
            with simt_float32():
                res, wall, counts, fwd = run_plot(path, fp16=False)
            if counts["subm_conv"] == 0 or counts["subm_conv_tf32"]:
                raise AssertionError(f"SIMT-forced plot launches {counts}")
        else:
            res, wall, counts, fwd = run_plot(path, fp16=False)
        labels = load_data(res["output_path"])[:, 3]
        runs[what] = (labels, res["n_trees"], wall,
                      sum(fwd.device_ms()), sum(fwd.host_s))
        log_plot(f"float32 plot (warm, {what} convs)", res, wall, counts,
                 fwd)
    ari = adjusted_rand(runs["3xTF32"][0], runs["SIMT"][0])
    log(f"float32 plot, 3xTF32 vs SIMT convs: ARI {ari:.6f}, n_trees "
        f"{runs['3xTF32'][1]} / {runs['SIMT'][1]}")
    if ari < 0.999 or runs["3xTF32"][1] != runs["SIMT"][1]:
        raise AssertionError("the 3xTF32 and SIMT float32 plots disagree")
    log(f"plot warm wall / forward (CUDA events): float32 3xTF32 "
        f"{runs['3xTF32'][2]:.2f} s / {runs['3xTF32'][3]:.2f} ms, float32 "
        f"SIMT {runs['SIMT'][2]:.2f} s / {runs['SIMT'][3]:.2f} ms, bf16 "
        f"{bf16_plot[0]:.2f} s / {bf16_plot[1]:.2f} ms")
    row.update(plot_warm_s=runs["3xTF32"][2],
               plot_forward_ms=runs["3xTF32"][3],
               plot_simt_warm_s=runs["SIMT"][2],
               plot_simt_forward_ms=runs["SIMT"][3],
               plot_bf16_warm_s=bf16_plot[0],
               plot_bf16_forward_ms=bf16_plot[1])
    # (c) float32 training
    model_cfg = dict(load_yaml_file(osp.join(
        REPO, "configs", "_modular", "model.yaml"))["model"])
    rec = GradRecorder()
    _cuda.set_recorder(rec)
    _cuda.reset_launches()
    _, info = train_synthetic_checkpoint(
        model_cfg, cache_dir=osp.join(tmp, "selftrain_f32"),
        steps=TRAIN_STEPS, lr=BENCH_RECIPE["lr"], n_crops=4,
        crop_extent=BENCH_RECIPE["crop_extent"], ppt=BENCH_RECIPE["ppt"],
        hard_frac=BENCH_RECIPE["hard_frac"], batch_size=1, log_every=5,
        logger=lambda m: log("  " + m), return_info=True, device=CARD,
        compute_dtype=torch.float32)
    torch.cuda.synchronize()
    train_launches = dict(_cuda.LAUNCHES)
    _cuda.set_recorder(None)
    losses = np.asarray(info["losses"])
    step_s = np.asarray(info["step_seconds"])
    median = float(np.median(step_s[1:]))
    log(f"float32 train: {len(losses)} steps, first step {step_s[0]:.4f} s, "
        f"median of steps 2..{len(step_s)} {median:.4f} s (bf16, phase 6: "
        f"{bf16_step_s:.4f} s)")
    log(f"  losses {[round(float(x), 3) for x in losses]}")
    log(f"  launches {json.dumps(train_launches)}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"float32 training losses {losses}")
    if not losses[-5:].mean() < losses[:5].mean():
        raise AssertionError(f"float32 loss did not fall: first 5 mean "
                             f"{losses[:5].mean()}, last 5 mean "
                             f"{losses[-5:].mean()}")
    zero = [k for k in ("rulebook", "subm_conv_tf32", "subm_conv_dw_tf32")
            if train_launches[k] == 0]
    if zero or train_launches["subm_conv_dw"] or train_launches[
            "subm_conv_dw_wgmma"]:
        raise AssertionError(f"float32 training launches {train_launches}")
    n_steps = len(losses)
    dw_row = tf32_dw_rows(rec, train_launches, lib_rows,
                          "training, float32 (phase 8b)", n_steps)
    dw_row.update(train_median_step_s=median,
                  train_bf16_median_step_s=bf16_step_s)
    tf32_dx_fields(rec, row, n_steps)
    row["train_launches_per_step"] = train_launches["subm_conv_tf32"] / n_steps
    log(f"  phase 8b: {time.time() - t0:.1f} s")


def profile_phase(trace_dir):
    """Phase 12: ``tools/profile_model.py`` on the plot at full width, bf16,
    with the trace of one warm forward, and ``tools/profile_step.py
    --train`` with the trace of one warm training step; counts zeroed just
    before.  A kernel conv row that disagrees with the plain conv fails the
    phase inside the tool.  Returns the numbers PERF.md's host table
    reads."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.tools import profile_model, profile_step

    t0 = time.time()
    _cuda.reset_launches()
    model = profile_model.main(["--bf16", "--trace", trace_dir])
    step = profile_step.main(["--train", "--bf16", "--trace", trace_dir])
    launches = dict(_cuda.LAUNCHES)
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "subm_conv",
                        "subm_conv_dw_wgmma") if launches[k] == 0]
    if zero:
        raise AssertionError(f"phase 12: kernels not launched: {zero}")

    def parts(tr):
        keep = ("parts", "span_split", "syncs", "sync_total", "window_ms",
                "device_busy_ms", "device_idle_share", "device_events")
        return dict({k: tr[k] for k in keep}, ops=tr["ops"][:8])

    summary = {
        "card": model["card"], "forward_ms": model["forward_ms"],
        "mfu": model["mfu"], "voxelize_ms": model["voxelize_ms"],
        "plans_ms": model["plans_ms"],
        "levels": [{k: r[k] for k in ("level", "v", "c", "routed_ms",
                                      "simt_ms", "plain_ms")}
                   for r in model["levels"]],
        "forward_trace": parts(model["trace"]),
        "first_step_s": step["first_step_s"],
        "median_step_s": step["median_step_s"],
        "step_trace": parts(step["trace"])}
    log(f"profile: {json.dumps(summary)}")
    log(f"  launches {json.dumps(launches)}; phase 12: "
        f"{time.time() - t0:.1f} s")
    return summary


def log_plot(what, res, wall, launches, forwards):
    log(f"{what}: {wall:.2f} s, n_points {res['n_points']}, n_trees "
        f"{res['n_trees']}")
    log(f"  stage seconds {json.dumps(res['stage_seconds'])}")
    log(f"  model forward: {len(forwards.host_s)} call(s), "
        f"{sum(forwards.device_ms()):.1f} ms between CUDA events on the "
        f"card's stream, {sum(forwards.host_s):.3f} s on the host, inside "
        f"an inference stage of "
        f"{res['stage_seconds'].get('inference', float('nan')):.3f} s")
    log(f"  launches {json.dumps(launches)}")


def cold_warm(cold, warm):
    """The first run of the main path (recorder installed) and the second
    (none), side by side."""
    (rc, wc, _, fc), (rw, ww, _, fw) = cold, warm
    log(f"plot cold / warm: wall {wc:.2f} / {ww:.2f} s, model forward "
        f"{sum(fc.device_ms()):.1f} / {sum(fw.device_ms()):.1f} ms between "
        f"CUDA events, {sum(fc.host_s):.3f} / {sum(fw.host_s):.3f} s on the "
        f"host")
    for stage in rc["stage_seconds"]:
        log(f"  {stage}: {rc['stage_seconds'][stage]} / "
            f"{rw['stage_seconds'].get(stage)} s")


def hdbscan_plot(path):
    """Phase 3c: the plot in the default grouping mode, warm; returns
    (result, the HDBSCAN candidates, route).  ``hdbscan_cluster`` is
    wrapped where ``pipeline/instances.py`` calls it, to read its route and
    keep its input: measurement only."""
    import numpy as np

    import treelearn_tpu_torch.pipeline.instances as inst
    from treelearn_tpu_torch.ops.cluster import KNN_LOG

    calls = []
    inner = inst.hdbscan_cluster

    def traced(points_xy, *args, **kw):
        info = {}
        t0 = time.time()
        out = inner(points_xy, *args, log=info, **kw)
        calls.append((np.asarray(points_xy, np.float32)[:, :2].copy(),
                      info["route"], time.time() - t0))
        return out

    inst.hdbscan_cluster = traced
    try:
        res, wall, launches, forwards = run_plot(path, use_hdbscan=True,
                                                 save_pointwise=True)
    finally:
        inst.hdbscan_cluster = inner
    log_plot("hdbscan-mode plot (warm, use_hdbscan: true)", res, wall,
             launches, forwards)
    (pts, route, seconds), = calls
    log(f"  hdbscan_cluster: {len(pts)} candidates, route {route} "
        f"({'eps-ladder on the card' if route == 'ladder' else 'host'}), "
        f"{seconds:.3f} s; limit TL_HDBSCAN_DEVICE_MAX "
        f"{os.environ.get('TL_HDBSCAN_DEVICE_MAX', '50000 (default)')}")
    log(f"  kernel 5 launches in this run: {launches['cc']}"
        + (" (expected none: the host route)" if route != "ladder" else ""))
    for call in KNN_LOG:
        log(f"  knn route {call.route}: {call.n_refs} refs, "
            f"{call.n_queries} queries")
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "vert")
            if launches[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched in HDBSCAN mode: {zero}")
    if res["n_trees"] <= 0:
        raise AssertionError("HDBSCAN mode found no tree")
    return res, pts, route


def ladder_phase(what, pts, host_route=False):
    """Phase 3d on one input: the eps-ladder on the card with the device
    limit lifted; its rows against the plain version's.  Returns the
    numbers kernel 5's row reports."""
    import numpy as np
    import torch

    import treelearn_tpu_torch.ops.cc as cc
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.hdbscan import (_level_components,
                                                 hdbscan_cluster)

    kept = os.environ.get("TL_HDBSCAN_DEVICE_MAX")

    def limit(value):
        if value is None:
            os.environ.pop("TL_HDBSCAN_DEVICE_MAX", None)
        else:
            os.environ["TL_HDBSCAN_DEVICE_MAX"] = value

    info, problems = {}, []
    try:
        limit(str(1 << 30))
        _cuda.set_recorder(lambda name, args: problems.append(
            args["problem"]) if name == "cc" else None)
        _cuda.reset_launches()
        t0 = time.time()
        labels = hdbscan_cluster(pts, min_cluster_size=50, n_levels=32,
                                 device=CARD, log=info)
        wall = time.time() - t0
        launches = _cuda.LAUNCHES["cc"]
    finally:
        _cuda.set_recorder(None)
        limit(kept)
    levels_active = sum(a > 0 for a in info["active"])
    n_clusters = len(np.unique(labels[labels >= 1]))
    log(f"ladder {what}: {len(pts)} points, route {info['route']}, "
        f"{wall:.3f} s, {n_clusters} clusters")
    log(f"  core distances (host cKDTree, exact) {info['core_s']:.3f} s")
    log(f"  ladder {info['ladder_s']:.3f} s, condense/extract "
        f"{info['condense_s']:.3f} s")
    log(f"  kernel 5 launches {launches} (levels with active points: "
        f"{levels_active} of {len(info['active'])})")
    log(f"  active points per level {info['active']}")
    log(f"  points the pass saw per level (representatives where "
        f"coarsened) {info['reps']}")
    if info["route"] != "ladder" or launches == 0 \
            or launches != levels_active or len(problems) != launches:
        raise AssertionError(f"ladder {what}: route {info['route']}, "
                             f"{launches} launches for {levels_active} "
                             "levels")
    # each level's launch again, timed and against the plain version
    ms = plain_ms = bound_ms = 0.0
    for p in problems:
        t0 = time.time()
        want = cc.found_bits_plain(p)
        torch.cuda.synchronize()
        plain_ms += (time.time() - t0) * 1e3
        if not torch.equal(cc.found_bits(p), want):
            raise AssertionError(f"ladder {what}: found bits differ at "
                                 f"N={p.pts.shape[0]}")
        ms += cuda_ms(lambda: cc.found_bits(p), reps=3, warmup=1)
        n, c = p.pts.shape[0], p.cell_keys.shape[0]
        bound_ms += bound(8 * n + 4 * n + 28 * c + 12 * p.items.shape[0])[0]
    del problems
    log(f"  kernel 5 over the {launches} levels: {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes), plain (unpruned walk) {plain_ms:.1f} "
        f"ms; found bits exact at every level")
    kernel = cc.found_bits
    cc.found_bits = lambda p: cc.found_bits_plain(p, banded=True)
    try:
        t0 = time.time()
        rows = _level_components(pts, info["core_d"], info["eps_levels"],
                                 device=CARD)
        plain_s = time.time() - t0
    finally:
        cc.found_bits = kernel
    same = np.array_equal(rows, info["levels"])
    log(f"  rows with the plain found bits ({plain_s:.3f} s): "
        f"{'equal' if same else 'DIFFERENT'} ({rows.shape[0]} x "
        f"{rows.shape[1]})")
    if not same:
        raise AssertionError(f"ladder {what}: kernel and plain rows differ "
                             f"on {int((rows != info['levels']).sum())} "
                             "entries")
    out = dict(points=len(pts), launches=launches, seconds=wall,
               core_s=info["core_s"], ladder_s=info["ladder_s"],
               condense_s=info["condense_s"], ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms)
    if host_route:
        try:
            limit("0")
            t0 = time.time()
            host = hdbscan_cluster(pts, min_cluster_size=50, device=CARD)
            host_s = time.time() - t0
        finally:
            limit(kept)
        ari = adjusted_rand(host, labels)
        log(f"  host route (hdbscan_cluster_large) {host_s:.3f} s, "
            f"{len(np.unique(host[host >= 1]))} clusters, ARI against the "
            f"ladder {ari:.4f}")
        out.update(host_s=host_s, host_ari=ari)
    return out, labels


def eval_phase(tmp, res, gt_path):
    """Phase 3e: the evaluation protocol on 3c's output, card and CPU."""
    import numpy as np

    from treelearn_tpu_torch.config import get_config
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.cluster import KNN_LOG
    from treelearn_tpu_torch.tools.evaluate import evaluate
    from treelearn_tpu_torch.train.selftrain import (
        detection_f1_from_pointwise, segmentation_partition_summary)

    pw = osp.join(res["results_dir"], "pointwise_results",
                  "pointwise_results.npz")
    t0 = time.time()
    f1 = detection_f1_from_pointwise(pw)
    part = segmentation_partition_summary(pw)
    log(f"eval (random weights: smoke values, not quality): pointwise "
        f"detection {json.dumps(f1)}, partitions {json.dumps(part)}, "
        f"{time.time() - t0:.2f} s")
    out = {}
    for dev in (CARD, "cpu"):
        cfg = get_config(osp.join(REPO, "configs", "evaluation",
                                  "evaluate.yaml"))
        cfg.paths.pred_forest_path = res["output_path"]
        cfg.paths.gt_forest_path = gt_path
        cfg.work_dir = osp.join(tmp, f"eval_{dev}")
        del KNN_LOG[:]
        _cuda.reset_launches()
        t0 = time.time()
        r = evaluate(cfg, device=dev)
        secs = time.time() - t0
        det, seg = r["detection_results"], r["segmentation_results"]
        summary = {k: det[k] for k in ("f1_score", "completeness",
                                       "omission_error_rate",
                                       "commission_error_rate")}
        summary.update(precision=seg["precision"], recall=seg["recall"],
                       coverage=seg["iou"])
        routes = [c.route for c in KNN_LOG]
        log(f"  tools/evaluate on {dev}: {secs:.2f} s, k-NN route "
            f"{routes}, kernel 6 launches {_cuda.LAUNCHES['knn']}; "
            f"{json.dumps(summary)}")
        out[dev] = (summary, load_data(osp.join(
            cfg.work_dir, "pred_forest_propagated_to_gt_pointcloud.las")))
    a, b = out[CARD][1], out["cpu"][1]
    bad = np.flatnonzero(a[:, 3] != b[:, 3])
    ties = 0
    if len(bad):
        from scipy.spatial import cKDTree

        pred = load_data(res["output_path"])
        d, _ = cKDTree(pred[:, :3]).query(a[bad, :3], k=6)
        ties = int((d[:, 5] - d[:, 4] <= 1e-6 * d[:, 5]).sum())
    log(f"  card vs CPU: {len(bad)} of {len(a)} propagated labels differ, "
        f"{ties} on float-equal distance ties")
    if ties < len(bad) or len(bad) > 1e-4 * len(a):
        raise AssertionError(f"evaluate: {len(bad)} propagated labels "
                             f"differ ({ties} ties)")
    if not len(bad) and out[CARD][0] != out["cpu"][0]:
        raise AssertionError("evaluate: card and CPU summaries differ")
    return out[CARD][0]


def smoke_phase():
    """Phase 3f: run_gpu_smoke, every check true."""
    from treelearn_tpu_torch.utils.smoke import run_gpu_smoke

    t0 = time.time()
    out = run_gpu_smoke()
    nums = {k: v for k, v in out.items()
            if k not in ("checks", "errors", "passed", "failed")}
    log(f"run_gpu_smoke: {out['passed']} passed, {out['failed']} failed in "
        f"{time.time() - t0:.2f} s; checks {json.dumps(out['checks'])}; "
        f"{json.dumps(nums)}")
    if out["failed"] or not all(out["checks"].values()):
        raise AssertionError(f"run_gpu_smoke: {json.dumps(out['errors'])}")


def datagen_phase(tmp, data):
    """Phase 9: the plot through gen_val_data and gen_train_data on the
    card with the shipped configs (crops cut to ``DATAGEN_CROPS``), counts
    zeroed just before; returns (launches, the whole-plot verticality
    problem, the tiles directory, the crops directory)."""
    import numpy as np

    from treelearn_tpu_torch.config import get_config
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.tools.gen_train_data import generate_random_crops
    from treelearn_tpu_torch.tools.gen_val_data import generate_val_tiles

    root = osp.join(tmp, "datagen")
    val_cfg = get_config(osp.join(REPO, "configs", "data_gen",
                                  "gen_val_data.yaml"))
    val_cfg.forest_path = osp.join(root, "val", "forest", "plot.npz")
    train_cfg = get_config(osp.join(REPO, "configs", "data_gen",
                                    "gen_train_data.yaml"))
    log(f"datagen: n_samples_total cut from {train_cfg.n_samples_total} to "
        f"{DATAGEN_CROPS}")
    train_cfg.base_dir = osp.join(root, "train")
    train_cfg.n_samples_total = DATAGEN_CROPS
    for path in (val_cfg.forest_path,
                 osp.join(root, "train", "forests", "plot.npz")):
        os.makedirs(osp.dirname(path))
        np.savez(path, points=data[:, :3].astype(np.float32),
                 labels=data[:, 3])
    rec = Recorder()
    _cuda.set_recorder(rec)
    _cuda.reset_launches()
    t0 = time.time()
    val = generate_val_tiles(val_cfg, device=CARD)
    t_val = time.time() - t0
    t0 = time.time()
    train = generate_random_crops(train_cfg, device=CARD)
    t_train = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    _cuda.set_recorder(None)
    p = rec.inputs[("vert",)]["problem"]
    stages = lambda d: {k: round(v, 3) for k, v in d.items()}  # noqa: E731
    log(f"  gen_val_data {t_val:.2f} s, {val['tiles']} tiles, stage seconds "
        f"{json.dumps(stages(val['stage_seconds']))}")
    log(f"  gen_train_data {t_train:.2f} s, {json.dumps(train['crops'])} "
        f"crops, stage seconds {json.dumps(stages(train['stage_seconds']))}")
    log(f"  whole-plot verticality: {p.queries.shape[0]} queries, "
        f"{p.refs4.shape[0]} refs, table {p.table}; launches "
        f"{json.dumps(launches)}")
    if launches["vert"] == 0:
        raise AssertionError("datagen: kernel 4 not launched")
    if not val["tiles"] or not sum(train["crops"].values()):
        raise AssertionError("datagen: no tiles or no crops written")
    return (launches, p, osp.join(val["tiles_dir"], "npz"),
            osp.join(root, "train", "random_crops", "npz"))


def check_vert_whole(p, launches, lib_rows):
    """Kernel 4 on the data tools' whole-plot problem against its plain
    version: the new row of the ``kernels`` line."""
    from treelearn_tpu_torch.ops.vert import moments

    _, err, far, mom_err, plain, b, by, pairs = vert_against_plain(p)
    ms = cuda_ms(lambda: moments(p))
    log(f"  vert whole plot Q={p.queries.shape[0]}: counts exact, moments "
        f"within {mom_err:.1e} of scale, max |dvert| {err:.2e} ({far} > "
        f"1e-3), kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({by}), {pairs:.0f} in-radius pairs, {p.items.shape[0]} work items")
    lib_rows.append(dict(
        name="vert", problem="whole_plot", route="cuda",
        source="treelearn_tpu_torch/csrc/vert.cu",
        replaces="treelearn_tpu/ops/pallas_vert.py:137",
        launches=launches["vert"], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None,
        queries=int(p.queries.shape[0])))


def dp_train_rank(init_method, cfg_path, work, device):
    """One rank of phase 10a: ``tools/train.py --dist`` on ``device`` over
    gloo;
    its step seconds and losses, launch counts, checkpoints and final
    state go to files in ``work``."""
    import torch

    import treelearn_tpu_torch.model.checkpoint as ck
    import treelearn_tpu_torch.parallel as par
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.tools import train

    os.chdir(work)
    steps, saved = [], []
    make, save = par.make_dp_train_step, ck.checkpoint_save

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(batch):
            t0 = time.time()
            loss, loss_dict = step(batch)
            steps.append((time.time() - t0, float(loss)))
            return loss, loss_dict
        return timed

    par.make_dp_train_step = timed_make
    ck.checkpoint_save = lambda *a, **k: saved.append(save(*a, **k))
    _cuda.reset_launches()
    model = train.main(["--config", cfg_path, "--dist", "--dist_url",
                        init_method, "--device", device])
    rank = int(os.environ["RANK"])
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               osp.join(work, f"state{rank}.pt"))
    with open(osp.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": dict(_cuda.LAUNCHES), "steps": steps,
                   "saved": saved}, f)


def dp_train_phase(tmp, crops_dir, tiles_dir):
    """Phase 10a: ``tools/train.py --dist`` as 2 gloo ranks on the card at
    full width on phase 9's crops and tiles, one epoch, validation on."""
    import numpy as np
    import torch
    import yaml

    from treelearn_tpu_torch.config import config_to_dict, get_config
    from treelearn_tpu_torch.parallel.launch import spawn_ranks

    work = osp.join(tmp, "dp_train")
    os.makedirs(work)
    cfg = get_config(osp.join(REPO, "configs", "training", "train.yaml"))
    cfg.dataset_train.data_root = crops_dir
    cfg.dataset_test.data_root = tiles_dir
    cfg.epochs = 1
    cfg.validation_frequency = cfg.save_frequency = 1
    shipped = cfg.examples_per_epoch
    cfg.examples_per_epoch = DP_EXAMPLES
    cfg_path = osp.join(work, "train_dp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
    t0 = time.time()
    spawn_ranks(dp_train_rank, DP_WORLD, osp.join(work, "store"), cfg_path,
                work, CARD, timeout=600)
    wall = time.time() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(osp.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    states = [torch.load(osp.join(work, f"state{r}.pt"))
              for r in range(DP_WORLD)]
    log(f"dp train: {DP_WORLD} gloo ranks on one card, {wall:.2f} s with "
        f"process start, {len(os.listdir(crops_dir))} crops, "
        f"{len(os.listdir(tiles_dir))} validation tiles, examples_per_epoch "
        f"cut from {shipped} to {DP_EXAMPLES}")
    for r, rk in enumerate(ranks):
        secs = np.asarray([s for s, _ in rk["steps"]])
        losses = np.asarray([x for _, x in rk["steps"]])
        log(f"  rank {r}: {len(secs)} steps, first {secs[0]:.4f} s, median "
            f"of the others {np.median(secs[1:]):.4f} s, losses "
            f"{[round(float(x), 3) for x in losses]}, launches "
            f"{json.dumps(rk['launches'])}")
        if len(secs) < 4 or not np.isfinite(losses).all():
            raise AssertionError(f"dp train rank {r}: steps {rk['steps']}")
        zero = [k for k in ("rulebook", "subm_conv_wgmma",
                            "subm_conv_dw_wgmma") if rk["launches"][k] == 0]
        if zero:
            raise AssertionError(f"dp train rank {r}: not launched {zero}")
    if len({tuple(x for _, x in rk["steps"]) for rk in ranks}) != 1:
        raise AssertionError("dp train: the ranks' global losses differ")
    differ = [k for k, v in states[0].items() if not torch.equal(v,
                                                                 states[1][k])]
    ckpts = [f for f in os.listdir(osp.join(work, "work_dirs", "train_dp"))
             if f.endswith(".pth")]
    log(f"  parameters bit-equal across ranks: {not differ}; checkpoints "
        f"written: rank 0 {ranks[0]['saved']}, rank 1 {ranks[1]['saved']}")
    if differ:
        raise AssertionError(f"dp train: ranks differ in {differ[:5]}")
    if ckpts != ["epoch_1.pth"] or len(ranks[0]["saved"]) != 1 or any(
            rk["saved"] for rk in ranks[1:]):
        raise AssertionError(f"dp train: checkpoints {ckpts}, "
                             f"{[rk['saved'] for rk in ranks]}")


def dp_step_check(tmp):
    """Phase 10b: one float32 DP step at world size 1 on nccl against
    ``make_train_step`` on the same card, seed weights and batch."""
    import torch
    import torch.distributed as dist

    from treelearn_tpu_torch.data.dataset import collate_dp, collate_padded
    from treelearn_tpu_torch.parallel import init_dp, make_dp_train_step
    from treelearn_tpu_torch.train.loop import make_train_step

    sample = step_sample(tmp)
    os.makedirs(osp.join(tmp, "dp_step"))
    group = init_dp("nccl", "file://" + osp.join(tmp, "dp_step", "store"),
                    rank=0, world_size=1, device=CARD)
    try:
        dp, launches = one_step(
            lambda m, o, s: make_dp_train_step(
                m, o, s, group, batch_size=1, compute_dtype=torch.float32,
                grad_norm_clip=True), collate_dp([sample], 1, 1), CARD)
    finally:
        dist.destroy_process_group()
    single, _ = one_step(
        lambda m, o, s: make_train_step(
            m, o, s, batch_size=1, compute_dtype=torch.float32,
            grad_norm_clip=True, device=CARD), collate_padded([sample]), CARD)
    compare_steps(dp, single, f"dp step world 1 ({group.backend}) vs "
                              f"make_train_step")
    log(f"  launches {json.dumps(launches)}")


def dp_pipeline_rank(init_method, forest, out, device):
    """One rank of phase 10c: the pipeline with ``dist: true`` on
    ``device`` over gloo; rank 0 writes its summary and wall seconds."""
    import torch.distributed as dist

    from treelearn_tpu_torch.parallel import init_dp
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    group = init_dp("gloo", init_method, device=device)
    t0 = time.time()
    res = run_treelearn_pipeline(dp_pipeline_config(forest), device=device)
    wall = time.time() - t0
    with open(osp.join(out, f"pipeline{group.rank}.json"), "w") as f:
        json.dump({"wall": wall, "res": None if res is None else {
            k: res[k] for k in ("n_trees", "n_points", "results_dir",
                                "stage_seconds")}}, f)
    dist.destroy_process_group()


def dp_pipeline_config(forest):
    config = pipeline_config(forest, save_pointwise=True)
    config.whole_plot = False
    config.dist = True
    return config


def dp_pipeline_phase(tmp, data):
    """Phase 10c: the pipeline with ``dist: true, whole_plot: false`` as 2
    gloo ranks on the card against the same config single-process on the
    card (no process group: the single path)."""
    import numpy as np

    from treelearn_tpu_torch.parallel.launch import spawn_ranks
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    forests = {}
    for mode in ("single", "dist"):
        d = osp.join(tmp, f"dp_pipeline_{mode}", "plot", "forest")
        os.makedirs(d)
        forests[mode] = osp.join(d, "smoke.npz")
        np.savez(forests[mode], points=data[:, :3].astype(np.float32),
                 labels=data[:, 3])
    t0 = time.time()
    single = run_treelearn_pipeline(dp_pipeline_config(forests["single"]),
                                    device=CARD)
    wall_single = time.time() - t0
    out = osp.dirname(forests["dist"])
    t0 = time.time()
    spawn_ranks(dp_pipeline_rank, DP_WORLD, osp.join(out, "store"),
                forests["dist"], out, CARD, timeout=600)
    wall_spawn = time.time() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(osp.join(out, f"pipeline{r}.json")) as f:
            ranks.append(json.load(f))
    dist_res = ranks[0]["res"]
    log(f"dp pipeline: {len(data)} points, tile mode; single process {wall_single:.2f} s, {DP_WORLD} gloo "
        f"ranks {ranks[0]['wall']:.2f} s on rank 0 ({wall_spawn:.2f} s with "
        f"process start); trees {single['n_trees']} / {dist_res['n_trees']}")
    log(f"  stage seconds single {json.dumps(single['stage_seconds'])}")
    log(f"  stage seconds rank 0 {json.dumps(dist_res['stage_seconds'])}")
    if any(rk["res"] is not None for rk in ranks[1:]):
        raise AssertionError("dp pipeline: a rank other than 0 returned")
    a, b = (np.load(osp.join(d, "pointwise_results", "pointwise_results.npz"))
            for d in (single["results_dir"], dist_res["results_dir"]))
    worst = 0.0
    for k in ("semantic_prediction_logits", "offset_predictions", "coords"):
        if a[k].shape != b[k].shape:
            raise AssertionError(f"dp pipeline: {k} shapes {a[k].shape} "
                                 f"{b[k].shape}")
        worst = max(worst, float(np.abs(a[k] - b[k]).max()))
    log(f"  pointwise arrays within {worst:.1e}; instance labels equal: "
        f"{np.array_equal(a['instance_preds'], b['instance_preds'])}")
    if (worst > 1e-6 or single["n_trees"] != dist_res["n_trees"]
            or not np.array_equal(a["instance_preds"], b["instance_preds"])):
        raise AssertionError("dp pipeline: dist run differs from single")


def demo_phase(tmp):
    """Phase 11: ``python -m treelearn_tpu_torch.tools.demo`` with its
    defaults on the card."""
    d = osp.join(tmp, "demo")
    os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "treelearn_tpu_torch.tools.demo"],
                         cwd=d, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"demo exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    trees = [int(x.split(":")[1]) for x in lines if x.startswith("trees found")]
    results = osp.join(d, "demo_workdir", "plot", "results")
    cloud = osp.join(results, "full_forest", "demo_forest.laz")
    per_tree = [f for _, _, fs in os.walk(osp.join(results, "individual_trees"))
                for f in fs]
    log(f"demo: exit 0 in {wall:.2f} s with process start; "
        f"{' | '.join(x.strip() for x in lines if x.startswith(('points', 'trees', 'wall', 'device')))}; "
        f"{len(per_tree)} per-tree files")
    if not trees or trees[0] < 1 or not osp.isfile(cloud) or not per_tree:
        raise AssertionError(f"demo: trees {trees}, cloud {osp.isfile(cloud)}, "
                             f"{len(per_tree)} per-tree files")


def bench_phase(tmp):
    """Phase 13: the bench as a user runs it, on the card, at a reduced
    budget; returns its JSON line."""
    import torch

    home, work = osp.join(tmp, "bench_home"), osp.join(tmp, "bench")
    os.makedirs(home)
    os.makedirs(work)
    env = dict(os.environ, HOME=home, BENCH_TRAIN_STEPS="200",
               BENCH_TRAIN_CROPS="8", BENCH_STEADY_PASSES="1",
               TL_GPU_SMOKE="0", BENCH_BUDGET_S="300",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.bench"], cwd=work,
        env=env, capture_output=True, text=True, timeout=480)
    wall = time.time() - t0
    if out.returncode != 0 or not out.stdout.strip():
        raise AssertionError(f"bench exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"bench: {json.dumps(line)}")
    cold = [x for x in out.stderr.splitlines() if "cold pass: launches" in x]
    launches = (json.loads(cold[0].split("launches ", 1)[1].split("}")[0]
                           + "}") if cold else {})
    bad = [d for d in line.get("degraded", [])
           if d.startswith(("exception_", "watchdog_", "interrupted_"))]
    missing = [k for k in ("detection_f1", "hard_detection_f1",
                           "hdbscan_detection_f1", "model_mfu")
               if line.get(k) is None]
    zero = [k for k in ("rulebook", "subm_conv_wgmma", "vert")
            if not launches.get(k)]
    log(f"  bench exit 0 in {wall:.1f} s with process start; cold pass "
        f"launches {json.dumps(launches)}; trained steps "
        f"{line.get('trained_steps')}; F1 easy / hard / hdbscan "
        f"{line.get('detection_f1')} / {line.get('hard_detection_f1')} / "
        f"{line.get('hdbscan_detection_f1')}; model_mfu "
        f"{line.get('model_mfu')}; degraded {line.get('degraded')}")
    if (bad or missing or zero
            or line.get("device") != torch.cuda.get_device_name(0)
            or not 0 < (line.get("model_mfu") or 0) <= 1):
        raise AssertionError(f"bench: degraded {bad}, missing {missing}, "
                             f"cold pass kernels not launched {zero}, device "
                             f"{line.get('device')}, model_mfu "
                             f"{line.get('model_mfu')}\n"
                             f"{out.stderr[-3000:]}")
    return line


def tool_env(**extra):
    return dict(os.environ, **extra, PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in [os.environ.get("PYTHONPATH")] if x]))


def quality_phase(tmp, dump):
    """Phase 14: the oracle ceiling card vs CPU, hard_quality at a tiny
    recipe, profile_cluster on phase 3's dump, the five stages."""
    import numpy as np

    from treelearn_tpu_torch.eval.quality import KEYS
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.tools.oracle_ceiling import hard_forest, run_oracle
    from treelearn_tpu_torch.tools.profile_cluster import profile_cluster

    t_phase = time.time()
    # (a) the oracle ceiling, card against the CPU port
    data = hard_forest()
    _cuda.reset_launches()
    t0 = time.time()
    card = run_oracle(data, device=CARD)
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    t0 = time.time()
    cpu = run_oracle(data, device="cpu")
    cpu_wall = time.time() - t0
    ari = adjusted_rand(card["labels"], cpu["labels"])
    log(f"quality (a) oracle ceiling: {card['n_points']} points, "
        f"{card['n_voxels']} voxels, {card['n_trees']} trees; card F1 "
        f"{card['f1']} (completeness {card['completeness']}, commission "
        f"{card['commission']}, {card['n_pred']} preds / {card['n_gt']}) in "
        f"{wall:.2f} s, CPU F1 {cpu['f1']} in {cpu_wall:.2f} s; ARI card vs "
        f"CPU {ari:.6f}")
    log(f"  card stage seconds {json.dumps(card['stage_seconds'])}; k-NN "
        f"{json.dumps(card['knn'])}; launches {json.dumps(launches)}")
    n_card, n_cpu = (len(np.unique(x["labels"])) for x in (card, cpu))
    zero = [k for k in ("vert", "cc") if not launches[k]]
    if zero or ari < 0.999 or n_card != n_cpu:
        raise AssertionError(f"oracle: kernels not launched {zero}, ARI "
                             f"{ari}, labels {n_card} vs {n_cpu}")
    del data, card, cpu

    # (b) hard_quality at a tiny recipe, as a user runs it
    home = osp.join(tmp, "hq_home")
    os.makedirs(home)
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.hard_quality"]
        + QUALITY_RECIPE, cwd=home, env=tool_env(HOME=home),
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or not out.stdout.strip():
        raise AssertionError(f"hard_quality exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [k for k in KEYS
           if not isinstance(line.get(k), (int, float))
           or not np.isfinite(line[k])]
    log(f"quality (b) hard_quality {' '.join(QUALITY_RECIPE)}: exit 0 in "
        f"{time.time() - t0:.1f} s with process start; {json.dumps(line)}")
    for x in out.stderr.splitlines():
        if "launches" in x:
            log(f"  {x.strip()}")
    if bad:
        raise AssertionError(f"hard_quality: keys not finite {bad}")

    # (c) profile_cluster on phase 3's dump
    _cuda.reset_launches()
    prof = profile_cluster(dump, device=CARD)
    log(f"quality (c) profile_cluster on phase 3's dump: "
        f"{prof['n_points']} points, {prof['n_candidates']} candidates, "
        f"{prof['n_clusters']} clusters, {prof['n_remaining']} remaining; "
        f"seconds {json.dumps(prof['seconds'])}; k-NN "
        f"{json.dumps(prof['knn'])}; launches {json.dumps(_cuda.LAUNCHES)}")
    if not (prof["labels_equal"] and prof.get("dump_equal")):
        raise AssertionError(f"profile_cluster: labels equal to "
                             f"get_instances {prof['labels_equal']}, to "
                             f"phase 3's {prof.get('dump_equal')}")

    # (d) the five stages on the card
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.five_stage",
         "--work", osp.join(tmp, "five_stage"), "--samples", "24"],
        cwd=tmp, env=tool_env(), capture_output=True, text=True,
        timeout=600)
    lines = out.stdout.splitlines()
    for x in lines:
        if x.startswith(("[PASS", "[FAIL", "notebook", "FIVE-STAGE")):
            log(f"  {x}")
    passed = [s for s in ("gen_train_data", "gen_val_data", "train",
                          "pipeline", "evaluate")
              if any(x.startswith("[PASS") and x.endswith(f"] {s}")
                     for x in lines)]
    log(f"quality (d) five_stage: exit {out.returncode} in "
        f"{time.time() - t0:.1f} s, {len(passed)} of 5 stages PASS")
    if out.returncode != 0 or len(passed) != 5:
        raise AssertionError(f"five_stage:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    log(f"  phase 14: {time.time() - t_phase:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-trees", type=int, default=48)
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--points-per-tree", type=int, default=16000)
    ap.add_argument("--ground-points", type=int, default=200000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None,
                    help="where phase 12 writes its two chrome traces "
                         "(default: the run's temporary directory)")
    args = ap.parse_args()

    import numpy as np
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
        path, data, positions = write_plot(
            tmp, args.seed, n_trees=args.n_trees, extent=args.extent,
            points_per_tree=args.points_per_tree,
            ground_points=args.ground_points)
        log(f"plot: {len(data)} points, {args.n_trees} trees, "
            f"{args.extent} m")
        config = pipeline_config(path)

        rec = Recorder()
        _cuda.set_recorder(rec)
        cold = run_plot(path, save_pointwise=True)
        _cuda.set_recorder(None)
        res, _, launches, _ = cold
        # phase 14c reads this dump; later phases rewrite the results dir
        dump = osp.join(tmp, "phase3_pointwise_results.npz")
        shutil.copy(osp.join(res["results_dir"], "pointwise_results",
                             "pointwise_results.npz"), dump)
        log_plot("pipeline (cold: first run, recorder installed)", *cold)
        mt = res["model_timings"]
        log(f"  voxels per level {[int(x) for x in mt['n_vox_levels']]}, "
            f"rule nnz per level {[int(x) for x in mt['rule_nnz']]}")
        for call in KNN_LOG:
            log(f"  knn route {call.route}: {call.n_refs} refs, "
                f"{call.n_queries} queries")
        log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        zero = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched on the main path: {zero}")
        from treelearn_tpu_torch.io.pointcloud import load_data

        out = load_data(res["output_path"])
        if out.shape != (len(data), 4) or not torch.isfinite(
                torch.from_numpy(out)).all():
            raise AssertionError(f"full-cloud output shape {out.shape}")
        # the same run again, warm and with no recorder
        warm = run_plot(path)
        log_plot("pipeline (warm: second run, no recorder)", *warm)
        log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        zero = [k for k in MAIN_PATH_KERNELS if warm[2][k] == 0]
        if zero or warm[0]["n_trees"] != res["n_trees"]:
            raise AssertionError(f"warm run: kernels not launched {zero}, "
                                 f"{warm[0]['n_trees']} trees")
        cold_warm(cold, warm)
        bf16_plot = (warm[1], sum(warm[3].device_ms()))
        del warm

        # 3b. the banded k-NN route on the main path's own problem
        knn_launches, knn_rec = knn_phase(rec)

        # 3c. the default grouping mode; 3d. its eps-ladder on the card;
        # 3e. the evaluation protocol; 3f. the kernel smoke
        from treelearn_tpu_torch.utils.smoke import knot_layout, knot_recovery

        res_hd, cand, _ = hdbscan_plot(path)
        ladder = {}
        ladder["plot_candidates"], _ = ladder_phase(
            "(a) the plot's HDBSCAN candidates", cand, host_route=True)
        knots = knot_layout()
        ladder["knots_220k"], knot_labels = ladder_phase(
            "(b) the 220k knot layout", knots)
        good, n_clusters, ok = knot_recovery(knot_labels, 96)
        log(f"  knots recovered {good} of 96, {n_clusters} clusters")
        if not ok:
            raise AssertionError("ladder (b): knots not recovered")
        del cand, knots, knot_labels
        eval_phase(tmp, res_hd, path)
        smoke_phase()

        # 4. kernels against their plain versions, main-path inputs
        rows = []
        check_rulebook(rec, rows)
        check_subm_conv(rec, rows)
        check_vert(rec, rows)
        from treelearn_tpu_torch.data.synthetic import trained_like_xy

        check_cc(rec, rows, trained_like_xy(data, positions),
                 float(config.grouping.tau_group))
        for r in rows:
            r["launches"] = launches[r["name"]]
            if r.get("problem") == "plot":
                r["ladder_per_hdbscan_call"] = ladder
        check_knn(knn_rec, rows, knn_launches)
        del rec, knn_rec

        # 5. end-to-end agreement on a small plot, float32
        small_plot_check(tmp)
        # 5b. kernel size 5: the 3xTF32 conv and dW with K = 125 (float32),
        # the bf16 tensor-core ones
        kernel_size5_check(tmp, rows)
        # 5c. bf16 widths that are no multiple of 32: a channels 16 model on
        # the plot and in training
        narrow_phase(tmp, path, rows)

        # 6. training at full width; 7. its backward kernels
        info, train_launches, grad_rec = train_phase(tmp)
        check_grads(grad_rec, rows, train_launches, len(info["losses"]))
        del grad_rec

        # 8. one float32 training step, card against CPU
        train_step_check(tmp)
        # 8b. the float32 route at full width: the plot against the SIMT
        # route, 20 training steps, the 3xTF32 kernels' rows
        float32_phase(tmp, path, bf16_plot,
                      float(np.median(info["step_seconds"][1:])), rows)

        # 9. the data tools on the plot: kernel 4 over every voxel
        dg_launches, vert_whole, tiles_dir, crops_dir = datagen_phase(
            tmp, data)
        check_vert_whole(vert_whole, dg_launches, rows)
        del vert_whole

        # 10. data parallelism: train --dist on 2 ranks, the world-1 step,
        # the pipeline with dist: true on 2 ranks
        dp_train_phase(tmp, crops_dir, tiles_dir)
        dp_step_check(tmp)
        dp_pipeline_phase(tmp, data)

        # 11. the demo, as a user runs it
        demo_phase(tmp)

        # 12. the profilers: stage split, MFU, conv rows, the two traces
        profile_phase(args.trace_dir or osp.join(tmp, "trace"))

        # 13. the bench, as a user runs it, at a reduced budget
        bench_phase(tmp)

        # 14. the quality and toolchain tools
        quality_phase(tmp, dump)

    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
