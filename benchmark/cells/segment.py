"""Segmentation cells: whole plots through
``treelearn_tpu_torch.pipeline.run:run_treelearn_pipeline``, back to back.

Set-up makes the plot and the weights from the seed, builds the model and
runs one pass (the warm-up); the window runs passes until ``seconds`` have
passed and closes at the end of the pass during which they ran out.  Each
pass runs in a fresh directory with the plot linked in, so no pass reads an
earlier pass's voxel or feature cache; the passes' directories are deleted
once the check has read them.

Set-up also runs the plain reference's forward on the plot once (it sets
the semantic bias, below, and its outputs are kept for the check); its
seconds (``reference_s``) are reference work and not the program's set-up,
so ``benchmark/run.py`` takes them out of ``setup_s``.
"""

from __future__ import annotations

import gc
import logging
import os
import shutil
import time

import numpy as np
import torch

from .. import traffic
from ..reference import grouping as ref_grouping
from ..reference.sparse import topology
from ..reference.unet import Net, make_weights
from ..yardstick import trace as ytrace


class _Stages(logging.Handler):
    """Keeps the pipeline's ``stage[...]`` lines with their times."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("stage["):
            self.marks.append((int(record.created * 1e9),
                               msg[6:msg.index("]")]))


def _logger(handler):
    log = logging.getLogger("benchmark.pipeline")
    log.handlers[:] = [handler]
    log.setLevel(logging.INFO)
    log.propagate = False
    return log


class ForwardEvents:
    """CUDA events around every forward of the model (the port's
    ``utils/profiling.py:ForwardTimer`` pattern): measurement only, no
    synchronize."""

    def __init__(self, model):
        self.pairs = []
        self._h = [model.register_forward_pre_hook(self._pre),
                   model.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.append([e, None])

    def _post(self, mod, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs[-1][1] = e

    def remove(self):
        for h in self._h:
            h.remove()

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def host_voxel_cloud(data: np.ndarray):
    """The model's input points as the pipeline states them: the plot
    centred on its mean (float32), rounded to 2 decimals, the centroid of
    each 0.1 m voxel of it (from the minimum corner), rounded to 2
    decimals in float32; and the voxel of every point of the plot."""
    xyz = data[:, :3].astype(np.float64)
    c = (xyz - xyz.mean(0)).astype(np.float32).astype(np.float64)
    c = np.round(c, 2)
    ijk = np.floor((c - c.min(0)) / 0.1).astype(np.int64)
    dims = ijk.max(0) + 1
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    _, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    cen = np.zeros((len(cnt), 3))
    for a in range(3):
        cen[:, a] = np.bincount(inv, weights=c[:, a], minlength=len(cnt))
    cen /= cnt[:, None]
    return np.round(cen.astype(np.float32), 2), inv


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if not os.path.islink(os.path.join(d, f)))


def _sorted_rows(xyz: np.ndarray) -> np.ndarray:
    return np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))


class SegmentCell:
    def __init__(self, cfg: dict, work: dict, seed: int, device, run_dir,
                 config_cls):
        self.cfg, self.work, self.seed = cfg, work, int(seed)
        self.device = device
        self.run_dir = run_dir
        self.config_cls = config_cls
        self.stages = _Stages()
        self.log = _logger(self.stages)
        self.passes = []
        self.n_pass = 0

    # --- set-up -----------------------------------------------------------
    def make_inputs(self):
        """The plot and the weights from the seed.  The semantic head's
        output bias is then set so that the plot's own share of tree points
        is classed as tree by the float32 reference on the whole plot:
        random weights would otherwise class nearly all or nearly none of
        the points as tree, depending on the seed, and the grouping's work
        with them.  The cell keeps the reference's outputs for the check
        (the bias only shifts the logits)."""
        self.data = traffic.make_plot(self.work["plot"], self.seed)
        m = self.cfg["model"]
        self.weights = make_weights(traffic.sub_seed(self.seed, 3),
                                    self.device, m["channels"],
                                    m["num_blocks"])
        t = time.time()
        vox, sem, off = self.reference_outputs()
        self.reference_s = time.time() - t
        share = float((self.data[:, 3] > 0).mean())
        t = float(np.quantile(sem[:, 0].astype(np.float64) - sem[:, 1],
                              1.0 - share))
        b = self.weights["semantic_linear.3.bias"]
        b += torch.tensor([-t / 2, t / 2], device=b.device)
        shift = np.array([-t / 2, t / 2], np.float32)
        self.ref = (vox, sem + shift, off)

    def setup(self):
        from treelearn_tpu_torch.model import TreeLearn

        self.make_inputs()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.plot_path = os.path.join(self.run_dir, "plot.npy")
        np.save(self.plot_path, self.data)
        m = self.cfg["model"]
        self.model = TreeLearn(**m)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.to(self.device)
        warm = self.one_pass(keep=False)
        shutil.rmtree(warm["dir"], ignore_errors=True)

    def config(self, forest_path):
        cfg = {k: v for k, v in self.cfg.items()
               if k not in ("assumed", "notes")}
        cfg.update(self.work.get("pipeline", {}))
        cfg["forest_path"] = forest_path
        return self.config_cls.from_dict(cfg)

    def one_pass(self, keep=True):
        from treelearn_tpu_torch.pipeline.run import run_treelearn_pipeline

        d = os.path.join(self.run_dir, f"pass_{self.n_pass:04d}")
        self.n_pass += 1
        os.makedirs(os.path.join(d, "forest"))
        fp = os.path.join(d, "forest", "plot.npy")
        os.symlink(self.plot_path, fp)
        t0 = time.time()
        res = run_treelearn_pipeline(self.config(fp), model=self.model,
                                     logger=self.log, device=self.device)
        rec = {"dir": d, "seconds": time.time() - t0,
               "laz": os.path.join(res["results_dir"], "full_forest",
                                   "plot.laz"),
               "n_points": len(self.data),
               "stage_seconds": dict(res["stage_seconds"]),
               "model_timings": {k: v for k, v in res["model_timings"].items()
                                 if np.isscalar(v)},
               "dump": os.path.join(res["results_dir"], "pointwise_results",
                                    "pointwise_results.npz")}
        if keep:
            self.passes.append(rec)
        return rec

    # --- window -----------------------------------------------------------
    def window(self, seconds: float, trace: bool):
        fwd = ForwardEvents(self.model) if trace else None
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        self.stages.marks.clear()
        t0 = time.time_ns()
        while True:
            self.one_pass()
            if (time.time_ns() - t0) / 1e9 >= seconds:
                break
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self.ctx = {"window_s": (t1 - t0) / 1e9, "passes": self.passes,
                    "work": self.work, "cfg": self.cfg,
                    "win": (t0, t1)}
        if trace:
            prof.__exit__(None, None, None)
            ev = ytrace.collect(prof)
            del prof
            self.ctx["events"] = ev
            self.ctx["trace"] = ytrace.summarize(ev, t0, t1,
                                                 stages=self.stages.marks)
            self.ctx["forward_ms"] = fwd.ms()
            fwd.remove()
        return self.ctx

    def result(self):
        pts = sum(p["n_points"] for p in self.passes)
        stages = {k: [p["stage_seconds"].get(k) for p in self.passes]
                  for k in self.passes[0]["stage_seconds"]}
        self.info = dict(getattr(self, "info", {}),
                         reference_s=self.reference_s,
                         pass_s=[round(p["seconds"], 3) for p in self.passes],
                         stage_s=stages)
        return {"seg_mpts_per_s": pts / self.ctx["window_s"] / 1e6}

    def attempted(self):
        return len(self.passes)

    def forward_levels(self):
        """[(voxels per level, rule pairs per level, points, forwards)] of
        the window: each of a plot's forwards once a plot."""
        return [(v, nnz, n, len(self.passes)) for v, nnz, n in self.per_plot]

    def release(self):
        del self.model
        gc.collect()
        torch.cuda.empty_cache()

    # --- check ------------------------------------------------------------
    def reference_outputs(self, quant="none"):
        """(sorted voxel-cloud points, semantic logits, offsets) of the
        plain reference on this cell's whole plot; float32 products with
        TF32 off."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._reference_outputs(quant)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _reference_outputs(self, quant):
        vox, inv = host_voxel_cloud(self.data)
        sem, off = self.whole_reference(vox, quant)
        order = _sorted_rows(vox)
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        self.vox_of_point = rank[inv]
        return vox[order], sem[order], off[order]

    def whole_reference(self, vox, quant):
        m = self.cfg["model"]
        ext = vox.max(0).astype(np.float64) - vox.min(0).astype(np.float64)
        vs = float(m["voxel_size"])
        ss = [int(np.ceil((np.ceil(e / vs) + 2) / 64)) * 64 for e in ext]
        with torch.no_grad():
            c = torch.from_numpy(vox).to(self.device)
            n = c.shape[0]
            bid = torch.zeros(n, dtype=torch.long, device=self.device)
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            topo = topology(c, bid, valid, 1, vs, int(m["num_blocks"]), ss)
            v, nnz = topo.counts()
            self.per_plot = [(v, nnz, n)]
            sem, off = Net(self.weights, topo, int(m["num_blocks"]),
                           training=False, quant=quant).forward(valid)
        return sem.cpu().numpy(), off.cpu().numpy()

    def check(self):
        """The numbers compared: the forward of every pass against the
        reference, and grouping, assignment and the saved plot of one pass
        drawn from the seed, following that pass's outputs."""
        vox, sem, off = self.ref
        pick = int(np.random.default_rng(
            traffic.sub_seed(self.seed, 4)).integers(len(self.passes)))
        nums = {"rows_miss": 0, "fwd_rms": 0.0, "fwd_max": 0.0}
        for i, p in enumerate(self.passes):
            z = np.load(p["dump"])
            dump = {k: z[k] for k in (
                "coords", "offset_predictions", "semantic_prediction_logits",
                "instance_preds", "instance_preds_after_initial_clustering")}
            for k, v in forward_gaps(dump, vox, sem, off).items():
                nums[k] = max(nums[k], v)
            if i == pick:
                g = ref_grouping.check_grouping(
                    dump, self.cfg["grouping"],
                    float(self.cfg["sample_generation"]
                          ["search_radius_features"]), self.device)
                nums.update({k: g[k] for k in (
                    "nontree_miss", "group_gap", "assign_miss")})
                nums.update(saved_plot_gaps(p["laz"], self.data, dump, vox,
                                            self.vox_of_point))
                self.info = dict(getattr(self, "info", {}), checked_pass=i,
                                 candidates=g["n_candidates"],
                                 trees=g["n_trees"],
                                 ref_trees=g["n_ref_trees"])
        return nums

    def cleanup(self):
        if self.passes and os.path.isdir(self.passes[0]["dir"]):
            self.info = dict(getattr(self, "info", {}),
                             pass_bytes=_tree_bytes(self.passes[0]["dir"]))
        for p in self.passes:
            shutil.rmtree(p["dir"], ignore_errors=True)


def match_rows(c: np.ndarray, vox: np.ndarray):
    """(index into the sorted reference cloud ``vox`` of every dump row in
    sorted order, rows further than 1 mm from any reference point).  Tile
    mode adds a tile's centre back in float32, so a point may come back an
    ulp away from where it went in."""
    order = _sorted_rows(c)
    if c.shape == vox.shape and np.array_equal(c[order], vox):
        return order, np.arange(len(vox)), 0
    from scipy.spatial import cKDTree

    d, idx = cKDTree(vox).query(c[order].astype(np.float64))
    return order, idx, int((d > 1e-3).sum())


def forward_gaps(dump: dict, vox, sem, off) -> dict:
    """rows_miss: dump rows with no reference point within 1 mm, and
    reference points that no dump row took; fwd_rms: the larger over the
    two heads of the RMS of (dump - reference) over the RMS of the
    reference; fwd_max: the larger over the heads of the largest |dump -
    reference| over the largest |reference|.  Reference points that no
    tile predicts are NaN and must be absent from the dump."""
    c = np.asarray(dump["coords"], np.float32)
    order, idx, far = match_rows(c, vox)
    covered = int(np.isfinite(sem[:, 0]).sum())
    miss = far + abs(len(np.unique(idx)) - len(c)) + abs(covered - len(c))
    out = {"rows_miss": miss}
    rms, mx = 0.0, 0.0
    for prog, ref in ((dump["semantic_prediction_logits"], sem),
                      (dump["offset_predictions"], off)):
        r = ref[idx].astype(np.float64)
        d = np.asarray(prog, np.float64)[order] - r
        rms = max(rms, float(np.sqrt((d * d).mean())
                             / max(np.sqrt((r * r).mean()), 1e-30)))
        mx = max(mx, float(np.abs(d).max() / max(np.abs(r).max(), 1e-30)))
    if not np.isfinite(rms):
        rms = float("inf")
    out["fwd_rms"], out["fwd_max"] = rms, mx
    return out


def saved_plot_gaps(path: str, data: np.ndarray, dump: dict, vox,
                    vox_of_point) -> dict:
    """The full plot as the pass saved it (read with the port's LAS reader,
    as a loader only), against the plot and the pass's own final labels:

    - ``laz_xyz_miss``: points missing or extra, and points more than 1 mm
      from the plot's point of the same row;
    - ``laz_label_miss``: points whose treeID (the label as uint32) or
      classification (2 for label 0, else 4) is not that of the dump row of
      their voxel (``vox_of_point``: the reference's voxel of each point, a
      row of the sorted reference cloud ``vox``), or, for a voxel that no
      dump row holds, the 5-NN vote of the dump's voxel points."""
    from treelearn_tpu_torch.io.las import read_las

    from ..reference.grouping import vote5

    las = read_las(path)
    xyz = np.asarray(las.xyz, np.float64)
    n = len(data)
    if len(xyz) != n:
        return {"laz_xyz_miss": abs(len(xyz) - n) + n, "laz_label_miss": n}
    xyz_miss = int((np.abs(xyz - data[:, :3]).max(1) > 1e-3).sum())
    c = np.asarray(dump["coords"], np.float32)
    final = np.asarray(dump["instance_preds"], np.int64)
    order, idx, _ = match_rows(c, vox)
    row = np.full(len(vox), -1, np.int64)
    row[idx] = order
    prow = row[vox_of_point]
    want = np.where(prow >= 0, final[np.maximum(prow, 0)], 0)
    lost = np.where(prow < 0)[0]
    if len(lost):
        cen = (data[lost, :3] - data[:, :3].mean(0)).astype(np.float32)
        want[lost] = vote5(c, final, cen)
    tid = np.asarray(las.treeID).astype(np.int64)
    cls = np.asarray(las.classification).astype(np.int64)
    label_miss = ((tid != (want & 0xFFFFFFFF))
                  | (cls != np.where(want == 0, 2, 4)))
    return {"laz_xyz_miss": xyz_miss, "laz_label_miss": int(label_miss.sum())}


Cell = SegmentCell
