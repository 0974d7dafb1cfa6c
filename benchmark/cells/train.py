"""Training cells: ``train/loop.py:make_train_step`` with ``build_optimizer``
over ``TreeLoader`` batches of a crop pool, as ``train/selftrain.py``
composes them.

Set-up writes the pool from the seed, builds the loader, the model (weights
from the seed) and the step, and drives that same step through its first
steps: the warm-up and the steps the reference follows.  The window keeps
stepping the same object; a step runs from the request of its batch to its
loss read back on the host, as the port's own loop reads it every step.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import traffic
from ..reference import training as ref_train
from ..reference.unet import make_weights, param_spec
from ..yardstick import trace as ytrace


def _forever(loader):
    while True:
        for batch in loader:
            yield batch


class TrainCell:
    def __init__(self, cfg: dict, work: dict, seed: int, device, run_dir,
                 config_cls):
        self.cfg, self.work, self.seed = cfg, work, int(seed)
        self.device = device
        self.run_dir = run_dir
        self.steps = []

    def setup(self):
        from treelearn_tpu_torch.data.dataset import TreeDataset, TreeLoader
        from treelearn_tpu_torch.model import TreeLearn
        from treelearn_tpu_torch.train.loop import (build_optimizer,
                                                    make_train_step)

        cfg = self.cfg
        crops = os.path.join(self.run_dir, "crops")
        paths = traffic.write_crops(self.work["crops"], self.seed, crops)
        self.info = {"pool_bytes": sum(os.path.getsize(p) for p in paths)}
        dt = cfg["dataset_train"]
        dataset = TreeDataset(
            crops, inner_square_edge_length=dt["inner_square_edge_length"],
            training=True, data_augmentations=dict(dt["data_augmentations"]),
            seed=traffic.sub_seed(self.seed, 5))
        self.bs = int(cfg["dataloader"]["train"]["batch_size"])
        loader = TreeLoader(dataset, batch_size=self.bs, training=True,
                            seed=traffic.sub_seed(self.seed, 6))
        self.batches = _forever(loader)
        m = cfg["model"]
        self.weights = make_weights(traffic.sub_seed(self.seed, 3),
                                    self.device, m["channels"],
                                    m["num_blocks"])
        self.model = TreeLearn(**m)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.to(self.device)
        self.names = [n for n, p in self.model.named_parameters()
                      if p.requires_grad]
        params = [p for _, p in self.model.named_parameters()
                  if p.requires_grad]
        self.optimizer, scheduler = build_optimizer(
            params, dict(cfg["optimizer"]), dict(cfg["scheduler"]),
            steps_per_epoch=max(int(cfg["examples_per_epoch"]) // self.bs, 1))
        self.step = make_train_step(
            self.model, self.optimizer, scheduler, batch_size=self.bs,
            compute_dtype=torch.bfloat16 if cfg.get("fp16") else torch.float32,
            grad_norm_clip=cfg.get("grad_norm_clip"), device=self.device)
        # the first steps: the reference follows them
        self.first = []
        self.first_losses = []
        self.first_grad = None
        seen = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: seen.append(tuple(
                out[k].detach().float().clone() for k in (
                    "semantic_prediction_logits", "offset_predictions"))))
        for i in range(int(self.work.get("first_steps", 3))):
            batch = next(self.batches)
            loss, _ = self.step(batch)
            if i == 0:
                hook.remove()
                self.first_out = seen[0]
            self.first.append(batch)
            self.first_losses.append(float(loss))
            if i == 0:
                st = self.optimizer.state
                # no state after a step reads as a zero gradient
                self.first_grad = {
                    n: (st[p]["exp_avg"] / (1.0 - 0.9)).detach().clone()
                    if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                    for n, p in zip(self.names, params)}
        self.after_first = {n: p.detach().clone() for n, p in
                            zip(self.names, params)}

    def window(self, seconds: float, trace: bool):
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        kept = []
        t0 = time.time_ns()
        while True:
            a = time.perf_counter()
            batch = next(self.batches)
            b = time.perf_counter()
            loss, _ = self.step(batch)
            val = float(loss)
            c = time.perf_counter()
            self.steps.append({"load_s": b - a, "step_s": c - a,
                               "loss": val, "n_points": int(batch["n_points"]),
                               "n_samples": int(batch["n_samples"])})
            if trace:
                n = int(batch["n_points"])
                kept.append((batch["coords"][:n], batch["batch_ids"][:n],
                             int(batch["batch_size"])))
            if (time.time_ns() - t0) / 1e9 >= seconds:
                break
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self.ctx = {"window_s": (t1 - t0) / 1e9, "steps": self.steps,
                    "work": self.work, "cfg": self.cfg,
                    "win": (t0, t1)}
        if trace:
            prof.__exit__(None, None, None)
            ev = ytrace.collect(prof)
            del prof
            self.ctx["events"] = ev
            self.ctx["trace"] = ytrace.summarize(ev, t0, t1)
            self.ctx["kept_batches"] = kept
        return self.ctx

    def result(self):
        crops = sum(s["n_samples"] for s in self.steps)
        times = np.asarray([s["step_s"] for s in self.steps]) * 1e3
        self.info = dict(getattr(self, "info", {}), steps=len(times),
                         beyond_p80=int((times > np.percentile(times, 80))
                                        .sum()),
                         step_median_ms=float(np.median(times)),
                         step_ms=[round(float(t), 1) for t in times],
                         load_ms=[round(1e3 * s["load_s"], 1)
                                  for s in self.steps])
        return {"train_crops_per_s": crops / self.ctx["window_s"]}

    def attempted(self):
        return len(self.steps)

    def step_levels(self):
        """[(voxels per level, rule pairs per level, points)] of every
        traced step's batch, from the benchmark's own topology; run after
        the window and the peak's reading."""
        from ..reference.sparse import topology

        m = self.cfg["model"]
        out = []
        for coords, bid, bs in self.ctx.get("kept_batches", []):
            c = torch.from_numpy(coords).to(self.device)
            b = torch.from_numpy(bid).to(self.device)
            v = torch.ones(c.shape[0], dtype=torch.bool, device=self.device)
            out.append(topology(c, b, v, bs, float(m["voxel_size"]),
                                int(m["num_blocks"]),
                                m.get("spatial_shape")).counts()
                       + (c.shape[0],))
        return out

    def release(self):
        del self.model, self.optimizer, self.step
        gc.collect()
        torch.cuda.empty_cache()

    def check(self, quant="none"):
        """The reference follows the first steps from the same weights and
        batches; :meth:`compare` gives the numbers."""
        spec = param_spec(self.cfg["model"]["channels"],
                          self.cfg["model"]["num_blocks"])
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            losses, g1, after, out = ref_train.train_steps(
                self.weights, spec, self.first, self.cfg, self.device, quant)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return self.compare(losses, g1, after, out)

    def compare(self, losses, g1, after, out):
        """The numbers compared (PERF.md says why these): fwd_rms and
        fwd_max, the first step's outputs (``output_gaps``); loss_gap, the
        largest relative gap of the first steps' losses; update_gap, the
        median leaf's gap of the norms of the change after the first steps;
        loader_miss.  Leaves whose reference gradient is under a thousandth
        of the median leaf's are left out.  The gaps of the first
        gradient's norms are reported and not compared."""
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.first_losses, losses))
        norms = {k: float(v.double().norm()) for k, v in g1.items()}
        med = float(np.median(list(norms.values())))
        moved = {k for k, v in norms.items() if v >= 1e-3 * med}
        d_prog = {k: self.after_first[k].double()
                  - self.weights[k].double() for k in g1}
        d_ref = {k: after[k].double() - self.weights[k].double() for k in g1}
        gl = ref_train.leaf_gaps(self.first_grad, g1, moved)
        ul = ref_train.leaf_gaps(d_prog, d_ref, moved)
        inner = float(self.cfg["dataset_train"]["inner_square_edge_length"])
        miss = max(ref_train.loader_miss(b, inner) for b in self.first)
        self.info = dict(getattr(self, "info", {}),
                         grad_worst_leaves=gl[:3], update_worst_leaves=ul[:3],
                         excluded_leaves=sorted(set(g1) - moved),
                         ref_losses=losses, losses=self.first_losses)
        self.info["grad_gap_median"] = float(np.median([g for g, _ in gl]))
        valid = torch.from_numpy(np.asarray(self.first[0]["valid"])).to(
            out[0].device)
        rms, mx = ref_train.output_gaps(
            [t.to(out[0].device) for t in self.first_out], out, valid)
        return {"fwd_rms": rms, "fwd_max": mx, "loss_gap": loss_gap,
                "update_gap": float(np.median([g for g, _ in ul])),
                "loader_miss": miss}

    def cleanup(self):
        pass


Cell = TrainCell
