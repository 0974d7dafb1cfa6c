"""Training cells of Point Transformer V3 under TreeLearn's heads
(``TreeLearn(backbone="ptv3")``): the training cell of ``cells/train.py``
with the model, the weights, the reference and the step topology of PTv3.

Set-up imports ``treelearn_tpu_torch.model.ptv3`` first, so a program
without the backbone fails at once, before it writes a crop.  The model's
order shuffles and DropPath masks are drawn from its generator, seeded from
the run's seed; the first steps record them, and the reference follows
those steps on the same weights, batches and draws.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from .. import traffic
from ..reference import ptv3 as ref_ptv3
from ..reference import training as ref_train
from .train import TrainCell, _forever

QKV = ("attn.qkv.weight", "attn.qkv.bias")


def qkv_slices(leaves: dict) -> dict:
    """The leaves with each attention's qkv weight and bias cut into the
    rows of its queries, keys and values (``<leaf>.q``, ``.k``, ``.v``)."""
    out = {}
    for name, t in leaves.items():
        if name.endswith(QKV):
            out.update(zip((f"{name}.{s}" for s in "qkv"), t.chunk(3, 0)))
        else:
            out[name] = t
    return out


class TrainPTv3Cell(TrainCell):
    def setup(self):
        # the program's PTv3 module, by name: without it the cell ends here
        importlib.import_module("treelearn_tpu_torch.model.ptv3")
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
        m = dict(cfg["model"])
        m["ptv3"] = dict(m["ptv3"], seed=traffic.sub_seed(self.seed, 7))
        self.spec = ref_ptv3.param_spec(m["ptv3"])
        self.weights = ref_ptv3.make_weights(traffic.sub_seed(self.seed, 3),
                                             self.device, self.spec)
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
        # the first steps, their draws recorded: the reference follows them
        self.first, self.first_losses, self.first_draws = [], [], []
        seen = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: seen.append(tuple(
                out[k].detach().float().clone() for k in (
                    "semantic_prediction_logits", "offset_predictions"))))
        backbone = self.model.ptv3
        backbone.record_draws = True
        for i in range(int(self.work.get("first_steps", 3))):
            batch = next(self.batches)
            loss, _ = self.step(batch)
            if i == 0:
                hook.remove()
                self.first_out = seen[0]
                st = self.optimizer.state
                # no state after a step reads as a zero gradient
                self.first_grad = {
                    n: (st[p]["exp_avg"] / (1.0 - 0.9)).detach().clone()
                    if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                    for n, p in zip(self.names, params)}
            self.first.append(batch)
            self.first_losses.append(float(loss))
            self.first_draws.append(list(backbone.draws))
        backbone.record_draws = False
        backbone.draws = []
        self.after_first = {n: p.detach().clone() for n, p in
                            zip(self.names, params)}

    def window(self, seconds: float, trace: bool):
        ctx = super().window(seconds, trace)
        if trace:
            from treelearn_tpu_torch.utils.trace import counter_totals

            t0, t1 = ctx["win"]
            ctx["counters"] = counter_totals(t0, t1)
            self.info = dict(getattr(self, "info", {}), **{
                k: v for k, v in ctx["counters"].items()
                if k.startswith("loader.") and not k.endswith("_us")})
        return ctx

    def step_levels(self):
        """Per traced step, the stages' tokens by PTv3's own pooling rule
        (parent cells, ``grid >> s``), the tokens of each batch element a
        stage, the xCPE rule's pairs a stage, the stem's pairs and the
        points, from the benchmark's own voxels of the kept batch
        (``reference/ptv3.py``); run after the window."""
        m = self.cfg["model"]
        n_stages = len(m["ptv3"]["enc_depths"])
        out = []
        for coords, bid, bs in self.ctx.get("kept_batches", []):
            c = torch.from_numpy(coords).to(self.device)
            b = torch.from_numpy(bid).to(self.device).long()
            v = torch.ones(c.shape[0], dtype=torch.bool, device=self.device)
            grid, batch, _ = ref_ptv3.voxelize(
                c, b, v, bs, float(m["voxel_size"]), m.get("spatial_shape"))
            lv = {"tokens": [], "nnz": [], "elems": [], "points": c.shape[0],
                  "stem_nnz": int((ref_ptv3.neighbours(
                      grid, batch, ref_ptv3.STEM_K) >= 0).sum())}
            for s in range(n_stages):
                key = torch.unique(torch.cat([batch[:, None], grid >> s], 1),
                                   dim=0)
                g, bb = key[:, 1:], key[:, 0]
                lv["tokens"].append(int(g.shape[0]))
                lv["nnz"].append(int((ref_ptv3.neighbours(g, bb, 3) >= 0)
                                     .sum()))
                lv["elems"].append(torch.bincount(bb, minlength=bs).tolist())
            out.append(lv)
        return out

    def check(self, quant="none"):
        """The reference follows the first steps from the same weights,
        batches and recorded draws; :meth:`compare` gives the numbers."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ref_grads = []
        try:
            losses, g1, after, out = ref_ptv3.train_steps(
                self.weights, self.spec, self.first, self.first_draws,
                self.cfg, self.device, quant, self.ref_grads)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return self.compare(losses, g1, after, out)

    def compare(self, losses, g1, after, out):
        """The numbers of :meth:`TrainCell.compare`, but ``update_gap`` is
        the worst leaf's gap of the change's norms, each attention's qkv
        weight and bias cut into query, key and value slices.  Left out:
        the key slices of the qkv biases (softmax ignores a constant added
        to all of a query's logits, so their gradient is 0 in exact
        arithmetic and AdamW moves them on rounding alone; ``info
        key_bias_grad``, their largest reference gradient over the median
        leaf's), and the leaves whose reference gradient is under a
        thousandth of the median leaf's (biases before a BatchNorm): in
        the first step for the first gradient's gaps, in every step of
        ``ref_grads`` for ``update_gap`` (a first batch with no offset
        target gives the offset head no gradient until its second
        step)."""
        nums = super().compare(losses, g1, after, out)
        d_prog = qkv_slices({k: self.after_first[k].double()
                             - self.weights[k].double() for k in g1})
        d_ref = qkv_slices({k: after[k].double() - self.weights[k].double()
                            for k in g1})
        norms = [{k: float(v.double().norm()) for k, v in
                  qkv_slices(g).items()}
                 for g in self.ref_grads]
        key_bias = {k for k in norms[0] if k.endswith("qkv.bias.k")}
        meds = [float(np.median(list(n.values()))) for n in norms]
        moved = [{k for k, v in n.items() if v >= 1e-3 * m} - key_bias
                 for n, m in zip(norms, meds)]
        keep = set().union(*moved)
        gl = ref_train.leaf_gaps(qkv_slices(self.first_grad),
                                 qkv_slices(g1), moved[0])
        ul = ref_train.leaf_gaps(d_prog, d_ref, keep)
        self.info.update(
            grad_worst_leaves=gl[:3], update_worst_leaves=ul[:6],
            excluded_leaves=sorted(set(norms[0]) - keep - key_bias),
            key_bias_grad=max((n[k] / m for n, m in zip(norms, meds)
                               for k in key_bias), default=0.0),
            grad_gap_median=float(np.median([g for g, _ in gl])))
        nums["update_gap"] = ul[0][0]
        return nums


Cell = TrainPTv3Cell
