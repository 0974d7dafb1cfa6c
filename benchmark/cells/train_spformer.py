"""Training cells of SPFormer's query decoder on TreeLearn's U-Net
(``TreeLearn(head="spformer")``): the training cell of ``cells/train.py``
with the model, the weights, the reference and the step topology of the
decoder.

Set-up imports ``treelearn_tpu_torch.model.spformer`` first, so a program
without the head fails at once, before it writes a crop.  The first steps
record what the reference follows (``model.spformer.record``: the closed
masks of every cross-attention, the assignment of every matching) and,
under a span timer, the program's own counters (``spformer.open_pairs.l<l>``),
which ``open_gap`` holds to the reference's own open pairs.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import torch

from .. import traffic
from ..reference import spformer as ref_spf
from ..reference import training as ref_train
from .train import TrainCell, _forever

IN_PROJ = ("attn.in_proj_weight", "attn.in_proj_bias")


def in_proj_slices(leaves: dict) -> dict:
    """The leaves with each attention's in-projection weight and bias cut
    into the rows of its queries, keys and values (``<leaf>.q``, ``.k``,
    ``.v``)."""
    out = {}
    for name, t in leaves.items():
        if name.endswith(IN_PROJ):
            out.update(zip((f"{name}.{s}" for s in "qkv"), t.chunk(3, 0)))
        else:
            out[name] = t
    return out


def _cpu_record(rec: dict) -> dict:
    return {"masks": [[m.cpu() for m in layer] for layer in rec["masks"]],
            "assignments": rec["assignments"],
            "open_pairs": rec["open_pairs"]}


class TrainSPFormerCell(TrainCell):
    def setup(self):
        # the program's SPFormer module, by name: without it the cell ends
        # here
        importlib.import_module("treelearn_tpu_torch.model.spformer")
        from treelearn_tpu_torch.data.dataset import TreeDataset, TreeLoader
        from treelearn_tpu_torch.model import TreeLearn
        from treelearn_tpu_torch.train.loop import (build_optimizer,
                                                    make_train_step)
        from treelearn_tpu_torch.utils.trace import SpanTimer, counter_totals

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
        self.spec = ref_spf.param_spec(m)
        self.weights = ref_spf.make_weights(traffic.sub_seed(self.seed, 3),
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
        # the first steps, recorded: the reference follows them
        self.first, self.first_losses, self.records = [], [], []
        self.first_terms = []
        self.first_counters = []
        seen = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: seen.append((
                out["pred_logits"][-1].detach().float().clone(),
                out["pred_scores"][-1].detach().float().clone(),
                [p.detach().clone() for p in out["pred_masks"][-1]])))
        head = self.model.spformer
        head.record = []
        for i in range(int(self.work.get("first_steps", 3))):
            batch = next(self.batches)
            t0 = time.time_ns()
            with SpanTimer(self.device):
                loss, terms = self.step(batch)
                val = float(loss)
            self.first_terms.append({k: round(float(v), 6)
                                     for k, v in terms.items()})
            self.first_counters.append(counter_totals(t0, time.time_ns()))
            if i == 0:
                hook.remove()
                cls, score, masks = seen[0]
                self.first_out = (cls, score, [p.cpu() for p in masks])
                st = self.optimizer.state
                # no state after a step reads as a zero gradient
                self.first_grad = {
                    n: (st[p]["exp_avg"] / (1.0 - 0.9)).detach().clone()
                    if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                    for n, p in zip(self.names, params)}
            self.first.append(batch)
            self.first_losses.append(val)
            self.records.append(_cpu_record(head.record.pop()))
        head.record = None
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
                if k.startswith("spformer.")})
        return ctx

    def step_levels(self):
        """Per traced step, the U-Net's voxels and rule pairs a level, the
        points, and the voxels of each batch element (the decoder's keys),
        from the benchmark's own topology of the kept batch; run after the
        window."""
        from ..reference.sparse import topology

        m = self.cfg["model"]
        out = []
        for coords, bid, bs in self.ctx.get("kept_batches", []):
            c = torch.from_numpy(coords).to(self.device)
            b = torch.from_numpy(bid).to(self.device)
            v = torch.ones(c.shape[0], dtype=torch.bool, device=self.device)
            topo = topology(c, b, v, bs, float(m["voxel_size"]),
                            int(m["num_blocks"]), m.get("spatial_shape"))
            vox, nnz = topo.counts()
            elems = torch.bincount(topo.levels[0].bxyz[:, 0],
                                   minlength=bs).tolist()
            out.append({"voxels": vox, "nnz": nnz, "points": c.shape[0],
                        "elems": elems})
        return out

    def check(self, quant="none"):
        """The reference follows the first steps from the same weights,
        batches and records; :meth:`compare` gives the numbers."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ref_grads = []
        if torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        try:
            res = ref_spf.train_steps(
                self.weights, self.spec, self.first, self.records, self.cfg,
                self.device, quant, self.ref_grads)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        if torch.device(self.device).type == "cuda":
            self.info["ref_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        return self.compare(*res)

    def compare(self, losses, g1, after, out, stats):
        """fwd_rms and fwd_max: the first step's last prediction (class
        and score logits, mask logits), the larger over the three of RMS(d)
        / RMS(ref) and of max|d| / max|ref|; loss_gap, the largest relative
        gap of the first steps' losses; update_gap, the worst leaf's gap of
        the change's norms (the attentions' in-projections cut into query,
        key and value slices, the key slices of their biases left out:
        softmax ignores a constant on a query's logits, so their exact
        gradient is 0; leaves whose reference gradient is under a
        thousandth of the median leaf's in every step left out);
        loader_miss; match_gap, the worst of the reference's cost of the
        program's assignment over its own optimum; mask_flip, the largest
        share of mask entries where the reference's own mask differs from
        the program's; open_gap, the largest relative gap, over the steps,
        of the program's ``spformer.open_pairs.l<l>`` counters summed over
        the layers (what ``mfu.spformer`` reads) to the reference's own open
        pairs (a layer whose mask leaves a few pairs open would make a
        layer's own gap a ratio of flips to a small count)."""
        dev = out[0][0].device
        cls, score, masks = self.first_out
        prog = [cls.to(dev), score.to(dev),
                torch.cat([p.to(dev).flatten() for p in masks])]
        ref = [torch.stack([o[0] for o in out]),
               torch.stack([o[1] for o in out]),
               torch.cat([o[2].flatten() for o in out])]
        rms = mx = 0.0
        for a, b in zip(prog, ref):
            a, b = a.double(), b.double()
            d = a - b
            rms = max(rms, float(d.square().mean().sqrt()
                                 / b.square().mean().sqrt().clamp(min=1e-30)))
            mx = max(mx, float(d.abs().max()
                               / b.abs().max().clamp(min=1e-30)))
        del prog, ref
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.first_losses, losses))
        d_prog = in_proj_slices({k: self.after_first[k].double()
                                 - self.weights[k].double() for k in g1})
        d_ref = in_proj_slices({k: after[k].double()
                                - self.weights[k].double() for k in g1})
        norms = [{k: float(v.double().norm()) for k, v in
                  in_proj_slices(g).items()} for g in self.ref_grads]
        key_bias = {k for k in norms[0] if k.endswith("in_proj_bias.k")}
        meds = [float(np.median(list(n.values()))) for n in norms]
        moved = [{k for k, v in n.items() if v >= 1e-3 * m} - key_bias
                 for n, m in zip(norms, meds)]
        keep = set().union(*moved)
        gl = ref_train.leaf_gaps(in_proj_slices(self.first_grad),
                                 in_proj_slices(g1), moved[0])
        ul = ref_train.leaf_gaps(d_prog, d_ref, keep)
        inner = float(self.cfg["dataset_train"]["inner_square_edge_length"])
        miss = max(ref_train.loader_miss(b, inner) for b in self.first)
        open_gap = 0.0
        for c, st in zip(self.first_counters, stats):
            got = sum(c.get(f"spformer.open_pairs.l{layer}", 0)
                      for layer in range(1, len(st["open_pairs"]) + 1))
            own = int(st["open_pairs"].sum())
            open_gap = max(open_gap, abs(got - own) / max(own, 1))
        self.info.update(
            grad_worst_leaves=gl[:3], update_worst_leaves=ul[:6],
            excluded_leaves=sorted(set(norms[0]) - keep - key_bias),
            key_bias_grad=max((n[k] / m for n, m in zip(norms, meds)
                               for k in key_bias), default=0.0),
            grad_gap_median=float(np.median([g for g, _ in gl])),
            ref_losses=losses, losses=self.first_losses,
            ref_terms=[st["terms"] for st in stats],
            terms=self.first_terms,
            open_share=[float(o) / max(st["entries"] // len(
                st["open_pairs"]), 1) for st in stats[:1]
                for o in st["open_pairs"]])
        return {"fwd_rms": rms, "fwd_max": mx, "loss_gap": loss_gap,
                "update_gap": ul[0][0], "loader_miss": miss,
                "match_gap": max(st["match_gap"] for st in stats),
                "mask_flip": max(st["flips"] / max(st["entries"], 1)
                                 for st in stats),
                "open_gap": open_gap}


Cell = TrainSPFormerCell
