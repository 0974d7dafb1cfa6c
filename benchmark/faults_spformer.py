"""Faults planted in the program's SPFormer head (model/spformer.py,
train/matching.py, train/loop.py), for the readings that set the upper
ends of the ``train_spformer_crops_35m`` limits
(``benchmark/control_spformer.py --fault``) and for the tests that see
``correct`` come out false (``benchmark/tests/test_bench_spformer.py``).
The benchmark's own runs never plant one.  Each takes ``setattr``-like
``patch(obj, name, value)``.
"""

from __future__ import annotations

PRED_KEYS = ("pred_logits", "pred_scores", "pred_masks", "pred_queries")


def attn_mask_off(patch):
    """The cross-attention ignores its mask: every query attends to every
    key of its element (the masks are still computed and recorded)."""
    from treelearn_tpu_torch.model import spformer

    patch(spformer, "mask_bias", lambda closed, dtype: None)


def other_element_keys(patch):
    """Each element's queries attend to the keys of the whole batch: their
    own under their mask, the other elements' all open."""
    import torch

    from treelearn_tpu_torch.model import spformer

    def forward(self, q, src, ranges, closed, dtype):
        d = q.shape[-1]
        a = self.attn
        qp = a.project(q, slice(0, d), dtype)
        kv = a.project(src, slice(d, 3 * d), dtype)
        k, v = kv[:, :d], kv[:, d:]
        outs = []
        for b, (s, e) in enumerate(ranges):
            full = torch.zeros((q.shape[1], kv.shape[0]), dtype=torch.bool,
                               device=q.device)
            full[:, s:e] = closed[b]
            o = spformer.attention(a.heads_of(qp[b]), a.heads_of(k),
                                   a.heads_of(v),
                                   spformer.mask_bias(full, dtype),
                                   (d // a.heads) ** -0.5)
            outs.append(a.merge(o))
        o = spformer.linear(torch.stack(outs), a.out_proj, dtype)
        return spformer.layer_norm(q + o.float(), self.norm)

    patch(spformer.CrossAttentionLayer, "forward", forward)


def assign_by_index(patch):
    """The matching takes query i for the i-th non-empty target in place of
    the Hungarian assignment."""
    import numpy as np

    from treelearn_tpu_torch.train import matching

    def assign(cost, sizes):
        keep = np.flatnonzero(sizes > 0)
        return np.arange(len(keep), dtype=np.int64), keep.astype(np.int64)

    patch(matching, "assign", assign)


def non_object_weight_one(patch):
    """The class loss weighs the no-object class as the tree class (1.0 in
    place of 0.1)."""
    from treelearn_tpu_torch.train import loop

    orig = loop.spformer_loss

    def loss(output, batch):
        crit = dict(output["criterion"], non_object_weight=1.0)
        return orig(dict(output, criterion=crit), batch)

    patch(loop, "spformer_loss", loss)


def drop_aux_losses(patch):
    """Only the last prediction's loss counts: the auxiliary predictions
    are matched (and recorded) but add nothing to the loss."""
    from treelearn_tpu_torch.train import loop

    orig = loop.spformer_loss

    def loss(output, batch):
        orig(output, batch)
        last = dict(output, record=None, open_pairs=None,
                    **{k: output[k][-1:] for k in PRED_KEYS})
        return orig(last, batch)

    patch(loop, "spformer_loss", loss)


FAULTS = {f.__name__: f for f in (attn_mask_off, other_element_keys,
                                  assign_by_index, non_object_weight_one,
                                  drop_aux_losses)}
