"""Data parallelism on torch.distributed (port of
treelearn_tpu/parallel/mesh.py).

The counterpart of a JAX ``Mesh`` is a process group: one process per rank,
one device per process (:class:`DPGroup`).  Crops are independent, so each
rank forwards its own slice of a :func:`collate_dp` stack with its own
(local) BatchNorm batch statistics; only the four masked loss sums, the
gradients and the BatchNorm running statistics cross ranks, one sum each
(JAX ``psum`` / ``pmean`` in ``shard_map``).  Tile inference deals whole
loader batches to the ranks and gathers the harvested host arrays.

Backends: ``nccl`` when each rank owns a card, ``gloo`` on the CPU and when
ranks share one card.  gloo sums host tensors, so :func:`all_reduce_sum_`
stages card tensors through host copies for it; the tensors the kernels
read stay on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..train.losses import (LOSS_MULTIPLIER_SEMANTIC, masked_means,
                            point_wise_loss_sums)
from ..train.loop import (_BATCH_TENSORS, batch_to_device,
                          clip_by_global_norm_)


@dataclass(frozen=True)
class DPGroup:
    """This process's place in the data-parallel process group."""
    rank: int
    world: int
    device: torch.device
    backend: str


def default_backend(device: torch.device, world: int) -> str:
    """``nccl`` when every rank can own a card, else ``gloo``."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_device(device, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_dp(backend: Optional[str] = None, init_method: Optional[str] = None,
            *, rank: Optional[int] = None, world_size: Optional[int] = None,
            device=None) -> DPGroup:
    """Join (or, when one is initialized already, describe) the default
    process group.  ``rank`` / ``world_size`` default to the launcher's
    ``RANK`` / ``WORLD_SIZE``, ``init_method`` to ``env://`` (torchrun);
    ``device`` (default ``cuda``) without an index becomes the card
    ``LOCAL_RANK`` modulo the card count.  ``backend`` defaults to
    :func:`default_backend`."""
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = (int(os.environ.get("WORLD_SIZE", 1))
                      if world_size is None else world_size)
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or default_backend(dev, world_size)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return DPGroup(rank, world_size, dev, str(backend))


def make_mesh(device=None) -> Optional[DPGroup]:
    """The initialized process group as a :class:`DPGroup`, or None when
    this process runs alone (no group, or a group of one)."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    return init_dp(device=device)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: DPGroup) -> None:
    """Sum float32 ``tensors`` over the ranks in place, as one flat buffer
    (through host memory for gloo)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    wire = flat.cpu() if group.backend == "gloo" else flat
    dist.all_reduce(wire)
    flat = wire.to(flat.device)
    pos = 0
    for t in tensors:
        t.copy_(flat[pos:pos + t.numel()].view_as(t))
        pos += t.numel()


def broadcast_module_(model: torch.nn.Module, group: DPGroup) -> None:
    """Copy rank 0's parameters and buffers to every rank."""
    for t in model.state_dict().values():
        wire = t.cpu() if group.backend == "gloo" else t
        dist.broadcast(wire, 0)
        if wire is not t:
            t.copy_(wire)


def shard_batch_arrays(batch: dict, n_shards: int) -> dict:
    """Reshape a host batch of ``n_shards`` stacked per-device batches into
    leading-device-axis arrays: each value (D*P, ...) -> (D, P, ...)."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim >= 1:
            assert value.shape[0] % n_shards == 0, (key, value.shape, n_shards)
            out[key] = value.reshape(n_shards, value.shape[0] // n_shards,
                                     *value.shape[1:])
        else:
            out[key] = value
    return out


def make_dp_train_step(model, optimizer, scheduler, group: DPGroup, *,
                       batch_size: int, compute_dtype=torch.bfloat16,
                       grad_norm_clip: Optional[float] = None):
    """Data-parallel train step over a :func:`collate_dp` stack (D, P, ...):
    rank ``r`` forwards ``batch[k][r]`` in training mode with its own
    BatchNorm batch statistics.  The loss takes *global* normalizers (the
    four masked sums added over ranks), each rank back-propagates its own
    sums over them and the gradients are added over ranks: the gradient of
    the global-batch loss, as the JAX step computes it.  Then the global
    norm clip, the AdamW step and the schedule step, and the BatchNorm
    running statistics averaged over ranks.  Returns ``(loss, loss_dict)``
    of the global batch, equal on every rank."""
    clip = (1.0 if grad_norm_clip is True
            else float(grad_norm_clip) if grad_norm_clip else None)
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [b for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    broadcast_module_(model, group)

    def train_step(batch):
        model.train()
        b = batch_to_device({k: np.asarray(batch[k])[group.rank]
                             for k in _BATCH_TENSORS if k in batch},
                            group.device)
        output = model(b["coords"], b["input_feats"], b["batch_ids"],
                       b["valid"], batch_size=batch_size,
                       compute_dtype=compute_dtype)
        sums = point_wise_loss_sums(
            output["semantic_prediction_logits"], output["offset_predictions"],
            b["masks_sem"] & b["valid"], b["masks_off"] & b["valid"],
            b["semantic_labels"], b["offset_labels"])
        totals = sums.detach().clone()
        all_reduce_sum_([totals], group)
        # this rank's sums over the global counts
        sem, off = masked_means(torch.stack([sums[0], totals[1], sums[2],
                                             totals[3]]))
        optimizer.zero_grad(set_to_none=True)
        (sem * LOSS_MULTIPLIER_SEMANTIC + off).backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_sum_([p.grad for p in params], group)
        if clip is not None:
            clip_by_global_norm_(params, clip)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            all_reduce_sum_(stats, group)
            for s in stats:
                s.div_(group.world)
        sem, off = masked_means(totals)
        loss_dict = {"semantic_loss": sem * LOSS_MULTIPLIER_SEMANTIC,
                     "offset_loss": off}
        return sum(loss_dict.values()), loss_dict

    return train_step


def make_dp_inference_step(model, group: DPGroup, *,
                           compute_dtype=torch.float32,
                           need_backbone: bool = True):
    """Tile-parallel inference step: forwards one loader batch on this
    rank's device and returns its harvested host arrays
    (pipeline/inference.py:forward_harvest).  ``get_pointwise_preds(...,
    group=...)`` deals batch ``i`` to rank ``i % world`` and gathers."""
    from ..pipeline.inference import forward_harvest

    model = model.to(group.device).eval()

    def step(batch):
        return forward_harvest(model, batch, group.device, compute_dtype,
                               need_backbone)

    return step
