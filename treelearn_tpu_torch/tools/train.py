"""Training CLI of the PyTorch/CUDA port:

    python -m treelearn_tpu_torch.tools.train --config configs/training/train.yaml [--device cpu]
    torchrun --nproc_per_node 2 -m treelearn_tpu_torch.tools.train --config configs/training/train.yaml --dist

Counterpart of tools/train.py (reference tools/training/train.py): epoch
loop capped at ``examples_per_epoch``, a checkpoint every epoch
(``work_dirs/<config>/epoch_<n>.pth``: net, optimizer, scheduler, epoch;
the previous one is kept only on multiples of ``save_frequency``),
validation every ``validation_frequency`` epochs (semantic accuracy at 0.5
confidence and the offset loss; with ``model.head: spformer`` the instances
of SPFormer's last prediction, model/spformer.py:spformer_instances, a
crop), ``--resume`` from a saved epoch.  Runs on
the card by default; ``--device cpu`` runs the plain PyTorch versions of
the kernels.  ``--dist`` trains data-parallel over a torch.distributed
process group (parallel/mesh.py; JAX tools/train.py:142-208): one process
per rank, each forwarding its slice of every ``batch_size x world`` global
batch; rank 0 alone logs, writes checkpoints and validates (single-device
eval step), ``--resume`` loads on every rank.  ``--dist_url`` replaces
torchrun's ``env://``; the backend is nccl when each rank owns a card, else
gloo (parallel/mesh.py:default_backend).
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

import numpy as np
import torch

from ..data.dataset import TREE_CLASS_IN_DATASET

TREE_CONF_THRESHOLD = 0.5


def train_epoch(config, epoch, train_step, train_loader, logger, writer):
    start = time.time()
    losses = defaultdict(list)
    seen = 0
    for batch in train_loader:
        if config.examples_per_epoch < seen + batch["n_samples"]:
            break
        _, loss_dict = train_step(batch)
        for k, v in loss_dict.items():
            losses[k].append(float(v))
        seen += batch["n_samples"]
    avg = {k: sum(v) / len(v) for k, v in losses.items()}
    if writer is not None:
        for k, v in avg.items():
            writer.add_scalar(f"train/{k}", v, epoch)
    log = (f"[TRAINING] [{epoch}/{config.epochs}], "
           f"time {time.time() - start:.2f}s")
    for k, v in avg.items():
        log += f", {k}: {v:.2f}"
    logger.info(log)
    return avg


def validate_instances(config, epoch, eval_step, val_loader, logger,
                       writer):
    """The spformer head's validation: SPFormer's instances (its test
    settings) a crop of the validation set."""
    from ..model.spformer import spformer_instances

    test_cfg = {k: config.model.spformer.get(k, v) for k, v in (
        ("topk_insts", 100), ("score_thr", 0.0), ("npoint_thr", 100))}
    found, crops = 0, 0
    for batch in val_loader:
        insts = spformer_instances(eval_step(batch), **test_cfg)
        found += sum(len(r["scores"]) for r in insts)
        crops += len(insts)
    per_crop = found / max(crops, 1)
    logger.info(f"[VALIDATION] [{epoch}/{config.epochs}] val/instances "
                f"{per_crop:.2f} a crop")
    writer.add_scalar("val/instances", per_crop, epoch)
    return per_crop


def validate(config, epoch, eval_step, val_loader, logger, writer):
    from ..eval import get_eval_components
    from ..train import point_wise_loss

    if config.model.get("head", "offset") == "spformer":
        return validate_instances(config, epoch, eval_step, val_loader,
                                  logger, writer)

    logits_all, labels_all, off_pred_all, off_lab_all = [], [], [], []
    for batch in val_loader:
        output = eval_step(batch)
        keep = np.asarray(batch["masks_sem"] & batch["valid"])
        logits_all.append(
            output["semantic_prediction_logits"].cpu().numpy()[keep])
        labels_all.append(batch["semantic_labels"][keep])
        off_pred_all.append(output["offset_predictions"].cpu().numpy()[keep])
        off_lab_all.append(batch["offset_labels"][keep])
    logits = np.concatenate(logits_all)
    labels = np.concatenate(labels_all)
    off_pred = np.concatenate(off_pred_all)
    off_lab = np.concatenate(off_lab_all)

    masks_off = labels == TREE_CLASS_IN_DATASET
    _, offset_loss = point_wise_loss(
        torch.from_numpy(logits), torch.from_numpy(off_pred),
        torch.ones(len(labels), dtype=torch.bool),
        torch.from_numpy(masks_off), torch.from_numpy(labels),
        torch.from_numpy(off_lab))
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    tree_pred = probs[:, TREE_CLASS_IN_DATASET] >= TREE_CONF_THRESHOLD
    tp, fp, tn, fn = get_eval_components(tree_pred, masks_off)
    acc = (tp + tn) / max(tp + fp + fn + tn, 1)
    logger.info(f"[VALIDATION] [{epoch}/{config.epochs}] val/semantic_acc "
                f"{acc * 100:.2f}, val/offset_loss {float(offset_loss):.3f}")
    writer.add_scalar("val/acc", acc, epoch)
    writer.add_scalar("val/Offset_MAE", float(offset_loss), epoch)
    return acc, float(offset_loss)


def main(argv=None):
    from ..config import get_args_and_cfg
    from ..data.dataset import TreeDataset, build_dataloader
    from ..device import resolve_device
    from ..logging_utils import init_train_logger
    from ..model import TreeLearn, load_checkpoint
    from ..model.checkpoint import checkpoint_save, resume_checkpoint
    from ..train.loop import build_optimizer, make_eval_step, make_train_step

    args, config = get_args_and_cfg(argv)
    group = None
    owns_group = False
    if args.dist:
        import torch.distributed as dist

        from ..parallel import init_dp

        owns_group = not dist.is_initialized()
        group = init_dp(init_method=args.dist_url, device=args.device)
        device = group.device
    else:
        device = resolve_device(args.device)
    lead = group is None or group.rank == 0
    n_shards = 1 if group is None else group.world
    if lead:
        logger, writer = init_train_logger(config, args)
    else:
        logger, writer = logging.getLogger(f"TreeLearnTPU.rank{group.rank}"), None
        logger.setLevel(logging.WARNING)
    if group is not None:
        logger.info(f"data-parallel training over {n_shards} ranks "
                    f"({group.backend}; global batch = "
                    f"{config.dataloader.train.batch_size} x {n_shards})")

    model = TreeLearn(**config.model).init(int(config.get("seed", 0)))
    model.to(device)
    batch_size = int(config.dataloader.train.batch_size)
    steps_per_epoch = max(config.examples_per_epoch // (batch_size * n_shards),
                          1)
    optimizer, scheduler = build_optimizer(
        model.parameters(), config.optimizer, config.get("scheduler"),
        steps_per_epoch)

    train_set = TreeDataset(**config.dataset_train, logger=logger)
    val_set = TreeDataset(**config.dataset_test, logger=logger)
    train_loader = build_dataloader(train_set, training=True,
                                    n_shards=n_shards,
                                    **config.dataloader.train)
    val_loader = build_dataloader(val_set, training=False,
                                  **config.dataloader.test)

    start_epoch = 1
    if args.resume:
        logger.info(f"Resume from {args.resume}")
        start_epoch = resume_checkpoint(args.resume, model, optimizer,
                                        scheduler)
    elif config.get("pretrain"):
        logger.info(f"Load pretrain from {config.pretrain}")
        load_checkpoint(config.pretrain, model, logger)

    compute_dtype = torch.bfloat16 if config.get("fp16") else torch.float32
    if group is not None:
        from ..parallel import make_dp_train_step

        train_step = make_dp_train_step(
            model, optimizer, scheduler, group, batch_size=batch_size,
            compute_dtype=compute_dtype,
            grad_norm_clip=config.get("grad_norm_clip"))
    else:
        train_step = make_train_step(
            model, optimizer, scheduler, batch_size=batch_size,
            compute_dtype=compute_dtype,
            grad_norm_clip=config.get("grad_norm_clip"), device=device)
    eval_step = make_eval_step(
        model, batch_size=int(config.dataloader.test.batch_size),
        device=device)

    logger.info("Training")
    for epoch in range(start_epoch, config.epochs + 1):
        train_epoch(config, epoch, train_step, train_loader, logger, writer)
        if not lead:
            continue
        checkpoint_save(epoch, model, optimizer, scheduler, config.work_dir,
                        save_freq=config.save_frequency)
        if (config.validation_frequency
                and epoch % config.validation_frequency == 0):
            logger.info("Validation")
            validate(config, epoch, eval_step, val_loader, logger, writer)
        writer.flush()
    if lead:
        writer.close()
    if owns_group:
        dist.destroy_process_group()
    return model


if __name__ == "__main__":
    main()
