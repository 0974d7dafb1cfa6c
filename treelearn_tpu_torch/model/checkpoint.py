"""Weights: carry-over from the JAX package and checkpoint loading (port of
treelearn_tpu/model/checkpoint.py).

The port's ``state_dict`` uses the reference key names
(tests/fixtures/reference_state_dict_keys.txt) with the JAX package's
tensor layouts (conv weights (K, Cin, Cout), 1x1 shortcuts (Cout, Cin)), so
:func:`params_from_jax_numpy` is a flatten plus the BatchNorm
``num_batches_tracked`` counters, and a reference ``.pth`` loads after the
same spconv relayout the JAX package applies.

Training saves ``{net, optimizer, scheduler, epoch}`` with ``torch.save``
(the reference's ``.pth`` layout, util/train.py:46-62, plus the LR
scheduler) and resumes from it (:func:`save_checkpoint`,
:func:`resume_checkpoint`, :func:`checkpoint_save`).
"""

from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict

import numpy as np
import torch


def flatten_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict):
    tree = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def params_from_jax_numpy(params, state) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's nested numpy ``(params, state)`` trees -> the
    port's ``state_dict`` (float32 tensors; a zero ``num_batches_tracked``
    beside every BatchNorm's running statistics)."""
    sd = OrderedDict()
    for key, arr in flatten_tree(params).items():
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    for key, arr in flatten_tree(state).items():
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd


def jax_numpy_from_state_dict(sd):
    """Inverse of :func:`params_from_jax_numpy`: (params, state) nested
    numpy trees in the JAX package's layout."""
    params, state = {}, {}
    for key, t in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = t.detach().cpu().numpy()
        if key.endswith(("running_mean", "running_var")):
            state[key] = arr
        else:
            params[key] = arr
    return unflatten_tree(params), unflatten_tree(state)


def _convert_conv_weight(w: np.ndarray, k: int) -> np.ndarray:
    """spconv 5-D conv weight -> (K, c_in, c_out) rulebook layout.  Handles
    both layouts seen in spconv checkpoints (reference util/train.py:70-72):
    (c_out, k, k, k, c_in) and (k, k, k, c_in, c_out)."""
    if w.ndim != 5:
        raise ValueError(f"expected 5-D conv weight, got {w.shape}")
    if w.shape[1] == w.shape[2] == w.shape[3] == k:
        w = np.transpose(w, (1, 2, 3, 4, 0))
    elif w.shape[0] == w.shape[1] == w.shape[2] == k:
        pass
    else:
        raise ValueError(f"cannot identify spconv layout for kernel {k}: {w.shape}")
    return np.ascontiguousarray(w.reshape(k ** 3, w.shape[3], w.shape[4]))


def _to_port_layout(key: str, value: np.ndarray, target_shape) -> np.ndarray:
    """A reference tensor in the port's layout, or None on a mismatch."""
    if value.ndim == 5:
        if ".i_branch." in key or value.shape[1:4] == (1, 1, 1):
            value = value.reshape(value.shape[0], value.shape[4])
        else:
            k = round(target_shape[0] ** (1.0 / 3.0)) if len(target_shape) == 3 else 0
            if k ** 3 != (target_shape[0] if len(target_shape) == 3 else -1):
                return None
            try:
                value = _convert_conv_weight(value, k)
            except ValueError:
                return None
    return value if tuple(value.shape) == tuple(target_shape) else None


def load_checkpoint(path: str, model, logger=None, strict: bool = False) -> int:
    """Load a native ``.npz`` (the JAX package's ``net/`` + ``state/``
    layout) or a reference ``.pth`` into ``model``; keys whose size does not
    match are skipped (transfer-learning parity, reference
    util/train.py:77-84).  Returns epoch + 1.  Both formats hold U-Net
    weights: a model with another backbone is refused (its own checkpoints
    load through :func:`resume_checkpoint`)."""
    backbone = getattr(model, "backbone", "unet")
    if backbone != "unet":
        raise ValueError(
            f"load_checkpoint imports U-Net weights (a JAX .npz or a "
            f"reference .pth); this model's backbone is {backbone!r}, whose "
            f"weights none of them holds: load a checkpoint this port saved "
            f"with resume_checkpoint")
    target = model.state_dict()
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        src, epoch = {}, 0
        for key in z.files:
            if key.startswith("net/"):
                src[key[4:]] = z[key]
            elif key.startswith("state/"):
                src[key[6:]] = z[key]
            elif key == "epoch":
                epoch = int(z[key])
    else:
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("net", blob) if isinstance(blob, dict) else blob
        src = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
               for k, v in sd.items()}
        epoch = blob.get("epoch", 0) if isinstance(blob, dict) else 0
    new, skipped, missing = {}, [], []
    for key, value in src.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in target:
            missing.append(key)
            continue
        conv = _to_port_layout(key, np.asarray(value), target[key].shape)
        if conv is None:
            skipped.append(key)
            continue
        new[key] = torch.from_numpy(np.array(conv, np.float32))
    if logger is not None:
        if skipped:
            logger.info("skipped keys due to size/layout mismatch: "
                        + ", ".join(skipped))
        if missing:
            logger.info("source keys not present in model: " + ", ".join(missing))
    if strict and (skipped or missing):
        raise ValueError(f"strict load failed: skipped={skipped} missing={missing}")
    model.load_state_dict(new, strict=False)
    return epoch + 1


def save_checkpoint(path: str, model, optimizer=None, scheduler=None,
                    epoch: int = 0) -> None:
    """Write ``{net, optimizer, scheduler, epoch}`` to ``path`` through a
    temporary file, so a run killed mid-write leaves the old file whole."""
    blob = {"net": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        blob["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        blob["scheduler"] = scheduler.state_dict()
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def resume_checkpoint(path: str, model, optimizer=None,
                      scheduler=None) -> int:
    """Restore what :func:`save_checkpoint` wrote into ``model`` and, where
    given and saved, ``optimizer`` and ``scheduler``.  Returns epoch + 1."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(blob["net"])
    if optimizer is not None and "optimizer" in blob:
        optimizer.load_state_dict(blob["optimizer"])
    if scheduler is not None and "scheduler" in blob:
        scheduler.load_state_dict(blob["scheduler"])
    return int(blob.get("epoch", 0)) + 1


def checkpoint_save(epoch: int, model, optimizer, scheduler, work_dir: str,
                    save_freq: int = 1) -> str:
    """Save ``epoch_<epoch>.pth`` and delete the previous epoch's file
    unless that epoch is a multiple of ``save_freq`` (parity: reference
    util/train.py:46-62)."""
    path = osp.join(work_dir, f"epoch_{epoch}.pth")
    save_checkpoint(path, model, optimizer, scheduler, epoch)
    prev = osp.join(work_dir, f"epoch_{epoch - 1}.pth")
    if osp.isfile(prev) and not (epoch - 1 != 0
                                 and (epoch - 1) % save_freq == 0):
        os.remove(prev)
    return path
