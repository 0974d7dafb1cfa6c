"""Crop/tile dataset: npz loading, augmentation, offset labels, loss masks.

Parity target: reference tree_learn/dataset/dataset.py (TreeDataset).  Host-side
numpy only — the devices see padded, fixed-shape batches produced by
:class:`TreeLoader` (the reference's torch DataLoader + collate_fn
concatenation becomes capacity-padded flat arrays + a valid mask, which is what
lets the whole train step jit-compile once per size bucket).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

INSTANCE_LABEL_IGNORE_IN_RAW_DATA = -1  # unlabeled in raw data
NON_TREE_CLASS_IN_RAW_DATA = 0          # non-tree instance label in raw data
NON_TREE_CLASS_IN_DATASET = 1           # semantic label for non-tree
TREE_CLASS_IN_DATASET = 0               # semantic label for tree


def semantic_from_instance(instance_label: np.ndarray) -> np.ndarray:
    """Raw instance labels -> binary semantics (reference dataset.py:44-46)."""
    semantic = np.empty(len(instance_label))
    semantic[instance_label == NON_TREE_CLASS_IN_RAW_DATA] = NON_TREE_CLASS_IN_DATASET
    semantic[instance_label != NON_TREE_CLASS_IN_RAW_DATA] = TREE_CLASS_IN_DATASET
    return semantic


def get_offset_labels(xyz: np.ndarray, instance_label: np.ndarray,
                      semantic_label: np.ndarray):
    """Per-point offset to the tree base (reference dataset.py:111-140).

    Tree base = mean of the instance's points within 0.5 m above a z-floor; the
    z-floor uses the same ``np.partition(z, 10)[3]`` regularization expression
    as the reference for >11-point trees (outlier robustness).
    """
    position = np.ones_like(xyz, dtype=np.float32)
    mask_valid_offset = np.zeros_like(instance_label, dtype=bool)

    for instance in np.unique(instance_label):
        inst_idx = np.where(instance_label == instance)
        first_idx = inst_idx[0][0]
        if semantic_label[first_idx] == NON_TREE_CLASS_IN_DATASET:
            continue
        tree_points = xyz[inst_idx]
        if len(tree_points) > 11:
            min_z = np.partition(tree_points[:, 2], 10)[3]
        else:
            min_z = tree_points[:, 2].min()
        mask_low = tree_points[:, 2] <= min_z + 0.5
        low_points = tree_points[mask_low]
        if len(low_points) > 0:
            position_instance = np.mean(low_points, axis=0)
            mask_valid_offset[inst_idx] = True
        else:
            position_instance = np.array([0, 0, 0])
        position[inst_idx] = position_instance

    return (position - xyz).astype(np.float32), mask_valid_offset


def point_jitter(points, rng, sigma=0.1, clip=0.2):
    jitter = np.clip(sigma * rng.standard_normal((points.shape[0], 3)), -clip, clip)
    return points + jitter


def augment(xyz: np.ndarray, data_augmentations: Dict[str, bool], rng,
            prob: float = 0.5) -> np.ndarray:
    """Global linear augmentation (reference dataset.py:143-164): anisotropic
    scale (xy in [0.8, 1.2], z in [0.95, 1.05]), 3x3 matrix jitter, x-flip,
    z-rotation — each applied with probability ``prob``."""
    m = np.eye(3)
    if data_augmentations.get("scaled") and rng.random() < prob:
        scale_xy = rng.uniform(0.8, 1.2, 2)
        scale_z = rng.uniform(0.95, 1.05, 1)
        m = m * np.concatenate([scale_xy, scale_z])
    if data_augmentations.get("jitter") and rng.random() < prob:
        m += rng.standard_normal((3, 3)) * 0.1
    if data_augmentations.get("flip") and rng.random() < prob:
        m[0][0] *= rng.integers(0, 2) * 2 - 1
    if data_augmentations.get("rot") and rng.random() < prob:
        theta = rng.random() * 2 * math.pi
        m = np.matmul(m, [[math.cos(theta), math.sin(theta), 0],
                          [-math.sin(theta), math.cos(theta), 0], [0, 0, 1]])
    return np.matmul(xyz, m)


class TreeDataset:
    """Dataset over crop/tile npz files (keys: points, feat, instance_label,
    center) — the artifact format of the sample generator."""

    def __init__(self, data_root: str, inner_square_edge_length: float,
                 training: bool, logger=None,
                 data_augmentations: Optional[Dict[str, bool]] = None,
                 seed: int = 0, **kwargs):
        self.data_paths = sorted(
            os.path.join(data_root, p) for p in os.listdir(data_root))
        self.inner_square_edge_length = inner_square_edge_length
        self.training = training
        self.data_augmentations = data_augmentations or {}
        self.rng = np.random.default_rng(seed)
        if logger is not None:
            mode = "train" if training else "test"
            logger.info(f"Load {mode} dataset: {len(self.data_paths)} scans")

    def __len__(self):
        return len(self.data_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        data = np.load(self.data_paths[index])
        xyz = np.asarray(data["points"], dtype=np.float64)
        input_feat = np.asarray(data["feat"], dtype=np.float32)
        instance_label = np.asarray(data["instance_label"])
        semantic_label = semantic_from_instance(instance_label)
        center = (np.zeros(3) if self.training else np.asarray(data["center"]))

        if self.training:
            if self.data_augmentations.get("point_jitter") and self.rng.random() <= 0.25:
                xyz = point_jitter(xyz, self.rng)
            xyz = augment(xyz, self.data_augmentations, self.rng)

        offset_label, mask_valid_offset = get_offset_labels(
            xyz, instance_label, semantic_label)

        inf_norm = np.linalg.norm(xyz[:, :-1], ord=np.inf, axis=1)
        mask_inner = inf_norm <= (self.inner_square_edge_length / 2)
        mask_not_ignore = instance_label != INSTANCE_LABEL_IGNORE_IN_RAW_DATA
        mask_off = (mask_inner & mask_not_ignore
                    & (semantic_label != NON_TREE_CLASS_IN_DATASET) & mask_valid_offset)
        mask_sem = mask_inner & mask_not_ignore

        return {
            "coords": xyz.astype(np.float32),
            "input_feats": input_feat.astype(np.float32),
            "instance_labels": instance_label.astype(np.int64),
            "semantic_labels": semantic_label.astype(np.int64),
            "offset_labels": offset_label.astype(np.float32),
            "centers": np.broadcast_to(center, xyz.shape).astype(np.float32),
            "masks_inner": mask_inner,
            "masks_off": mask_off,
            "masks_sem": mask_sem,
        }


def _round_up_bucket(n: int, min_size: int = 1 << 14) -> int:
    """Round a point count up to the next power-of-two bucket to bound the
    number of distinct compiled shapes (the reference instead skips crashing
    tiles, util/pipeline.py:91-97; we pad)."""
    size = min_size
    while size < n:
        size *= 2
    return size


def collate_padded(samples: Sequence[Dict[str, np.ndarray]],
                   pad_to: Optional[int] = None,
                   min_bucket: int = 1 << 14) -> Dict[str, np.ndarray]:
    """Concatenate variable-length clouds into one padded flat batch with
    ``batch_ids`` + ``valid`` (reference collate_fn parity, dataset.py:167-226,
    plus static-shape padding)."""
    total = sum(len(s["coords"]) for s in samples)
    size = pad_to if pad_to is not None else _round_up_bucket(total, min_bucket)
    assert size >= total, f"batch of {total} points exceeds pad size {size}"

    out = {}
    batch_ids = np.zeros(size, np.int32)
    valid = np.zeros(size, bool)
    pos = 0
    for b, s in enumerate(samples):
        n = len(s["coords"])
        batch_ids[pos:pos + n] = b
        valid[pos:pos + n] = True
        pos += n

    for key in samples[0]:
        arrs = [np.asarray(s[key]) for s in samples]
        cat = np.concatenate(arrs, axis=0)
        shape = (size,) + cat.shape[1:]
        pad = np.zeros(shape, cat.dtype)
        pad[:total] = cat
        out[key] = pad

    out["batch_ids"] = batch_ids
    out["valid"] = valid
    out["batch_size"] = len(samples)
    out["n_samples"] = len(samples)
    out["n_points"] = total
    return out


def collate_dp(samples: Sequence[Dict[str, np.ndarray]], n_shards: int,
               batch_size_per_shard: int,
               pad_to: Optional[int] = None,
               min_bucket: int = 1 << 14) -> Dict[str, np.ndarray]:
    """Collate for data-parallel steps: splits ``samples`` into ``n_shards``
    equal groups, pads every group to one common bucket, and stacks them on a
    leading device axis (D, P, ...) — the layout shard_map expects
    (parallel/mesh.py).  ``len(samples)`` must equal
    ``n_shards * batch_size_per_shard``."""
    assert len(samples) == n_shards * batch_size_per_shard, (
        len(samples), n_shards, batch_size_per_shard)
    groups = [samples[i * batch_size_per_shard:(i + 1) * batch_size_per_shard]
              for i in range(n_shards)]
    largest = max(sum(len(s["coords"]) for s in g) for g in groups)
    size = pad_to if pad_to is not None else _round_up_bucket(largest, min_bucket)
    collated = [collate_padded(g, pad_to=size) for g in groups]
    out = {k: np.stack([c[k] for c in collated])
           for k in collated[0] if isinstance(collated[0][k], np.ndarray)}
    out["batch_size"] = batch_size_per_shard
    out["n_samples"] = len(samples)
    out["n_points"] = sum(c["n_points"] for c in collated)
    return out


class TreeLoader:
    """Minimal host data loader: shuffling, batching, padded collate.

    Replaces the reference's torch DataLoader (util/train.py:125-141); no
    worker processes — this host has one core and the loading is npz reads,
    so the overlap win is on-device instead (donated buffers + async dispatch).

    With ``n_shards > 1`` each yielded batch is a data-parallel stack of
    ``n_shards`` per-device batches of ``batch_size`` samples each (the config
    batch_size is per-device; global batch = batch_size * n_shards), padded to
    a common bucket — see :func:`collate_dp`.
    """

    def __init__(self, dataset: TreeDataset, batch_size: int = 1,
                 training: bool = True, seed: int = 0,
                 pad_to: Optional[int] = None, min_bucket: int = 1 << 14,
                 drop_last: Optional[bool] = None, n_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.training = training
        self.rng = np.random.default_rng(seed)
        self.pad_to = pad_to
        self.min_bucket = min_bucket
        self.n_shards = n_shards
        # sharded batches are always full (static per-device shapes)
        self.drop_last = (training if drop_last is None else drop_last) \
            or n_shards > 1

    @property
    def _global_batch(self):
        return self.batch_size * self.n_shards

    def __len__(self):
        n = len(self.dataset)
        gb = self._global_batch
        return n // gb if self.drop_last else (n + gb - 1) // gb

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.training:
            self.rng.shuffle(order)
        gb = self._global_batch
        for start in range(0, len(order), gb):
            idx = order[start:start + gb]
            if self.drop_last and len(idx) < gb:
                return
            samples = [self.dataset[i] for i in idx]
            if self.n_shards > 1:
                yield collate_dp(samples, self.n_shards, self.batch_size,
                                 self.pad_to, self.min_bucket)
            else:
                yield collate_padded(samples, self.pad_to, self.min_bucket)


def build_dataloader(dataset, batch_size=1, num_workers=0, training=True,
                     **kwargs):
    """Reference-named constructor (util/train.py:125-141); num_workers is
    accepted for config compatibility and ignored (single-core host)."""
    return TreeLoader(dataset, batch_size=batch_size, training=training, **kwargs)
