"""Point-cloud loading and saving across npy/npz/las/laz/txt.

Behavior parity with the reference loader/writer
(reference: tree_learn/util/data_preparation.py:17-56 for load_data;
tree_learn/util/pipeline.py:339-393 for save_data), implemented on our own
LAS codec instead of laspy.
"""

from __future__ import annotations

import os.path as osp
import random
from typing import Optional

import numpy as np

from .las import read_las, write_las

INSTANCE_LABEL_IGNORE_IN_RAW_DATA = -1  # label for unlabeled in raw data
NON_TREE_CLASS_IN_RAW_DATA = 0          # label for non-trees in raw data


def load_data(path: str) -> np.ndarray:
    """Load a point cloud as an (N, 4) array ``[x, y, z, label]``.

    For-Instance labeling convention for LAS (reference data_preparation.py:34-47):
    ``treeID != 0`` -> tree instance id; ``classification in {1, 2}`` -> non-tree (0);
    everything else -> unlabeled (-1).  3-column inputs get label -1.
    """
    assert path.endswith(("npy", "npz", "las", "laz", "txt")), path
    if path.endswith("npy"):
        data = np.load(path)
    elif path.endswith("npz"):
        npz = np.load(path)
        assert "points" in npz
        if "labels" not in npz:
            data = npz["points"]
        else:
            data = np.hstack((npz["points"], npz["labels"][:, np.newaxis]))
    elif path.endswith((".las", ".laz")):
        las = read_las(path)
        points = las.xyz
        if las.has_dim("treeID") and las.classification is not None:
            tree_id = np.asarray(las.treeID)
            classes = np.asarray(las.classification)

            tree_mask = tree_id != 0
            non_tree_mask = np.isin(classes, [1, 2])  # terrain or low vegetation
            unlabeled_mask = np.logical_not(tree_mask) & np.logical_not(non_tree_mask)
            assert (tree_mask & non_tree_mask & unlabeled_mask).sum() == 0

            labels = np.ones(len(points))
            labels[tree_mask] = tree_id[tree_mask]
            labels[non_tree_mask] = NON_TREE_CLASS_IN_RAW_DATA
            labels[unlabeled_mask] = INSTANCE_LABEL_IGNORE_IN_RAW_DATA
            data = np.hstack([points, labels[:, np.newaxis]])
        else:
            data = points
    elif path.endswith("txt"):
        data = np.loadtxt(path, skiprows=1)

    assert data.shape[1] in (3, 4)
    if data.shape[1] == 3:
        data = np.hstack(
            [data, INSTANCE_LABEL_IGNORE_IN_RAW_DATA * np.ones(len(data))[:, np.newaxis]]
        )
    return data


def generate_random_color(rng: Optional[random.Random] = None):
    rng = rng or random
    return [rng.randint(0, 255) for _ in range(3)]


def save_data(data: np.ndarray, save_format: str, save_name: str, save_folder: str,
              use_offset: bool = True) -> None:
    """Save an (N, 4) ``[x, y, z, treeID]`` cloud.

    LAS/LAZ output parity (reference pipeline.py:344-384): ``treeID`` uint32 extra
    dim, For-Instance classification codes 2 (terrain) / 4 (stem), a random RGB
    color per tree (non-trees black).  ``laz`` writes real LASzip-compressed
    point data through the native codec (io/laz.py).
    """
    if save_format in ("las", "laz"):
        assert data.shape[1] == 4
        points = data[:, :3]
        labels = data[:, 3]
        non_tree = labels == 0
        classification = np.full(len(labels), 4, np.uint8)  # stem
        classification[non_tree] = 2  # terrain (For-Instance convention)

        offsets = points.mean(0) if use_offset else (0.0, 0.0, 0.0)

        from ..utils.timing import substage

        with substage(f"save_data palette ({save_name})"):
            # tree ids are small ints: index a dense palette over
            # [min, max] directly instead of np.unique's 10M-row sort
            # (measured 7.7 s at 10M points)
            ilab = labels.astype(np.int64)
            lmin, lmax = (int(ilab.min()), int(ilab.max())) if len(ilab) else (0, 0)
            span = lmax - lmin + 1
            prng = np.random.default_rng()  # palette gen: one vectorized draw
            if span <= 4 * len(ilab) + 1024:
                palette = prng.integers(0, 256, size=(span, 3),
                                        dtype=np.uint16)
                colors = palette[ilab - lmin]
            else:  # pathological sparse ids: fall back to the exact route
                unique_labels, inv = np.unique(ilab, return_inverse=True)
                palette = prng.integers(0, 256, size=(len(unique_labels), 3),
                                        dtype=np.uint16)
                colors = palette[inv]
            colors[non_tree] = [0, 0, 0]

        save_path = osp.join(save_folder, f"{save_name}.{save_format}")
        with substage(f"write_las ({save_name}, {len(points)} pts)"):
            write_las(
                save_path,
                xyz=points,
                classification=classification,
                rgb=colors,
                extra={"treeID": labels.astype(np.uint32)},
                offsets=offsets,
            )
    elif save_format == "npy":
        np.save(osp.join(save_folder, f"{save_name}.npy"), data)
    elif save_format == "npz":
        np.savez_compressed(
            osp.join(save_folder, f"{save_name}.npz"),
            points=data[:, :3], labels=data[:, 3],
        )
    elif save_format == "txt":
        np.savetxt(osp.join(save_folder, f"{save_name}.txt"), data)
    else:
        raise ValueError(f"unknown save format: {save_format}")
