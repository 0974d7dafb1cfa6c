"""The one traffic generator: the inputs of a cell from its workload file
(``benchmark/workloads/<traffic>.json``) and the run's seed.

- ``plot``: a synthetic forest (``generator`` "easy" or "hard", the frozen
  generators of ``yardstick/synthetic.py``); (N, 4) float64 [x, y, z,
  instance].
- ``crops``: ``n_crops`` crops of ``extent`` metres, the first
  round(n_crops (1 - hard_frac)) easy and the rest hard, centred in xy and
  written as crop files.

Every seed draws the same sizes; only the random geometry changes.
"""

from __future__ import annotations

import os

import numpy as np

from .yardstick.synthetic import (make_crop_npz, make_synthetic_forest,
                                  make_synthetic_forest_hard,
                                  verticality_proxy)


def sub_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for one part of a run, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tag])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def _gen(name):
    return {"easy": make_synthetic_forest,
            "hard": make_synthetic_forest_hard}[name]


def make_plot(p: dict, seed: int) -> np.ndarray:
    data, _ = _gen(p["generator"])(
        n_trees=int(p["n_trees"]), extent=float(p["extent"]),
        points_per_tree=int(p["points_per_tree"]),
        ground_points=int(p["ground_points"]), seed=sub_seed(seed, 1))
    return data


def write_crops(p: dict, seed: int, out_dir: str) -> list:
    """Write the crop pool; returns the files in order."""
    os.makedirs(out_dir, exist_ok=True)
    n = int(p["n_crops"])
    n_easy = max(int(round(n * (1.0 - float(p["hard_frac"])))), 1)
    ext = float(p["extent"])
    paths = []
    for i in range(n):
        gen = make_synthetic_forest if i < n_easy else make_synthetic_forest_hard
        data, _ = gen(n_trees=int(p["n_trees"]), extent=ext,
                      points_per_tree=int(p["points_per_tree"]),
                      ground_points=int(p["ground_points"]),
                      seed=sub_seed(seed, 2, i))
        data[:, :2] -= ext / 2.0
        path = os.path.join(out_dir, f"crop_{i:03d}.npz")
        make_crop_npz(path, data, verticality_proxy(data))
        paths.append(path)
    return paths
