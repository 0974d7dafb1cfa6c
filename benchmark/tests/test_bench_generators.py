"""The traffic generator: the same seed gives the same inputs, every seed the
same sizes where the generator fixes them, and large seeds work."""

import json
import os

import numpy as np
import pytest

from benchmark import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plot(cell, **small):
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        p = json.load(f)["plot"]
    p.update(small)
    return p


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_plot_deterministic_per_seed(seed):
    p = _plot("plot_60m", n_trees=6, extent=20.0, points_per_tree=900,
              ground_points=3000)
    a = traffic.make_plot(p, seed)
    b = traffic.make_plot(p, seed)
    assert np.array_equal(a, b)
    assert len(a) == 6 * 900 + 3000
    c = traffic.make_plot(p, seed + 1)
    assert len(c) == len(a) and not np.array_equal(a, c)


def test_crop_pool_deterministic(tmp_path):
    p = {"n_crops": 4, "hard_frac": 0.75, "extent": 10.0, "n_trees": 3,
         "points_per_tree": 700, "ground_points": 1500}
    a = traffic.write_crops(p, 2**31 + 99, str(tmp_path / "a"))
    b = traffic.write_crops(p, 2**31 + 99, str(tmp_path / "b"))
    assert len(a) == 4
    for x, y in zip(a, b):
        za, zb = np.load(x), np.load(y)
        for k in ("points", "feat", "instance_label", "center"):
            assert np.array_equal(za[k], zb[k])
        ground = za["instance_label"] == 0
        assert np.abs(za["points"][ground, :2]).max() <= 5.0 + 1e-6
    # one easy crop first: all its points kept
    assert len(np.load(a[0])["points"]) == 3 * 700 + 1500


def test_sub_seeds_differ_and_fit_63_bits():
    s = [traffic.sub_seed(2**31 + 5, t) for t in range(6)]
    assert len(set(s)) == 6 and all(0 <= x < 2**63 for x in s)
    assert traffic.sub_seed(7, 1) == traffic.sub_seed(7, 1)
