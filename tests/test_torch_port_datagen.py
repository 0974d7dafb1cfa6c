"""treelearn_tpu_torch data tools against the JAX package's (CPU): the
validation tiles (``tools.gen_val_data``) and random training crops
(``tools.gen_train_data``) written from the same plot, the plotting
helpers, and the demo.  The JAX tools' verticality is held to the exact
banded Pallas kernel in interpret mode (its CPU default is a capped
approximation), as tests/test_pallas_vert.py runs it.  Written files are
compared by name and array, never by bytes (the tools differ in
``np.savez`` / ``np.savez_compressed``)."""

import functools
import importlib.util
import json
import os
import os.path as osp
import runpy
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture
def exact_jax_verticality(monkeypatch):
    """JAX compute_verticality through the banded kernel in interpret
    mode; the JAX tools import it inside their functions, so the patch
    takes."""
    import treelearn_tpu.ops.features as jf
    import treelearn_tpu.ops.pallas_vert as pv

    monkeypatch.setattr(pv, "_INTERPRET", True)
    monkeypatch.setattr(jf, "compute_verticality", functools.partial(
        jf.compute_verticality, use_banded=True))


def _write_plot(path):
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=4, extent=20, points_per_tree=800,
                                    ground_points=4000, seed=3)
    os.makedirs(osp.dirname(path))
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])


def _assert_features_close(got, want):
    """|dvert| <= 1e-3 (the JAX kernel's output is float16) but on a 1e-3
    share of ill-conditioned neighborhoods, as
    test_torch_port_postproc.py:test_verticality_matches_pallas_interpret
    holds kernel 4."""
    assert got.shape == want.shape
    far = np.abs(got.astype(np.float64) - want.astype(np.float64)) > 1e-3
    assert far.sum() <= max(1, int(1e-3 * got.size)), int(far.sum())


def _assert_npz_dirs_equal(a_dir, b_dir, close=("feat",)):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for name in names:
        a, b = np.load(osp.join(a_dir, name)), np.load(osp.join(b_dir, name))
        assert sorted(a.files) == sorted(b.files), name
        for k in a.files:
            if k in close:
                _assert_features_close(b[k], a[k])
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name}:{k}")
    return names


def _assert_json_dirs_equal(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    for name in names:
        with open(osp.join(a_dir, name)) as fa, open(osp.join(b_dir, name)) as fb:
            assert json.load(fa) == json.load(fb), name


def _val_yaml(tmp_path, root):
    path = tmp_path / f"{root}.yaml"
    path.write_text(
        f'default_args: ["{REPO}/configs/_modular/sample_generation.yaml"]\n'
        "sample_generation:\n  stride: 1\n"
        f"forest_path: '{tmp_path / root / 'val' / 'forest' / 'plot.npz'}'\n")
    return str(path)


def test_gen_val_data_matches_jax(tmp_path, monkeypatch, exact_jax_verticality):
    """The shipped gen_val_data config (stride 1) on one plot: voxelized
    points and labels equal, whole-plot verticality within the kernel-4
    tolerance, tile names, points, labels, centers and metadata equal."""
    from treelearn_tpu_torch.tools import gen_val_data

    for root in ("jax", "port"):
        _write_plot(str(tmp_path / root / "val" / "forest" / "plot.npz"))
    monkeypatch.setattr(sys, "argv", ["gen_val_data.py", "--config",
                                      _val_yaml(tmp_path, "jax")])
    runpy.run_path(osp.join(REPO, "tools", "gen_val_data.py"),
                   run_name="__main__")
    tiles = gen_val_data.main(["--config", _val_yaml(tmp_path, "port"),
                               "--device", "cpu"])
    j, p = tmp_path / "jax" / "val", tmp_path / "port" / "val"
    assert tiles["tiles_dir"] == str(p / "tiles")
    assert set(tiles["stage_seconds"]) == {"voxelize_features", "tiles"}
    _assert_npz_dirs_equal(j / "forest_voxelized0.1", p / "forest_voxelized0.1",
                           close=())
    _assert_npz_dirs_equal(j / "features", p / "features", close=("features",))
    names = _assert_npz_dirs_equal(j / "tiles" / "npz", p / "tiles" / "npz")
    assert tiles["tiles"] == len(names) >= 4
    _assert_json_dirs_equal(j / "tiles" / "json", p / "tiles" / "json")


def _train_cfg(get_config, base_dir):
    cfg = get_config(osp.join(REPO, "configs", "data_gen",
                              "gen_train_data.yaml"))
    cfg.base_dir = base_dir
    cfg.n_samples_total = 6   # shipped 25,000
    cfg.chunk_size = 12       # shipped 35 m: wider than this 20 m plot
    return cfg


def test_gen_train_data_matches_jax(tmp_path, exact_jax_verticality):
    """The shipped gen_train_data config, cut to 6 crops of 12 m, on one
    plot: voxelized points and labels, occupancy grid, crop file names,
    points, labels, centers and metadata equal (both tools draw from
    np.random.default_rng(0) at the same points); features within the
    kernel-4 tolerance."""
    from treelearn_tpu.config import get_config as jax_get_config
    from treelearn_tpu_torch.config import get_config
    from treelearn_tpu_torch.tools.gen_train_data import generate_random_crops

    for root in ("jax", "port"):
        _write_plot(str(tmp_path / root / "forests" / "plot.npz"))
    spec = importlib.util.spec_from_file_location(
        "jax_gen_train_data", osp.join(REPO, "tools", "gen_train_data.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_tool.generate_random_crops(_train_cfg(jax_get_config,
                                              str(tmp_path / "jax")))
    saved = generate_random_crops(_train_cfg(get_config,
                                             str(tmp_path / "port")),
                                  device="cpu")
    j, p = tmp_path / "jax", tmp_path / "port"
    _assert_npz_dirs_equal(j / "forests_voxelized0.1", p / "forests_voxelized0.1",
                           close=())
    _assert_npz_dirs_equal(j / "features", p / "features", close=("features",))
    _assert_npz_dirs_equal(j / "occupancy", p / "occupancy", close=())
    names = _assert_npz_dirs_equal(j / "random_crops" / "npz",
                                   p / "random_crops" / "npz")
    assert saved["crops"] == {"plot.npz": len(names)} and len(names) >= 3
    assert set(saved["stage_seconds"]) == {"voxelize", "features",
                                           "occupancy", "crops"}
    _assert_json_dirs_equal(j / "random_crops" / "json",
                            p / "random_crops" / "json")


def test_data_tools_raise_without_cuda(tmp_path):
    """Without a card the data tools refuse to run unless device='cpu'."""
    from treelearn_tpu_torch.config import ConfigDict, get_config
    from treelearn_tpu_torch.tools.gen_train_data import generate_random_crops
    from treelearn_tpu_torch.tools.gen_val_data import generate_val_tiles

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_random_crops(_train_cfg(get_config, str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_val_tiles(ConfigDict.from_dict(
            {"forest_path": str(tmp_path / "val" / "forest" / "p.npz")}))
    assert not os.listdir(tmp_path)


def test_plot_helpers_match_jax():
    """On the Agg backend: the partition-metric grid plots the same values
    on the same axes as the JAX helper, and juxtapose (matplotlib fallback:
    no plotly here) scatters the same subsampled points."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from treelearn_tpu.utils import plot as jplot
    from treelearn_tpu_torch.utils import plot as pplot

    rng = np.random.default_rng(0)
    results = {name: rng.uniform(0.6, 1.0, 10)
               for name in ("IoU", "precision", "recall", "F1")}
    figs = [m.plot_partition_metrics(results, y_range=(0.5, 1.0))
            for m in (jplot, pplot)]
    axes = [[ax for ax in f.axes if ax.get_visible()] for f in figs]
    assert len(axes[0]) == len(axes[1]) == 4
    for a, b in zip(*axes):
        assert a.get_ylabel() == b.get_ylabel()
        assert a.get_ylim() == b.get_ylim() == (0.5, 1.0)
        np.testing.assert_array_equal(a.lines[0].get_xydata(),
                                      b.lines[0].get_xydata())
    c1, c2 = rng.normal(size=(100, 3)), rng.normal(size=(50, 3))
    jfig, pfig = (m.juxtapose(c1, c2, "pred", "gt", subset=3, renderer=None)
                  for m in (jplot, pplot))
    for a, b in zip(jfig.axes[0].collections, pfig.axes[0].collections):
        for x, y in zip(a._offsets3d, b._offsets3d):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert len(pfig.axes[0].collections) == 2
    plt.close("all")


def test_demo_runs_on_cpu(tmp_path):
    """``tools.demo --device cpu`` on a small plot with the shipped
    pipeline config: the labeled cloud and the per-tree folders are
    written, and the summary counts every point of the plot."""
    from treelearn_tpu_torch.tools import demo

    forest = str(tmp_path / "in" / "small.npz")
    _write_plot(forest)
    res = demo.main(["--forest", forest, "--workdir", str(tmp_path / "w"),
                     "--device", "cpu"])
    assert res["device"] == "cpu"
    assert res["n_points"] == len(np.load(forest)["points"])
    assert res["output_path"].endswith("small.laz")
    assert osp.isfile(res["output_path"])
    assert osp.isdir(osp.join(res["results_dir"], "individual_trees"))
    assert res["n_trees"] >= 0
