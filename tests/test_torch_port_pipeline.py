"""The port's segmentation pipeline end to end against the JAX package (CPU),
plus the port's import hygiene and device rules."""

import functools
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_integration import _pipeline_config

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _ari(a, b):
    """Adjusted Rand index of two labelings."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    comb = lambda x: (x * (x - 1) / 2.0).sum()  # noqa: E731
    s_ij = comb(table.astype(np.float64))
    s_a = comb(table.sum(1).astype(np.float64))
    s_b = comb(table.sum(0).astype(np.float64))
    expected = s_a * s_b / comb(np.float64(len(a)))
    top = 0.5 * (s_a + s_b)
    return 1.0 if top == expected else (s_ij - expected) / (top - expected)


def _plot(root):
    from treelearn_tpu.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=6, extent=20, points_per_tree=800,
                                    ground_points=4000, seed=3)
    d = osp.join(root, "plot", "forest")
    os.makedirs(d)
    path = osp.join(d, "mini.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    return path, data


def _max_cell_occupancy(xy, cell):
    ij = np.floor(xy / cell).astype(np.int64)
    ij -= ij.min(0)
    _, counts = np.unique(ij[:, 0] * (ij[:, 1].max() + 1) + ij[:, 1],
                          return_counts=True)
    return int(counts.max())


@pytest.mark.parametrize("whole_plot", [True, False],
                         ids=["whole_plot", "tiled"])
def test_pipeline_matches_jax(tmp_path, whole_plot, monkeypatch):
    """Saved full-cloud labels: the same partition up to relabelling
    (ARI >= 0.999) and the same tree count.  The JAX side's verticality is
    held to its exact banded kernel (interpret mode) — its CPU default is a
    capped, strided pass that this plot's dense cells exceed — and its CPU
    eps-graph pass is exact while the fullest cell stays under its 256 cap,
    which the test asserts."""
    import treelearn_tpu.ops.features as jf
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu.io import load_data
    from treelearn_tpu.pipeline import run_treelearn_pipeline as jax_run
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    monkeypatch.setattr(pv, "_INTERPRET", True)
    monkeypatch.setattr(jf, "compute_verticality", functools.partial(
        jf.compute_verticality, use_banded=True))
    path_j, data = _plot(str(tmp_path / "jax"))
    path_p, _ = _plot(str(tmp_path / "port"))

    cfg_j = _pipeline_config(path_j)
    cfg_j.whole_plot = whole_plot
    res_j = jax_run(cfg_j)
    cfg_p = ConfigDict.from_dict(dict(_pipeline_config(path_p)))
    cfg_p.whole_plot = whole_plot
    res_p = run_treelearn_pipeline(cfg_p, device="cpu")

    out_j = load_data(res_j["output_path"])
    out_p = load_data(res_p["output_path"])
    assert len(out_p) == len(out_j) == len(data)
    np.testing.assert_allclose(out_p[:, :3], out_j[:, :3], atol=1e-3)
    assert res_p["n_trees"] == res_j["n_trees"] > 0
    assert _ari(out_p[:, 3], out_j[:, 3]) >= 0.999

    pw = np.load(osp.join(res_p["results_dir"], "pointwise_results",
                          "pointwise_results.npz"))
    cand = pw["instance_preds_after_initial_clustering"] > 0
    xy = (pw["coords"] + pw["offset_predictions"])[cand][:, :2]
    assert _max_cell_occupancy(xy, 0.15 / np.sqrt(2.0)) <= 256
    assert osp.isdir(osp.join(res_p["results_dir"], "individual_trees"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of treelearn_tpu_torch (and chip_smoke.py) imports
    without pulling in jax or treelearn_tpu, the k-NN, training, HDBSCAN,
    evaluation, smoke, data-tool, plotting, data-parallel, profiler, bench,
    quality and toolchain modules included; nor pandas, sklearn or matplotlib, which the
    card's machine does not have."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import treelearn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'treelearn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        f"s = importlib.util.spec_from_file_location('cs', {osp.join(REPO, 'chip_smoke.py')!r})\n"
        "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'treelearn_tpu' or m.startswith('treelearn_tpu.')\n"
        "       or m.split('.')[0] in ('pandas', 'sklearn', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "new = ['ops.knn', 'train.losses', 'train.loop', 'train.selftrain',\n"
        "       'eval.evaluation', 'tools.train', 'ops.hdbscan',\n"
        "       'tools.evaluate', 'utils.smoke', 'tools.gen_train_data',\n"
        "       'tools.gen_val_data', 'tools.demo', 'utils.plot',\n"
        "       'parallel.mesh', 'parallel.launch', 'utils.trace',\n"
        "       'utils.profiling', 'tools.profile_model', 'tools.profile_step',\n"
        "       'tools.profile_kernels', 'tools.microbench_conv',\n"
        "       'tools.parse_trace', 'tools.bench', 'tools.oracle_ceiling',\n"
        "       'eval.quality', 'tools.hard_quality', 'tools.profile_cluster',\n"
        "       'tools.five_stage', 'tools.skip_count', 'utils.notebook']\n"
        "missing = [m for m in new if 'treelearn_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('treelearn_tpu_torch')]))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_port_sources_never_name_jax():
    for root, _, files in os.walk(osp.join(REPO, "treelearn_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                text = open(osp.join(root, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
                assert "from treelearn_tpu." not in text, f
                assert "import treelearn_tpu\n" not in text, f


def test_entry_points_raise_without_cuda(tmp_path):
    """Without a card the port refuses to run unless device='cpu'."""
    from treelearn_tpu_torch.device import resolve_device
    from treelearn_tpu_torch.ops.cluster import dbscan_cluster
    from treelearn_tpu_torch.ops.features import compute_verticality
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline
    from treelearn_tpu_torch.config import ConfigDict

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = np.random.default_rng(0).uniform(0, 1, (50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_verticality(pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        dbscan_cluster(pts[:, :2], 0.15, 2)
    path, _ = _plot(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_treelearn_pipeline(ConfigDict.from_dict(dict(_pipeline_config(path))))
    assert resolve_device("cpu").type == "cpu"


def test_cli_runs_on_cpu(tmp_path):
    """python -m treelearn_tpu_torch.tools.pipeline on a YAML config."""
    import yaml

    path, data = _plot(str(tmp_path))
    cfg = _pipeline_config(path).to_dict()
    cfg["save_cfg"]["save_treewise"] = False
    cfg["save_cfg"]["save_pointwise"] = False
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.pipeline",
         "--config", cfg_path, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'n_trees'" in out.stdout
