"""The port's quality and toolchain tools against the repository's JAX-side
scripts (CPU): the oracle ceiling (tools/oracle_ceiling.py against
scripts/exp_oracle_ceiling.py, the JAX grouping on its exact paths), the
quality chain (eval/quality.py against scripts/exp_hard_quality.py:109-141),
profile_cluster's labels against the pipeline's, each tool's ``main`` with
``--device cpu`` at a tiny size, the five-stage run and the notebooks.

Run as a script, ``python tests/test_torch_port_quality.py --bench-hard``
prints the JAX script's oracle ceiling on the bench's hard plot through the
JAX package's CPU paths (capped verticality, XLA connected components): a
quality number of that path only.
"""

import functools
import importlib.util
import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
NB_DIR = osp.join(REPO, "treelearn_tpu_torch", "notebooks")
torch.set_num_threads(1)

# a small held-out hard forest: the script's generator and seed
SMALL = dict(trees=5, ppt=2500, extent=14.0, seed=7777)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ari(a, b):
    from scipy.special import comb

    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    m = np.zeros((ia.max() + 1, ib.max() + 1), np.int64)
    np.add.at(m, (ia, ib), 1)
    s = comb(m, 2).sum()
    sa, sb = comb(m.sum(1), 2).sum(), comb(m.sum(0), 2).sum()
    e = sa * sb / comb(len(a), 2)
    return float((s - e) / (0.5 * (sa + sb) - e))


def jax_oracle(data, exact=True, noise=0.0):
    """scripts/exp_oracle_ceiling.py:66-99 on ``data`` through the JAX
    package.  ``exact``: verticality through the banded Pallas kernel in
    interpret mode and DBSCAN through the banded found-bits kernel in
    interpret mode (the package's TPU paths); otherwise its CPU paths."""
    import tempfile

    from treelearn_tpu.config import ConfigDict
    from treelearn_tpu.ops.voxelize import voxel_downsample_trace_np
    from treelearn_tpu.pipeline import instances as ji
    from treelearn_tpu.train.selftrain import detection_f1_from_pointwise

    script = _script("exp_oracle_ceiling")
    coords_all = data[:, :3].astype(np.float32)
    labels_all = data[:, 3].astype(np.int64)
    vox, idx, _ = voxel_downsample_trace_np(coords_all, 0.1)
    coords = vox.astype(np.float32)
    labels = labels_all[idx]
    offs = script.gt_offsets(coords, labels)
    if noise:
        rng = np.random.default_rng(0)
        offs = offs + rng.normal(0, noise, offs.shape).astype(np.float32)
    logits = np.where((labels > 0)[:, None],
                      np.array([10.0, -10.0], np.float32),
                      np.array([-10.0, 10.0], np.float32))
    grouping = ConfigDict.from_dict({
        "tau_group": 0.15, "tau_min": 50, "tau_off": 4, "tau_vert": 0.6,
        "tree_conf_thresh": 0.5, "use_hdbscan": False})
    with pytest.MonkeyPatch.context() as mp:
        if exact:
            import treelearn_tpu.ops.features as jf
            import treelearn_tpu.ops.pallas_cc as pcc
            import treelearn_tpu.ops.pallas_vert as pv
            from treelearn_tpu.ops.cluster import relabel_components_np

            mp.setattr(pv, "_INTERPRET", True)
            mp.setattr(pcc, "_INTERPRET", True)
            mp.setattr(jf, "compute_verticality", functools.partial(
                jf.compute_verticality, use_banded=True))

            def banded_dbscan(points_xy, eps, min_size, not_assigned_label=-1,
                              start_num=1):
                # ops/cluster.py:219-228, the TPU branch
                comp = pcc.cc_labels_banded(
                    points_xy[:, :2].astype(np.float32), float(eps))
                return relabel_components_np(comp, min_size,
                                             not_assigned_label, start_num)

            mp.setattr(ji, "dbscan_cluster", banded_dbscan)
        preds = ji.get_instances(coords, offs.astype(np.float32), logits,
                                 grouping, None, 0, 0, -1, 1,
                                 search_radius=0.6)
    tree_mask = preds != 0
    preds[tree_mask] = ji.assign_remaining_points_nearest_neighbor(
        (coords + offs)[tree_mask], preds[tree_mask], -1)
    with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
        np.savez(f, instance_labels=labels, instance_preds=preds)
        pw = f.name
    try:
        q = detection_f1_from_pointwise(pw)
    finally:
        os.remove(pw)
    return preds, q, offs


@pytest.fixture(scope="module")
def small_forest():
    from treelearn_tpu_torch.tools.oracle_ceiling import hard_forest

    return hard_forest(**SMALL)


def test_gt_offsets_equal_the_script(small_forest):
    from treelearn_tpu_torch.ops.voxelize import voxel_downsample_trace_np
    from treelearn_tpu_torch.tools.oracle_ceiling import gt_offsets

    script = _script("exp_oracle_ceiling")
    vox, idx, _ = voxel_downsample_trace_np(small_forest[:, :3], 0.1)
    coords = vox.astype(np.float32)
    labels = small_forest[idx, 3].astype(np.int64)
    got = gt_offsets(coords, labels)
    want = script.gt_offsets(coords, labels)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[labels > 0]).max() > 1.0


def test_hard_forest_is_the_scripts(small_forest):
    """The script's forest (ground points extent^2 * 55) from the port's
    generator equals the JAX package's."""
    from treelearn_tpu.data.synthetic import make_synthetic_forest_hard

    want, _ = make_synthetic_forest_hard(
        n_trees=SMALL["trees"], extent=SMALL["extent"],
        points_per_tree=SMALL["ppt"],
        ground_points=int(SMALL["extent"] ** 2 * 55), seed=SMALL["seed"])
    np.testing.assert_array_equal(small_forest, want)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_run_oracle_matches_the_jax_script(small_forest, noise):
    """Same tree count, ARI >= 0.999 and F1 within 0.1 of the script's
    ceiling, the JAX grouping on its exact (interpret-mode) paths; with the
    script's offset noise (numpy seed 0) too."""
    from treelearn_tpu_torch.tools.oracle_ceiling import run_oracle

    got = run_oracle(small_forest, device="cpu", noise=noise)
    want, q, _ = jax_oracle(small_forest, noise=noise)
    assert got["n_clusters"] >= 3
    assert len(np.unique(got["labels"])) == len(np.unique(want))
    assert _ari(got["labels"], want) >= 0.999
    assert abs(got["f1"] - q["f1_score"]) <= 0.1
    assert got["n_pred"] == q["n_pred"] and got["n_gt"] == q["n_gt"]
    assert set(got["stage_seconds"]) == {"voxelize", "offsets",
                                         "get_instances", "assign_remaining",
                                         "score"}


def _script_chain(pw):
    """scripts/exp_hard_quality.py:109-141, the statistics as the script
    computes them."""
    z = np.load(pw)
    coords = z["coords"]
    op, ol = z["offset_predictions"], z["offset_labels"]
    gt = z["instance_labels"].astype(int)
    tree = gt > 0
    base = coords[:, :2] + ol[:, :2]
    rad = np.linalg.norm(coords[:, :2] - base, axis=1)
    trunkish = tree & (rad < 0.3)
    crown = tree & (rad > 1.0)
    err = np.linalg.norm((op - ol)[:, :2], axis=1)
    pm = np.linalg.norm(op[:, :2], axis=1)
    lm = np.linalg.norm(ol[:, :2], axis=1)
    m = crown & (lm > 0.5)
    cos = (op[m, :2] * ol[m, :2]).sum(1) / (pm[m] * lm[m] + 1e-9)
    return {"xy_err_trunk_median": np.median(err[trunkish]),
            "xy_err_crown_median": np.median(err[crown]),
            "xy_err_crown_p90": np.percentile(err[crown], 90),
            "xy_err_tree_median": np.median(err[tree]),
            "crown_cos_median": np.median(cos),
            "crown_mag_ratio_median": np.median(pm[m] / lm[m])}


@pytest.fixture(scope="module")
def oracle_dump(tmp_path_factory, small_forest):
    """A pointwise dump of the small forest: ground-truth offsets with
    noise as the predictions, noisy logits, the port's labels."""
    from treelearn_tpu_torch.tools.oracle_ceiling import run_oracle

    res = run_oracle(small_forest, device="cpu")
    coords, gt = res["coords"], res["gt"]
    from treelearn_tpu_torch.tools.oracle_ceiling import gt_offsets

    ol = gt_offsets(coords, gt).astype(np.float32)
    rng = np.random.default_rng(3)
    op = (ol * rng.uniform(0.6, 1.1, (len(ol), 1))
          + rng.normal(0, 0.15, ol.shape)).astype(np.float32)
    op[:, 2] = ol[:, 2]
    logits = np.where((gt > 0)[:, None], np.float32([2.0, -2.0]),
                      np.float32([-2.0, 2.0]))
    logits = (logits + rng.normal(0, 1.5, logits.shape)).astype(np.float32)
    pw = str(tmp_path_factory.mktemp("dump") / "pointwise_results.npz")
    np.savez(pw, coords=coords, offset_predictions=op, offset_labels=ol,
             semantic_prediction_logits=logits, instance_labels=gt,
             instance_preds=res["labels"])
    return pw


def test_quality_chain_matches_the_script(oracle_dump):
    from treelearn_tpu.train.selftrain import (
        detection_f1_from_pointwise as jdet,
        segmentation_partition_summary as jpart)
    from treelearn_tpu_torch.eval.quality import KEYS, quality_chain

    got = quality_chain(oracle_dump)
    assert tuple(got) == KEYS
    want = _script_chain(oracle_dump)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=0, abs=0), k
    q, p = jdet(oracle_dump), jpart(oracle_dump)
    assert (got["f1"], got["completeness"], got["commission"],
            got["n_pred"], got["n_gt"]) == (
        q["f1_score"], q["completeness"], q["commission_error_rate"],
        q["n_pred"], q["n_gt"])
    assert got["matched_iou"] == q["mean_matched_iou"]
    assert got["xy_partition_mean_iou"] == p["xy_partition_mean_iou"]
    assert got["z_partition_mean_iou"] == p["z_partition_mean_iou"]
    assert all(np.isfinite(v) for v in got.values())
    assert got["n_trunk"] > 0 and got["n_crown_dir"] > 0


def test_profile_cluster_labels_equal_get_instances(oracle_dump):
    """The labels assembled from the sub-steps equal get_instances +
    assign_remaining on the same dump, and the JAX package's on its exact
    verticality path."""
    import treelearn_tpu.ops.features as jf
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu.config import ConfigDict
    from treelearn_tpu.pipeline import instances as ji
    from treelearn_tpu_torch.tools.profile_cluster import (GROUPING,
                                                           profile_cluster)

    out = profile_cluster(oracle_dump, device="cpu")
    assert out["labels_equal"] and out["initial_equal"]
    assert out["n_clusters"] >= 3 and out["n_remaining"] > 0
    assert out["knn"][0]["route"] == "kdtree_small_refs"
    assert {"masks", "deferred_verticality", "cc_labels", "relabel",
            "get_instances_total", "assign_remaining"} <= set(out["seconds"])
    z = np.load(oracle_dump)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pv, "_INTERPRET", True)
        mp.setattr(jf, "compute_verticality", functools.partial(
            jf.compute_verticality, use_banded=True))
        args = (z["coords"], z["offset_predictions"],
                z["semantic_prediction_logits"],
                ConfigDict.from_dict(GROUPING), None, 0, 0, -1, 1)
        want = ji.get_instances(*args)
    tm = want != 0
    want[tm] = ji.assign_remaining_points_nearest_neighbor(
        (z["coords"] + z["offset_predictions"])[tm], want[tm], -1)
    assert len(np.unique(out["labels"])) == len(np.unique(want))
    assert _ari(out["labels"], want) >= 0.999


def test_profile_cluster_on_a_pipeline_dump(tmp_path):
    """On the dump of a DBSCAN-mode pipeline run the sub-steps' labels are
    the pipeline's own; main prints the JSON line and propagates."""
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline
    from treelearn_tpu_torch.tools import profile_cluster
    from treelearn_tpu_torch.tools.hard_quality import eval_config

    data, _ = make_synthetic_forest(n_trees=4, extent=14.0,
                                    points_per_tree=2000, ground_points=6000,
                                    seed=4)
    d = tmp_path / "plot" / "forest"
    d.mkdir(parents=True)
    fp = str(d / "p.npz")
    np.savez(fp, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    config = eval_config(fp, None, {"channels": 8, "num_blocks": 2})
    res = run_treelearn_pipeline(config, device="cpu")
    pw = osp.join(res["results_dir"], "pointwise_results",
                  "pointwise_results.npz")
    centered = osp.join(str(d), "p_centered.npz")
    out = profile_cluster.main([pw, "--forest", centered, "--device", "cpu"])
    assert out["labels_equal"] and out["dump_equal"]
    np.testing.assert_array_equal(out["labels"], np.load(pw)["instance_preds"])
    assert out["n_propagated"] == len(data)
    assert "propagate" in out["seconds"]


def test_tool_mains_on_cpu(tmp_path, monkeypatch, capsys):
    """oracle_ceiling and hard_quality as a user calls them, tiny sizes,
    ``--device cpu``: one JSON line each with every quality_chain key, all
    finite but the matched IoU of a run that matched no tree (a 4-step model
    predicts none: the no-prediction path); without the flag and without a
    card they raise."""
    from treelearn_tpu_torch.eval.quality import KEYS
    from treelearn_tpu_torch.tools import hard_quality, oracle_ceiling

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    out = oracle_ceiling.main(["--device", "cpu", "--trees", "4",
                               "--extent", "12", "--ppt", "2000"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["f1"] == out["f1"] and line["n_gt"] == 4
    assert line["forest"] == "script" and "labels" not in line
    hq = hard_quality.main([
        "--device", "cpu", "--steps", "4", "--crops", "2",
        "--crop-extent", "10", "--train-ppt", "600:900", "--channels", "8",
        "--num-blocks", "2", "--trees", "4", "--extent", "12",
        "--eval-ppt", "2500", "--seed0", "202"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(KEYS) <= set(line) and line["trained_steps"] == 4
    assert line["seed0"] == 202 and line["recipe"] == "script"
    for k in KEYS:
        assert np.isfinite(line[k]) or (k == "matched_iou"
                                        and line["completeness"] == 0), k
    assert hq["n_gt"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            oracle_ceiling.main(["--trees", "2", "--extent", "8"])


def test_hard_quality_bench_recipe_is_the_benchs():
    """``--recipe bench`` trains BENCH_RECIPE at the bench's model config,
    so it hits the bench's cache key; the script recipe keeps the script's
    model and flags."""
    from types import SimpleNamespace

    from treelearn_tpu_torch.tools import hard_quality
    from treelearn_tpu_torch.tools.bench import bench_config
    from treelearn_tpu_torch.train.selftrain import BENCH_RECIPE

    bench = SimpleNamespace(recipe="bench", seed0=None, channels=None,
                            num_blocks=None)
    mc, kw = hard_quality.training_kwargs(bench)
    assert kw == dict(BENCH_RECIPE)
    assert mc == dict(bench_config("", 1 << 18).model)
    script = SimpleNamespace(
        recipe="script", seed0=303, channels=None, num_blocks=None,
        steps=600, lr=2e-3, crops=12, hard_frac=0.5, recipe_v=None,
        crop_extent=None, train_ppt="9000:12000")
    mc, kw = hard_quality.training_kwargs(script)
    assert mc == hard_quality.MODEL_CFG
    assert kw == {"steps": 600, "lr": 2e-3, "n_crops": 12, "hard_frac": 0.5,
                  "ppt": (9000, 12000), "seed0": 303}


def test_level_counts_equal_the_jax_step():
    """skip_count counts a batch's level voxels as the jitted JAX step does
    (model output ``n_voxels_per_level``), and sizes capacities by the JAX
    rule."""
    import jax
    import jax.numpy as jnp

    from treelearn_tpu.model import TreeLearn as JTreeLearn
    from treelearn_tpu_torch.ops.voxelize import level_voxel_counts_np
    from treelearn_tpu_torch.tools.skip_count import level_capacities
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest_hard

    data, _ = make_synthetic_forest_hard(n_trees=3, extent=10.0,
                                         points_per_tree=3000,
                                         ground_points=5000, seed=5)
    rng = np.random.default_rng(0)
    m = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    xyz = (data[:, :3] @ m).astype(np.float32)
    shape, nb = [192, 192, 256], 4
    model = JTreeLearn(channels=4, num_blocks=nb, spatial_shape=shape)
    params, state = model.init(np.random.SeedSequence(0))
    n = len(xyz)
    cap = 1 << 15

    @jax.jit
    def counts(c):
        out, _ = model.apply(params, state, c, jnp.ones((n, 1), jnp.float32),
                             jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
                             batch_size=1, voxel_capacity=cap)
        return out["n_voxels_per_level"]

    want = np.asarray(counts(jnp.asarray(xyz)))
    got = level_voxel_counts_np(xyz, 0.1, shape, nb, reciprocal=True)
    np.testing.assert_array_equal(got, want)
    assert level_capacities([94801, 53941, 16194, 3385, 681, 153, 35]) == (
        131072, 131072, 32768, 8192, 1024, 512, 512)
    assert level_capacities([200000, 100000, 300]) == (131072, 131072, 512)


def test_count_skips_on_a_tiny_recipe(monkeypatch):
    """skip_count walks the training stream: with generous capacities no
    step is skipped; with a level-0 capacity below every crop each step is,
    at level 0."""
    from treelearn_tpu_torch.tools.skip_count import count_skips

    recipe = dict(n_crops=3, crop_extent=10.0, hard_frac=0.5, ppt=800)
    model = {"num_blocks": 3, "voxel_size": 0.1}
    ok = count_skips(4, recipe, model, log=lambda m: None)
    assert ok["steps"] == 4 and ok["n_skipped"] == 0
    assert all(c <= k for c, k in zip(ok["stream_max_counts"],
                                      ok["level_capacities"]))
    tight = count_skips(4, recipe, model, log=lambda m: None,
                        voxel_capacity=256)
    assert tight["n_skipped"] == 4
    assert tight["skipped_by_first_level"] == [4, 0, 0]
    assert tight["stream_max_counts"] == ok["stream_max_counts"]


def test_five_stage_on_cpu(tmp_path, monkeypatch):
    """The five stages as subprocesses at a tiny size (channels 8, 2
    levels), each PASS, then the evaluation notebook on what they wrote
    (every code cell, device cpu)."""
    import subprocess

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MPLBACKEND="Agg")
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.five_stage",
         "--device", "cpu", "--work", str(tmp_path / "fs"), "--ppt", "600",
         "--scale", "0.45", "--samples", "4", "--chunk", "12", "--epochs",
         "1", "--examples", "2", "--channels", "8", "--num-blocks", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=400)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for stage in ("gen_train_data", "gen_val_data", "train", "pipeline",
                  "evaluate", "eval notebook"):
        assert any(x.startswith("[PASS") and x.endswith(f"] {stage}")
                   for x in lines), (stage, out.stdout)
    assert lines[-1] == "FIVE-STAGE E2E: ALL PASS"
    assert any(x.startswith("checkpoint: epoch_1.pth") for x in lines)
    assert osp.isfile(tmp_path / "fs" / "eval" / "evaluation_results.pkl")


def test_five_stage_fails_a_broken_stage(tmp_path, monkeypatch, capsys):
    """A stage that exits non-zero prints FAIL and ends the run non-zero."""
    from treelearn_tpu_torch.tools import five_stage

    monkeypatch.setattr(five_stage, "TRAIN_PLOTS", ())
    with pytest.raises(SystemExit) as e:
        five_stage.main(["--device", "cpu", "--work", str(tmp_path / "fs"),
                         "--ppt", "300", "--scale", "0.3", "--samples", "2"])
    assert e.value.code == 1
    assert "[FAIL" in capsys.readouterr().out


def test_notebooks_import_only_the_port():
    from treelearn_tpu_torch.utils.notebook import code_cells

    names = sorted(os.listdir(NB_DIR))
    assert names == ["TreeLearn_Evaluation_Torch.ipynb",
                     "TreeLearn_Pipeline_Torch.ipynb"]
    for name in names:
        cells = code_cells(osp.join(NB_DIR, name))
        assert len(cells) >= 5
        for src in cells:
            for line in src.splitlines():
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1].split(".")[0]
                    assert mod not in ("jax", "jaxlib", "treelearn_tpu",
                                       "pandas", "sklearn"), (name, s)
        assert "torch.cuda.is_available()" in "".join(cells)
        assert "device = 'cpu'" in "".join(cells)


def test_pipeline_notebook_on_a_tiny_plot(tmp_path, monkeypatch):
    """Every code cell of the pipeline notebook in order, on the CPU (no
    card here), with the synthetic plot cut to a few thousand points."""
    import treelearn_tpu_torch.data.synthetic as syn
    from treelearn_tpu_torch.utils.notebook import run_notebook

    make = syn.make_synthetic_forest

    def tiny(**kw):
        return make(n_trees=3, extent=12.0, points_per_tree=1200,
                    ground_points=3000, seed=kw.get("seed", 0))

    monkeypatch.setattr(syn, "make_synthetic_forest", tiny)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.chdir(tmp_path)
    ns = run_notebook(osp.join(NB_DIR, "TreeLearn_Pipeline_Torch.ipynb"))
    assert ns["device"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ns["result"]["n_trees"] >= 0
    assert len(ns["out"]) == len(ns["data"])
    assert osp.isfile(tmp_path / "instances_xy.png")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bench-hard", action="store_true",
                    help="the bench's hard plot (else the script's forest)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
    from treelearn_tpu_torch.tools.oracle_ceiling import (bench_hard_forest,
                                                          hard_forest)

    data = bench_hard_forest() if args.bench_hard else hard_forest()
    _, q, _ = jax_oracle(data, exact=False)
    print(json.dumps({"path": "JAX package, CPU backend (capped "
                      "verticality, XLA components)",
                      "forest": "bench_hard" if args.bench_hard else "script",
                      "n_points": int(len(data)), **q}))


if __name__ == "__main__":
    main()
