"""The port's evaluation protocol (treelearn_tpu_torch/eval,
train/selftrain.py's summaries, tools/evaluate.py) against the JAX package.

The port returns column dicts where the JAX package returns DataFrames;
pandas is imported here only, to hold ``pd.DataFrame.from_dict`` of the
port's tables to the JAX frames.
"""

import importlib.util
import os.path as osp
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import treelearn_tpu.eval.evaluation as jev
import treelearn_tpu_torch.eval.evaluation as pev

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _random_labels(seed=0, n=5000, n_gt=10, n_pred=12):
    rng = np.random.default_rng(seed)
    gt = rng.integers(-1, n_gt, n)
    pred = np.where(rng.random(n) < 0.8,
                    np.clip(gt + rng.integers(0, 2, n), 0, n_pred - 1),
                    rng.integers(0, n_pred, n))
    pred[gt == -1] = rng.integers(0, n_pred, (gt == -1).sum())
    return gt, pred


def _undersegmented():
    gt = np.concatenate([np.zeros(100), np.ones(100),
                         np.full(60, 2)]).astype(int)
    pred = np.concatenate([np.zeros(100), np.ones(160)]).astype(int)
    return gt, pred


def _perfect():
    rng = np.random.default_rng(1)
    gt = rng.integers(-1, 8, 3000)
    pred = gt.copy()
    pred[gt == -1] = rng.integers(0, 8, (gt == -1).sum())
    return gt, pred


CASES = {"random0": lambda: _random_labels(0), "random3": lambda: _random_labels(3),
         "undersegmented": _undersegmented, "perfect": _perfect}


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exports_match_jax():
    import treelearn_tpu.eval as je
    import treelearn_tpu_torch.eval as pe

    names = [n for n in dir(je) if not n.startswith("_") and n != "evaluation"]
    assert names and all(hasattr(pe, n) for n in names)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("non_tree", [-1, 0])
def test_contingency_and_detections_equal_jax(case, non_tree):
    gt, pred = CASES[case]()
    _equal(pev.contingency_matrices(gt, pred, non_tree),
           jev.contingency_matrices(gt, pred, non_tree))
    _equal(pev.get_detections(gt, pred, 0.5, non_tree),
           jev.get_detections(gt, pred, 0.5, non_tree))


@pytest.mark.parametrize("case", list(CASES))
def test_detection_failures_and_summary_equal_jax(case):
    gt, pred = CASES[case]()
    mg, mp, iou, prec, rec = jev.get_detections(gt, pred, 0.5, -1)
    args = (mg, mp, np.arange(gt.max() + 1), np.arange(pred.max() + 1), iou,
            prec, rec, 0.5, 0.5)
    ours = pev.get_detection_failures(*args)
    _equal(ours, jev.get_detection_failures(*args))
    nm_gts, nm_preds, nmp_gt = ours[:3]
    filtered = np.array([p for p, g in zip(nm_preds, nmp_gt)
                         if not np.isnan(g)])
    assert (pev.detection_summary(mg, nm_gts, mp, filtered)
            == jev.detection_summary(mg, nm_gts, mp, filtered))


def test_detection_failures_refuse_zero_iou_match():
    gt, pred = _undersegmented()
    _, _, iou, prec, rec = jev.get_detections(gt, pred, 0.5, -1)
    with pytest.raises(ValueError, match="zero iou"):
        pev.get_detection_failures(np.array([2]), np.array([0]), np.arange(3),
                                   np.arange(2), iou, prec, rec, 0.5, 0.5)


@pytest.mark.parametrize("tp,fp,fn", [(0, 0, 0), (5, 0, 0), (0, 3, 0),
                                      (0, 0, 4), (7, 2, 1)])
def test_segmentation_metrics_equal_jax(tp, fp, fn):
    _equal(pev.get_segmentation_metrics(tp, fp, fn),
           jev.get_segmentation_metrics(tp, fp, fn))
    rng = np.random.default_rng(tp + 10 * fp + 100 * fn)
    a, b = rng.random(200) < 0.4, rng.random(200) < 0.5
    assert pev.get_eval_components(a, b) == jev.get_eval_components(a, b)


def _segmentation_inputs(seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (4000, 3))
    gt = rng.integers(0, 6, 4000)
    pred = np.where(rng.random(4000) < 0.85, gt, rng.integers(0, 7, 4000))
    mapping_gt = {i: 10 + i for i in range(6)}
    mapping_pred = {i: 20 + i for i in range(7)}
    unique_gts = np.arange(6)
    unique_preds = np.array([0, 1, 2, 3, 6, 5])
    return pred, gt, unique_gts, unique_preds, coords, mapping_gt, mapping_pred


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("intvls", [[0, 0.5, 1], [round(0.1 * i, 1)
                                                  for i in range(11)]],
                         ids=["two_bins", "ten_bins"])
def test_partition_tables_equal_jax_frames(seed, intvls):
    pred, gt, ug, up, coords, mg, mp = _segmentation_inputs(seed)
    ours = pev.evaluate_instance_segmentation(pred, gt, ug, up, coords, mg,
                                              mp, intvls, intvls)
    theirs = jev.evaluate_instance_segmentation(pred, gt, ug, up, coords, mg,
                                                mp, intvls, intvls)
    for o, t in zip(ours, theirs):
        assert isinstance(o, dict)
        assert list(o) == list(t.columns)
        pd.testing.assert_frame_equal(pd.DataFrame.from_dict(o), t)
    for fn in ("evaluate_xy_partition", "evaluate_z_partition"):
        pd.testing.assert_frame_equal(
            pd.DataFrame.from_dict(getattr(pev, fn)(pred, gt, ug, up, coords,
                                                    intvls, mg, mp)),
            getattr(jev, fn)(pred, gt, ug, up, coords, intvls, mg, mp))
    pd.testing.assert_frame_equal(
        pd.DataFrame.from_dict(pev.evaluate_no_partition(pred, gt, ug, up,
                                                         mg, mp)),
        jev.evaluate_no_partition(pred, gt, ug, up, mg, mp))
    for g in range(6):
        ind = gt == g
        _equal(pev._xy_normalized(coords, ind), jev._xy_normalized(coords, ind))
        _equal(pev._z_normalized(coords, ind), jev._z_normalized(coords, ind))
    pd.testing.assert_frame_equal(
        pd.DataFrame.from_dict(pev._partition_eval(
            pred, gt, ug, up, coords, intvls, mg, mp, pev._z_normalized)),
        jev._partition_eval(pred, gt, ug, up, coords, intvls, mg, mp,
                            jev._z_normalized))
    assert pev.evaluate_instance_segmentation(
        pred, gt, ug, up, coords, mg, mp, None, None)[1:] == (None, None)


def _forest(seed=2):
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=8, extent=25, points_per_tree=700,
                                    ground_points=3000, seed=seed)
    return data


def _predicted(data, seed=0):
    """A flawed prediction of ``data``'s trees: tree 2 merged into tree 1,
    tree 5 split in two by x, tree 7 missed, a few ground points claimed;
    the points jittered by 1 cm and every other one kept."""
    rng = np.random.default_rng(seed)
    lab = data[:, 3].astype(np.int64)
    pred = np.where(lab > 0, lab + 40, 0)
    pred[lab == 2] = 41
    five = lab == 5
    pred[five & (data[:, 0] > np.median(data[five, 0]))] = 99
    pred[lab == 7] = 0
    ground = np.flatnonzero(lab == 0)
    pred[rng.choice(ground, 50, replace=False)] = 43
    keep = np.arange(len(data)) % 2 == 0
    pts = data[keep, :3] + rng.normal(0, 0.01, (int(keep.sum()), 3))
    return pts.astype(np.float32), pred[keep]


def _pointwise_npz(path, seed=0):
    data = _forest(seed)
    _, pred = _predicted(np.repeat(data, 2, axis=0), seed)
    np.savez(path, coords=data[:, :3].astype(np.float32),
             instance_labels=data[:, 3].astype(np.int64),
             instance_preds=pred.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_selftrain_summaries_equal_jax(tmp_path, seed):
    from treelearn_tpu.train.selftrain import (
        detection_f1_from_pointwise as jax_f1,
        segmentation_partition_summary as jax_seg)
    from treelearn_tpu_torch.train.selftrain import (
        detection_f1_from_pointwise, segmentation_partition_summary)

    path = str(tmp_path / "pointwise_results.npz")
    _pointwise_npz(path, seed)
    ours = detection_f1_from_pointwise(path)
    assert ours == jax_f1(path)
    assert 0 < ours["f1_score"] < 100
    assert segmentation_partition_summary(path) == jax_seg(path)


def _jax_evaluate():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_evaluate", osp.join(REPO, "tools", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.evaluate


def _eval_config(tmp_path):
    data = _forest()
    pts, pred = _predicted(data)
    gt_path, pred_path = str(tmp_path / "gt.npz"), str(tmp_path / "pred.npz")
    np.savez(gt_path, points=data[:, :3].astype(np.float32),
             labels=data[:, 3])
    np.savez(pred_path, points=pts, labels=pred.astype(np.float64))
    with open(osp.join(REPO, "configs", "evaluation", "evaluate.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["paths"] = {"gt_forest_path": gt_path, "pred_forest_path": pred_path}
    return cfg


def test_evaluate_tool_equals_jax_tool(tmp_path):
    """tools/evaluate.py of the port (CPU) and of the JAX package on the same
    ground-truth and predicted clouds: equal summary numbers, equal
    failure tables, partition tables equal as frames, the same pickle keys."""
    from treelearn_tpu.config import ConfigDict as JaxConfig
    from treelearn_tpu_torch.tools.evaluate import main

    cfg = _eval_config(tmp_path)
    cfg_path = str(tmp_path / "evaluate.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ours = main(["--config", cfg_path, "--work_dir", str(tmp_path / "port"),
                 "--device", "cpu"])
    jcfg = JaxConfig.from_dict(dict(cfg, work_dir=str(tmp_path / "jax")))
    theirs = _jax_evaluate()(jcfg)

    with open(tmp_path / "port" / "evaluation_results.pkl", "rb") as f:
        pickled = pickle.load(f)
    assert list(pickled) == list(theirs)
    for part in ("detection_results", "segmentation_results"):
        assert list(pickled[part]) == list(theirs[part])
    det, jdet = ours["detection_results"], theirs["detection_results"]
    for k in jdet:
        _equal(det[k], jdet[k])
    assert 0 < det["f1_score"] < 100 and det["commission_error_rate"] > 0
    seg, jseg = ours["segmentation_results"], theirs["segmentation_results"]
    for k in ("precision", "recall", "iou"):
        assert seg[k] == jseg[k]
    for k in ("no_partition", "xy_partition", "z_partition"):
        assert isinstance(seg[k], dict)
        pd.testing.assert_frame_equal(pd.DataFrame.from_dict(seg[k]), jseg[k])
    assert osp.isfile(tmp_path / "port"
                      / "pred_forest_propagated_to_gt_pointcloud.las")


def test_evaluate_means_skip_nan(tmp_path):
    """A partition bin that no point reaches is NaN in the tables; the
    summary means skip it as the JAX tool's DataFrame means do."""
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.tools.evaluate import evaluate

    cfg = _eval_config(tmp_path)
    cfg["partitions"] = {"xy_partition": [0, 0.5, 1, 50, 60],
                         "z_partition": None}
    res = evaluate(ConfigDict.from_dict(dict(cfg, work_dir=str(tmp_path))),
                   device="cpu")
    seg = res["segmentation_results"]
    assert np.isnan(seg["xy_partition"]["iou_intvl50_60"]).all()
    assert seg["z_partition"] is None
    assert all(np.isfinite(seg[k]) for k in ("precision", "recall", "iou"))


def test_evaluate_raises_without_cuda(tmp_path):
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.tools.evaluate import evaluate

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _eval_config(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(ConfigDict.from_dict(dict(cfg, work_dir=str(tmp_path))))
