"""The control of each cell at a size a test run holds: the plain reference
in float8 e4m3 operands, one step below the configuration's bfloat16, put in
the program's place, fails at least one of the cell's numbers under its
limits.  (``python3 -m benchmark.control`` reads the same at the cells' own
sizes on the card.)"""

import os

import torch

from benchmark import control, run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _limits(cell):
    return run.read_json(os.path.join(BENCH, "limits", f"{cell}.json"))


def _failed(nums, limits):
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


def test_segment_control_fails(tmp_path):
    from treelearn_tpu_torch.config import ConfigDict

    torch.set_num_threads(2)
    man = run.load_manifest()
    _, centry = run.cell_entries(man, "seg_dbscan_60m")
    work = run.read_json(os.path.join(BENCH, "workloads",
                                      "plot_60m.json"))
    work["plot"].update(n_trees=6, extent=16.0, points_per_tree=1500,
                        ground_points=5000)
    cfg = run.read_json(os.path.join(run.ROOT, centry["file"]))
    for seed in (1, 2**31 + 5, 77):
        nums = control.control_segment(cfg, work, seed, "cpu",
                                       str(tmp_path), ConfigDict)
        assert nums["rows_miss"] == 0
        assert _failed(nums, _limits("seg_dbscan_60m")), (seed, nums)


def test_train_control_fails(tmp_path):
    from treelearn_tpu_torch.config import ConfigDict

    torch.set_num_threads(2)
    man = run.load_manifest()
    _, centry = run.cell_entries(man, "train_crops_35m")
    work = run.read_json(os.path.join(BENCH, "workloads",
                                      "crops_35m.json"))
    work["crops"].update(n_crops=4, extent=12.0, n_trees=3,
                         points_per_tree=2000, ground_points=4000)
    cfg = run.read_json(os.path.join(run.ROOT, centry["file"]))
    for seed in (3, 2**31 + 9, 41):
        nums = control.control_train(cfg, work, seed, "cpu", str(tmp_path),
                                     ConfigDict)
        assert _failed(nums, _limits("train_crops_35m")), (seed, nums)
