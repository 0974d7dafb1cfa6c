"""A whole run of each cell, past the harness's look for a card, on the CPU
at a small size: a sound run comes out correct under the cell's limits, and
a run with the timed path broken underneath (``benchmark/faults.py``) comes
out not correct, once for each fault the cell can have: an answer altered
where it is produced (the forward's offsets, the grouping's trees, the
assignment's labels, the labels written to the saved plot), half of the
batch left
out, a step that leaves its state unchanged.  A one-chip cell has no
exchange between chips to leave out."""

import os

import pytest
import torch

from benchmark import run
from benchmark.faults import FAULTS

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seg():
    torch.set_num_threads(2)
    w = run.read_json(os.path.join(BENCH, "workloads", "plot_60m.json"))
    w["plot"].update(n_trees=5, extent=14.0, points_per_tree=1500,
                     ground_points=4000)
    return run.run_cell("seg_dbscan_60m", 2**31 + 21, 0.1, False, "cpu",
                        run.load_manifest(), work=w, log=lambda s: None)


def _train():
    torch.set_num_threads(2)
    w = run.read_json(os.path.join(BENCH, "workloads", "crops_35m.json"))
    w["crops"].update(n_crops=4, extent=12.0, n_trees=3, points_per_tree=2000,
                      ground_points=4000)
    return run.run_cell("train_crops_35m", 2**31 + 21, 0.1, False, "cpu",
                        run.load_manifest(), work=w, log=lambda s: None)


def _failed(out):
    return [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]


def test_seg_sound():
    out = _seg()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,number", [
    ("forward_altered", "fwd_max"), ("half_batch", "fwd_rms"),
    ("labels_altered", "assign_miss"), ("trees_merged", "group_gap"),
    ("saved_labels_altered", "laz_label_miss")])
def test_seg_fault(monkeypatch, fault, number):
    FAULTS[fault](monkeypatch.setattr)
    out = _seg()
    assert not out["correct"] and number in _failed(out), out["checks"]


def test_train_sound():
    out = _train()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "update_gap"), ("train_half_batch", "loss_gap"),
    ("forward_altered", "fwd_max")])
def test_train_fault(monkeypatch, fault, number):
    FAULTS[fault](monkeypatch.setattr)
    out = _train()
    assert not out["correct"] and number in _failed(out), out["checks"]
