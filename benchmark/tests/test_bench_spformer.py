"""The SPFormer training cell's benchmark parts on the CPU: the operation
and byte counts on a case counted by hand, each new reader on a hand-made
context, and, at a small size in float32 (where the program meets the
reference to rounding: bf16 on a 16-query decoder over a few thousand keys
moves AdamW's sign noise on the U-Net's BatchNorm shifts past the limit
that the published size sets), the cell sound while each fault and the
float8 control fail the cell's limits."""

import os
import tempfile

import pytest
import torch

from benchmark import run
from benchmark.run import metric_reader
from benchmark.yardstick import counts
from benchmark.yardstick import spformer_counts as sc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "benchmark")
CELL = "train_spformer_crops_35m"
SPF = {"num_query": 4, "d_model": 8, "nhead": 2, "hidden_dim": 16,
       "num_layer": 2}
MODEL = {"channels": 2, "num_blocks": 2, "spformer": SPF}
LV = {"voxels": [10, 3], "nnz": [40, 9], "points": 30, "elems": [6, 4]}
WIN = (1_000, 1_001_000_000)
SMALL = {"num_query": 16, "d_model": 32, "nhead": 4, "hidden_dim": 64,
         "num_layer": 2}


def test_attention_bytes_by_hand():
    # Q 4, K 6, D 8, H 2: q and o 64 B each, k and v 96 B each, mask 48 B,
    # statistics 32 B; backward reads q, k, v, o, dO, mask, statistics and
    # writes dq, dk, dv
    assert sc.attention_bytes(4, 6, 8, 2) == (64 + 192 + 48 + 64 + 32,
                                              3 * 64 + 192 + 48 + 32
                                              + 64 + 192)


def test_attention_least_by_hand():
    fb = sum(sc.attention_bytes(4, k, 8, 2)[0] for k in (6, 4))
    bb = sum(sc.attention_bytes(4, k, 8, 2)[1] for k in (6, 4))
    want = 0.0
    for n in (20, 7):
        want += max(4 * 8 * n / 989e12, fb / 3.35e12)
        want += max(10 * 8 * n / 989e12, bb / 3.35e12)
    assert sc.attention_least_s([LV], [20, 7], SPF) == pytest.approx(want)


def test_decoder_flops_by_hand():
    # V 10 keys of C 2 in B 2 elements, Q 4, D 8, FFN 16, 2 layers
    proj = 2 * 10 * 2 * 8 + 2 * 10 * (2 * 8 + 64)
    layer = (2 * 2 * 4 * 64 + 2 * 10 * 2 * 64 + 2 * 2 * 4 * 64
             + 2 * 2 * 4 * 3 * 64 + 4 * 2 * 4 * 4 * 8 + 2 * 2 * 4 * 64
             + 2 * 2 * 4 * 2 * 8 * 16)
    pred = 2 * 2 * 4 * (64 + 16) + 2 * 2 * 4 * (64 + 8) + 2 * 4 * 8 * 10
    assert sc.decoder_dense_flops(LV, SPF, 2) == proj + 2 * layer + 3 * pred
    unet = counts.analytic_model_flops([10, 3], [40, 9], 0, channels=2,
                                       num_blocks=2)
    assert sc.train_flops([LV], [20, 7], MODEL) == pytest.approx(
        3 * (unet + proj + 2 * layer + 3 * pred + 4 * 8 * 27))


def test_open_pairs_of():
    c = {"spformer.open_pairs.l1": 5, "spformer.open_pairs.l2": 3,
         "spformer.keys": 9}
    assert sc.open_pairs_of(c) == [5, 3]
    assert sc.open_pairs_of({}) == []


def _ctx(spans=(), device=(), opens=(20, 7)):
    return {"cfg": {"model": MODEL}, "window_s": 1.0, "win": WIN,
            "steps": [{}, {}], "levels_per_step": [LV, LV],
            "counters": {f"spformer.open_pairs.l{i + 1}": n
                         for i, n in enumerate(opens)},
            "events": {"spans": sorted(spans), "device": sorted(device)}}


@pytest.mark.parametrize("metric,span", [
    ("decoder_ms.spformer", "spformer.decoder"),
    ("match_ms.spformer", "spformer.match")])
def test_span_readers(metric, span):
    read = metric_reader(metric)
    ctx = _ctx([(2_000, 3_002_000, span), (5_000_000, 6_000_000, span),
                (500, 1_500, span), (7_000_000, 8_000_000, "other")])
    # 3 + 1 ms of ranges inside the window, over two steps
    assert read(ctx) == pytest.approx(2.0)
    assert read(_ctx()) is None
    assert read({"win": WIN}) is None


def test_mfu_reader():
    read = metric_reader("mfu.spformer")
    want = 100 * sc.train_flops([LV, LV], [20, 7], MODEL) / 989e12
    assert read(_ctx()) == pytest.approx(want)
    assert read(_ctx(opens=())) is None
    assert read(dict(_ctx(), levels_per_step=[])) is None
    assert read(dict(_ctx(), cfg={"model": {"channels": 32}})) is None


def test_roofline_reader():
    read = metric_reader("roofline.mask_attn.spformer")
    kern = ("void fmha_cutlassF_bf16_aligned_64x64_rf_sm80"
            "(PyTorchMemEffAttention::AttentionKernel<X>::Params)")
    ctx = _ctx(device=[(10_000, 10_000 + 2_000_000, kern),
                       (20_000_000, 21_000_000, "flash_fwd_kernel")])
    want = 100 * sc.attention_least_s([LV, LV], [20, 7], SPF) / 2e-3
    assert read(ctx) == pytest.approx(want)
    assert read(_ctx()) is None
    assert read(_ctx(device=ctx["events"]["device"], opens=())) is None


# -- the cell, its faults and the control at a small size ---------------------

def _inputs():
    man = run.load_manifest()
    _, centry = run.cell_entries(man, CELL)
    w = run.read_json(os.path.join(BENCH, "workloads",
                                   "crops_35m_spformer.json"))
    w["crops"].update(n_crops=3, extent=8.0, n_trees=3, points_per_tree=800,
                      ground_points=1500)
    cfg = run.read_json(os.path.join(ROOT, centry["file"]))
    cfg["model"]["spformer"].update(SMALL)
    cfg["fp16"] = False
    return man, w, cfg


def _small_run(monkeypatch, fault=None):
    from benchmark.faults import FAULTS
    from benchmark.faults_spformer import FAULTS as SPF_FAULTS

    torch.set_num_threads(2)
    if fault:
        dict(FAULTS, **SPF_FAULTS)[fault](monkeypatch.setattr)
    man, w, cfg = _inputs()
    return run.run_cell(CELL, 2**31 + 21, 0.1, False, "cpu", man, work=w,
                        cfg=cfg, log=lambda s: None)


def _failed(checks):
    return [k for k, c in checks.items()
            if c["limit"] is None or not c["value"] <= c["limit"]]


def test_small_cell_sound(monkeypatch):
    out = _small_run(monkeypatch)
    assert out["correct"], out["checks"]
    assert out["checks"]["match_gap"]["value"] < 1e-3


@pytest.mark.parametrize("fault", [
    "attn_mask_off", "other_element_keys", "assign_by_index",
    "non_object_weight_one", "drop_aux_losses", "state_unchanged"])
def test_small_cell_fault_fails(monkeypatch, fault):
    out = _small_run(monkeypatch, fault)
    assert not out["correct"] and _failed(out["checks"]), (fault,
                                                          out["checks"])


def test_small_control_fails_forward():
    """The reference in float8 in the program's place fails ``fwd_rms`` or
    ``fwd_max``."""
    from benchmark.control_spformer import control
    from treelearn_tpu_torch.config import ConfigDict

    torch.set_num_threads(2)
    man, w, cfg = _inputs()
    limits = run.read_json(os.path.join(BENCH, "limits", f"{CELL}.json"))
    with tempfile.TemporaryDirectory() as d:
        nums = control(cfg, w, 2**31 + 21, "cpu", d, ConfigDict)
    _, checks = run.judge(nums, limits)
    assert {"fwd_rms", "fwd_max"} & set(_failed(checks)), checks
