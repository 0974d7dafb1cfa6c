"""The PTv3 training cell's benchmark parts on the CPU: its reference copy
(``reference/ptv3.py``, attention in checkpointed blocks) against the
tests' reference, the weights' names against the program's, the operation
and byte counts on a case counted by hand, each new reader on a hand-made
context, and the faults and the float8 control failing the cell's limits
at a small size."""

import os
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import ptv3 as bref
from benchmark.run import metric_reader
from benchmark.yardstick import ptv3_counts as pc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, os.path.join(ROOT, "tests"))

import reference_ptv3 as tref  # noqa: E402

CELL = "train_ptv3_crops_35m"
SMALL = {
    "order": ["z", "z-trans", "hilbert", "hilbert-trans"],
    "stride": [2, 2], "enc_depths": [2, 1, 2], "enc_channels": [16, 32, 64],
    "enc_num_head": [2, 4, 8], "enc_patch_size": [16, 16, 16],
    "dec_depths": [1, 1], "dec_channels": [16, 32], "dec_num_head": [2, 4],
    "dec_patch_size": [16, 16], "mlp_ratio": 4, "qkv_bias": True,
    "drop_path": 0.3, "shuffle_orders": True,
}


def _cloud(seed=0):
    g = np.random.default_rng(seed)
    a = g.uniform([0, 0, 0], [1.6, 1.6, 3.0], (1200, 3))
    b = g.uniform([0, 0, 0], [0.6, 0.6, 1.2], (400, 3)) + 3.0
    xyz = torch.from_numpy(np.concatenate([a, b]).astype(np.float32))
    bid = torch.from_numpy(np.r_[np.zeros(1200), np.ones(400)].astype(
        np.int64))
    return xyz, bid, torch.ones(1600, dtype=torch.bool)


def _draws(xyz, bid, valid, seed=1):
    """Draws of the shape the program records: a permutation a
    serialization, a keep mask (with its tokens' coordinates) a DropPath."""
    g = torch.Generator().manual_seed(seed)
    grid, batch, _ = tref.voxelize(xyz, bid, valid, 2, 0.1)
    out = []
    rates = [float(v) for v in torch.linspace(
        0, 0.3, sum(SMALL["enc_depths"]))]
    drates = [float(v) for v in torch.linspace(
        0, 0.3, sum(SMALL["dec_depths"]))]
    stages = []
    for s in range(3):
        key = torch.unique(torch.cat([batch[:, None], grid >> s], 1), dim=0)
        stages.append(key)
    for s, d in enumerate(SMALL["enc_depths"]):
        out.append(("perm", torch.randperm(4, generator=g).tolist()))
        for i in range(d):
            r = rates[sum(SMALL["enc_depths"][:s]) + i]
            for _ in range(2 if r > 0 else 0):
                n = stages[s].shape[0]
                out.append(("keep", torch.rand(n, generator=g) > r,
                            stages[s]))
    for s in reversed(range(2)):
        rs = drates[sum(SMALL["dec_depths"][:s]):
                    sum(SMALL["dec_depths"][:s + 1])][::-1]
        for r in rs:
            for _ in range(2 if r > 0 else 0):
                n = stages[s].shape[0]
                out.append(("keep", torch.rand(n, generator=g) > r,
                            stages[s]))
    return out


def test_reference_copy_equals_tests_reference():
    """The benchmark's copy, its attention in checkpointed blocks of two
    patches, gives the tests' reference's outputs and gradients."""
    torch.manual_seed(0)
    xyz, bid, valid = _cloud()
    spec = bref.param_spec(SMALL)
    w = bref.make_weights(5, "cpu", spec)
    draws = _draws(xyz, bid, valid)
    outs = []
    for make in (lambda p: tref.Forward(p, SMALL, draws, True),
                 lambda p: bref.CardForward(p, SMALL, draws, True, block=2)):
        p = {k: v.clone().requires_grad_(spec[k][1] in bref.TRAINABLE)
             for k, v in w.items()}
        sem, off = make(p)(xyz, bid, valid, 2, 0.1)
        (sem.square().sum() + off.sum()).backward()
        outs.append((sem, off, {k: v.grad for k, v in p.items()
                                if v.grad is not None}))
    (s0, o0, g0), (s1, o1, g1) = outs
    assert torch.allclose(s0, s1, rtol=1e-5, atol=1e-6)
    assert torch.allclose(o0, o1, rtol=1e-5, atol=1e-6)
    assert set(g0) == set(g1)
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-4, atol=1e-7), k


def test_qkv_slices_cut_queries_keys_values():
    from benchmark.cells.train_ptv3 import qkv_slices

    w = torch.arange(12.0).reshape(6, 2)
    out = qkv_slices({"a.attn.qkv.weight": w, "a.attn.qkv.bias": w[:, 0],
                      "a.attn.proj.bias": w[0]})
    assert sorted(out) == ["a.attn.proj.bias"] + [
        f"a.attn.qkv.{t}.{s}" for t in ("bias", "weight") for s in "kqv"]
    assert torch.equal(out["a.attn.qkv.weight.k"], w[2:4])
    assert torch.equal(out["a.attn.qkv.bias.v"], w[4:, 0])


def test_key_bias_gradient_is_rounding():
    """Softmax ignores a constant added to all of a query's logits, so the
    key rows of every qkv bias take no gradient but float32 rounding, while
    the query and value rows do: the cell's ``compare`` leaves the key rows
    out of ``update_gap``."""
    from benchmark.cells.train_ptv3 import qkv_slices

    xyz, bid, valid = _cloud()
    spec = bref.param_spec(SMALL)
    p = {k: v.clone().requires_grad_(spec[k][1] in bref.TRAINABLE)
         for k, v in bref.make_weights(5, "cpu", spec).items()}
    sem, off = bref.Forward(p, SMALL, _draws(xyz, bid, valid), True)(
        xyz, bid, valid, 2, 0.1)
    (sem.square().sum() + off.sum()).backward()
    g = {k: float(v.norm()) for k, v in qkv_slices(
        {k: v.grad for k, v in p.items() if v.grad is not None}).items()}
    med = float(np.median(list(g.values())))
    bias = [k for k in g if ".qkv.bias." in k]
    assert len(bias) == 3 * (sum(SMALL["enc_depths"])
                             + sum(SMALL["dec_depths"]))
    for k in bias:
        assert (g[k] < 1e-5 * med) == k.endswith(".k"), (k, g[k] / med)


def test_fp8_reference_moves_the_outputs():
    xyz, bid, valid = _cloud(1)
    spec = bref.param_spec(SMALL)
    w = bref.make_weights(6, "cpu", spec)
    draws = _draws(xyz, bid, valid, 2)
    a = bref.CardForward(w, SMALL, draws, True)(xyz, bid, valid, 2, 0.1)[0]
    b = bref.CardForward(w, SMALL, draws, True, quant="fp8")(
        xyz, bid, valid, 2, 0.1)[0]
    gap = float((a - b).norm() / a.norm())
    assert 1e-3 < gap < 1.0


def test_weight_names_are_the_programs():
    from treelearn_tpu_torch.model import TreeLearn

    cfg = run.read_json(os.path.join(ROOT, "benchmark", "configs",
                                     "ptv3_treelearn_train.json"))
    for ptv3 in (cfg["model"]["ptv3"], SMALL):
        sd = TreeLearn(backbone="ptv3", ptv3=dict(ptv3)).state_dict()
        spec = bref.param_spec(ptv3)
        assert set(sd) == set(spec)
        assert all(tuple(sd[k].shape) == tuple(spec[k][0]) for k in sd)


def test_published_config_is_pointcepts_base():
    cfg = run.read_json(os.path.join(ROOT, "benchmark", "configs",
                                     "ptv3_treelearn_train.json"))
    p = cfg["model"]["ptv3"]
    assert p["enc_channels"] == [32, 64, 128, 256, 512]
    assert p["enc_depths"] == [2, 2, 2, 6, 2]
    assert p["enc_num_head"] == [2, 4, 8, 16, 32]
    assert p["dec_channels"] == [64, 64, 128, 256]
    assert p["dec_num_head"] == [4, 4, 8, 16]
    assert p["enc_patch_size"] == [1024] * 5
    assert p["dec_patch_size"] == [1024] * 4
    spec = bref.param_spec(p)
    n = sum(int(np.prod(s)) for s, kind, _ in spec.values()
            if kind in bref.TRAINABLE)
    assert 46_000_000 < n < 46_300_000


# -- counts ------------------------------------------------------------------

ONE = {"enc_depths": [1], "enc_channels": [32], "enc_num_head": [2],
       "enc_patch_size": [4], "dec_depths": [], "dec_channels": [],
       "dec_num_head": [], "dec_patch_size": [], "mlp_ratio": 4}


def test_counts_one_element_two_patches_one_pad():
    """7 tokens, patch 4: K = 4, two patches, one pad row; one block of
    32 channels in 2 heads of 16."""
    lv = {"tokens": [7], "nnz": [30], "elems": [[7]], "stem_nnz": 40,
          "points": 10}
    assert pc.patches([7], 4) == (2, 4)
    fo, bo, fb, bb = pc.attention_counts(lv, ONE)
    assert fo == 4 * 2 * 2 * 4 * 4 * 16            # 4 P H K^2 d
    assert bo == 10 * 2 * 2 * 4 * 4 * 16
    rows = 8
    assert fb == 4 * rows * 32 * 2 + rows * 2 * 4
    assert bb == 8 * rows * 32 * 2 + rows * 2 * 4
    # stem 2 * 40 * 4 * 32, xCPE 2 * 30 * 32 * 32, linears 2 * 7 * 32^2 * 13,
    # attention 4096, heads 2 * 10 * (32 * 32 + 32 * k) for k = 2, 3
    want = (2 * 40 * 4 * 32 + 2 * 30 * 32 * 32 + 2 * 7 * 32 * 32 * 13
            + 4096 + 2 * 10 * (32 * 32 + 64) + 2 * 10 * (32 * 32 + 96))
    assert pc.forward_flops(lv, ONE) == want
    assert pc.train_step_flops(lv, ONE) == 3 * want
    assert [c[:4] for c in pc.convs(lv, ONE)] == [(7, 40, 125, 4),
                                                   (7, 30, 27, 32)]


def test_patch_count_takes_the_smaller_element():
    assert pc.patches([3000, 700], 1024) == (5 + 1, 700)
    assert pc.patches([0, 10], 16) == (1, 10)
    assert pc.patches([], 16) == (0, 0)


def test_published_blocks():
    cfg = run.read_json(os.path.join(ROOT, "benchmark", "configs",
                                     "ptv3_treelearn_train.json"))
    b = pc.blocks(cfg["model"]["ptv3"])
    assert len(b) == 22 and b[0] == (0, 32, 2, 1024) and b[-1][:3] == (
        3, 256, 16)


# -- readers -----------------------------------------------------------------

WIN = (1_000, 1_000_000_001)
LV = {"tokens": [4000, 1000], "nnz": [40000, 12000], "elems": [[2500, 1500],
      [600, 400]], "stem_nnz": 90000, "points": 9000}
PT = {"enc_depths": [1, 1], "enc_channels": [32, 64], "enc_num_head": [2, 4],
      "enc_patch_size": [1024, 1024], "dec_depths": [1],
      "dec_channels": [64], "dec_num_head": [4], "dec_patch_size": [1024],
      "mlp_ratio": 4}


def _ctx(spans=(), device=()):
    return {"cfg": {"model": {"ptv3": PT}}, "window_s": 1.0, "win": WIN,
            "steps": [{}, {}], "levels_per_step": [LV, LV],
            "events": {"spans": sorted(spans), "device": sorted(device)},
            "trace": {"window_s": 1.0, "busy_s": 0.25}}


@pytest.mark.parametrize("metric,span", [("attn_ms.ptv3", "ptv3.attn"),
                                         ("serialize_ms.ptv3",
                                          "ptv3.serialize")])
def test_span_readers(metric, span):
    read = metric_reader(metric)
    ctx = _ctx([(2_000, 3_002_000, span), (5_000_000, 6_000_000, span),
                (500, 1_500, span), (7_000_000, 8_000_000, "other")])
    # 3 + 1 ms of ranges inside the window, over two steps
    assert read(ctx) == pytest.approx(2.0)
    assert read(_ctx()) is None
    assert read({"win": WIN}) is None


def test_backward_reader():
    read = metric_reader("backward_ms.ptv3")
    ctx = _ctx([(2_000_000, 202_000_000, "step.backward"),
                (300_000_000, 400_000_000, "step.backward")])
    assert read(ctx) == pytest.approx(150.0, rel=1e-6)
    assert read(_ctx()) is None


def test_idle_reader():
    assert metric_reader("idle_share.ptv3")(_ctx()) == pytest.approx(75.0)
    assert metric_reader("idle_share.ptv3")({}) is None


def test_mfu_reader():
    read = metric_reader("mfu.ptv3")
    want = 100 * 2 * pc.train_step_flops(LV, PT) / 989e12
    assert read(_ctx()) == pytest.approx(want)
    assert read(dict(_ctx(), levels_per_step=[])) is None
    assert read(dict(_ctx(), cfg={"model": {"channels": 32}})) is None


@pytest.mark.parametrize("metric,kernel,least", [
    ("roofline.patch_attn.ptv3", "void pytorch_flash::flash_fwd_kernel<X>(Y)",
     lambda: pc.attention_least_s(LV, PT)),
    ("roofline.subm_conv.ptv3",
     "(anonymous namespace)::subm_conv_wgmma_kernel",
     lambda: pc.conv_least_s_step(LV, PT))])
def test_roofline_readers(metric, kernel, least):
    read = metric_reader(metric)
    ctx = _ctx(device=[(10_000, 10_000 + 2_000_000, kernel),
                       (20_000_000, 21_000_000, "other_kernel")])
    assert read(ctx) == pytest.approx(100 * 2 * least() / 2e-3)
    assert read(_ctx()) is None
    assert read({"win": WIN}) is None


# -- faults and the control at a small size ----------------------------------

def _small_run(monkeypatch, fault=None, log=None):
    from benchmark.faults import FAULTS
    from benchmark.faults_ptv3 import FAULTS as PT_FAULTS

    torch.set_num_threads(2)
    if fault:
        dict(FAULTS, **PT_FAULTS)[fault](monkeypatch.setattr)
    man = run.load_manifest()
    _, centry = run.cell_entries(man, CELL)
    w = run.read_json(os.path.join(BENCH, "workloads", "crops_35m_ptv3.json"))
    w["crops"].update(n_crops=4, extent=12.0, n_trees=3, points_per_tree=2000,
                      ground_points=4000)
    w["first_steps"] = 2
    cfg = run.read_json(os.path.join(ROOT, centry["file"]))
    cfg["model"]["ptv3"].update(SMALL)
    return run.run_cell(CELL, 2**31 + 21, 0.1, False, "cpu", man, work=w,
                        cfg=cfg, log=log or (lambda s: None))


def _failed(out):
    return [k for k, c in out["checks"].items()
            if c["limit"] is None or not c["value"] <= c["limit"]]


@pytest.fixture(scope="module")
def sound():
    mp = pytest.MonkeyPatch()
    try:
        return _small_run(mp)
    finally:
        mp.undo()


def test_small_cell_sound(sound):
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["loader_miss"]["value"] == 0


@pytest.mark.parametrize("fault", ["skip_xcpe", "fp8_operands",
                                   "forward_altered", "state_unchanged"])
def test_small_cell_fault_fails(monkeypatch, fault):
    out = _small_run(monkeypatch, fault)
    assert not out["correct"] and _failed(out), (fault, out["checks"])


def test_update_gap_reads_leaves_that_move_after_the_first_step(
        monkeypatch):
    """A first batch without offset targets gives the offset head no
    gradient in the first step; ``update_gap`` still compares it, since it
    moves in the second (the batch's own labels are then off, so
    ``loader_miss`` flags it)."""
    from benchmark.cells import train_ptv3

    forever = train_ptv3._forever

    def first_without_offsets(loader):
        it = forever(loader)
        b = next(it)
        yield dict(b, masks_off=np.zeros_like(np.asarray(b["masks_off"])))
        yield from it

    monkeypatch.setattr(train_ptv3, "_forever", first_without_offsets)
    logs = []
    out = _small_run(monkeypatch, log=logs.append)
    excluded = next(s for s in logs if s.startswith("info excluded_leaves"))
    assert "offset_linear.0.weight" not in excluded
    assert "semantic_linear.0.bias" in excluded
    checks = out["checks"]
    assert checks["update_gap"]["value"] <= checks["update_gap"]["limit"]
    assert checks["loader_miss"]["value"] > 0

