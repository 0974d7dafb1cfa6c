"""The port's profilers against the JAX package's (CPU): the FLOP count equal
to the JAX function, each tool's ``main()`` at a tiny size with
``--device cpu``, ``microbench_conv.make_case`` against the JAX one, the
named spans and the trace summary."""

import ast
import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.mark.parametrize("with_nnz", [False, True])
@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("levels", [2, 7])
def test_analytic_model_flops_equals_jax(levels, kernel_size, with_nnz):
    from treelearn_tpu.model.network import analytic_model_flops as jax_flops
    from treelearn_tpu_torch.model.network import analytic_model_flops

    rng = np.random.default_rng(levels * 10 + kernel_size)
    v = rng.integers(100, 500000, levels)
    nnz = ((v * rng.uniform(3, kernel_size ** 3, levels)).astype(np.int64)
           if with_nnz else None)
    for channels, n_points, reps in ((32, 968000, 2), (8, 1234, 1)):
        kw = dict(channels=channels, num_blocks=levels, block_reps=reps,
                  kernel_size=kernel_size, rule_nnz_per_level=nnz)
        got = analytic_model_flops(list(v), n_points, **kw)
        assert got == jax_flops(v, n_points, **kw)
        assert got > 0


def _jax_make_case():
    """The JAX tool's ``make_case``, taken from its source: importing
    tools/microbench_conv.py would set a process-wide JAX cache
    directory."""
    from treelearn_tpu.ops.sparse import build_subm_rulebook, grid_from_coords

    path = osp.join(REPO, "tools", "microbench_conv.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_case")
    scope = {"np": np, "jnp": jnp, "grid_from_coords": grid_from_coords,
             "build_subm_rulebook": build_subm_rulebook}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"),
         scope)
    return scope["make_case"]


def test_make_case_matches_jax():
    """Same seed, same voxel keys, features, weights and rule."""
    from treelearn_tpu_torch.tools.microbench_conv import make_case

    v_cap, cin, cout = 2048, 32, 32
    jgrid, jrule, jfeats, jw, jn = _jax_make_case()(v_cap, cin, cout)
    grid, rule, feats, w, n = make_case(v_cap, cin, cout)
    assert n == jn == grid.n_active
    np.testing.assert_array_equal(grid.keys.numpy(),
                                  np.asarray(jgrid.keys)[:n])
    np.testing.assert_array_equal(rule.numpy(), np.asarray(jrule)[:, :n])
    np.testing.assert_array_equal(
        feats.float().numpy(), np.asarray(jfeats.astype(jnp.float32))[:n])
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))


def test_profile_model_main_cpu(tmp_path, capsys):
    from treelearn_tpu_torch.tools import profile_model

    res = profile_model.main(["--device", "cpu", "--points", "4000",
                              "--levels", "2", "--reps", "1", "--trace",
                              str(tmp_path)])
    out = capsys.readouterr().out
    for row in ("voxelize:", "voxelize+plans:", "full forward:", "  L0: V=",
                "  L1: V=", "MFU not measured (CPU)", "host ms per part:",
                "device idle share of the window: not measured"):
        assert row in out, row
    assert len(res["levels"]) == 2 and res["forward_ms"] > 0
    assert res["mfu"] is None and res["flops"] > 0
    parts = res["trace"]["parts"]
    for name in ("harvest.h2d", "harvest.forward", "harvest.d2h",
                 "harvest.host", "voxelize", "plans", "plans.L0.rulebook",
                 "plans.L0.downsample", "unet.L0", "unet.L1", "heads",
                 "devoxelize", "counts"):
        assert name in parts, name
    assert parts["unet.L0"][0] == 3    # the input conv and the level's halves
    assert osp.isfile(tmp_path / "forward.trace.json")


def test_profile_step_main_cpu(capsys):
    from treelearn_tpu_torch.tools import profile_step

    res = profile_step.main(["--device", "cpu", "--points", "4000",
                             "--levels", "2", "--reps", "1"])
    out = capsys.readouterr().out
    for row in ("voxelize            :", "n_voxels_per_level =",
                "voxelize + plans    :", "full forward (float32):"):
        assert row in out, row
    assert res["voxels"] == res["voxels_per_level"][0]


def test_profile_step_train_main_cpu(tmp_path, capsys):
    from treelearn_tpu_torch.tools import parse_trace, profile_step

    res = profile_step.main([
        "--train", "--device", "cpu", "--levels", "2", "--channels", "8",
        "--steps", "2", "--crops", "1", "--crop-extent", "8", "--ppt", "300",
        "400", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "first step" in out and "median of steps 2..2" in out
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    parts = res["trace"]["parts"]
    for name in ("step.h2d", "step.forward", "step.loss", "step.backward",
                 "step.clip", "step.optimizer", "voxelize", "unet.L1"):
        assert name in parts, name
    again = parse_trace.main([str(tmp_path / "train_step.trace.json")])
    assert again["parts"] == parts
    assert "host ms per part:" in capsys.readouterr().out


def test_profile_kernels_main_cpu(capsys):
    from treelearn_tpu_torch.tools import profile_kernels

    res = profile_kernels.main(["--device", "cpu", "--points", "4000",
                                "--reps", "1"])
    out = capsys.readouterr().out
    for row in ("voxelize_points (4000 pts)", "rulebook, plain",
                "build_downsample (torch.unique)", "build_level_plans",
                "subm conv V=", "BN+ReLU (V, 32)", "devoxelize gather"):
        assert row in out, row
    assert set(res["convs"]) == {32, 64}


def test_microbench_conv_main_cpu(capsys):
    from treelearn_tpu_torch.tools import microbench_conv

    res = microbench_conv.main(["2048", "32", "--device", "cpu", "--reps",
                                "1"])
    out = capsys.readouterr().out
    assert "plain   :" in out and "kernel 2:" in out and "rel_err" in out
    assert res["rel_err"] < 0.05 and res["live"] == int(2048 * 0.35)


def test_spans_change_nothing():
    """The forward gives the same bits with no listener, under the profiler
    and under a span timer, and leaves the state_dict as it was."""
    from torch.profiler import ProfilerActivity, profile

    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.utils.trace import SpanTimer

    rng = np.random.default_rng(0)
    n = 600
    args = (torch.from_numpy(rng.uniform(0, 4, (n, 3)).astype(np.float32)),
            torch.zeros(n, 1), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool))
    model = TreeLearn(channels=8, num_blocks=2).init(0).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        plain = model(*args, batch_size=1)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = model(*args, batch_size=1)
        with SpanTimer("cpu") as timer:
            timed = model(*args, batch_size=1)
    for k in ("semantic_prediction_logits", "offset_predictions",
              "backbone_feats"):
        assert torch.equal(plain[k], traced[k]) and torch.equal(plain[k],
                                                                timed[k])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    split = timer.summary()
    assert split["unet.L0"][0] == 3 and split["unet.L1"][0] == 1
    assert all(dev is None and host >= 0 for _, host, dev in split.values())


def test_summarize_recorded_cpu_trace(tmp_path):
    from treelearn_tpu_torch.utils.trace import span, trace_parts

    def work():
        with span("a"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        for _ in range(2):
            with span("b"):
                torch.randn(8).sum()

    s = trace_parts(work, str(tmp_path), "t", "cpu", log=lambda m: None)
    assert s["parts"]["a"][0] == 1 and s["parts"]["b"][0] == 2
    assert s["device_events"] == 0 and s["device_idle_share"] is None
    assert s["window_ms"] >= s["parts"]["a"][1] + s["parts"]["b"][1]
    split = s["span_split"]
    assert split["a"][0] == 1 and split["b"][0] == 2
    assert split["window"][1] >= split["a"][1] + split["b"][1]
    assert all(dev is None for _, _, dev in split.values())


def test_summarize_trace_device_events(tmp_path):
    """Families without template arguments, the longest ops, and the idle
    share: the union of the device ops inside the window span over its
    length."""
    from treelearn_tpu_torch.utils.trace import family, summarize_trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
         "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "voxelize", "ts": 10,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "kernel", "ts": 100, "dur": 200,
         "name": "void at::native::k<128, 4, at::x<float> >(int, float*)",
         "args": {"External id": 7}},
        {"ph": "X", "cat": "kernel", "ts": 250, "dur": 100,
         "name": "void (anonymous namespace)::k<64, 2, at::x<float> >"
                 "(int, at::y(at::z(long)))", "args": {"External id": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 900, "dur": 200,
         "name": "Memcpy DtoH (Device -> Pinned)"},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 50, "name": "aten::mm",
         "args": {"External id": 7}, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "ts": 60, "dur": 5, "name": "aten::mm",
         "args": {"External id": 8}, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "ts": 50, "dur": 40, "tid": 1,
         "name": "cudaStreamSynchronize"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 500, "dur": 10, "tid": 1,
         "name": "cudaStreamSynchronize"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 510, "dur": 3, "tid": 1,
         "name": "cudaLaunchKernel"},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = summarize_trace(str(path))
    assert family(ev[2]["name"]) == "at::native::k"
    assert family(ev[3]["name"]) == "(anonymous namespace)::k"
    assert {f[2]: (f[0], f[1]) for f in s["families"]} == {
        "at::native::k": (0.2, 1), "(anonymous namespace)::k": (0.1, 1),
        "Memcpy DtoH": (0.2, 1)}
    ms, n, name = s["ops"][0]
    assert (ms, n, name) == (pytest.approx(0.3), 2, "aten::mm")
    assert s["syncs"] == {"voxelize": [1, 0.04], "-": [1, 0.01]}
    assert s["sync_total"] == [2, pytest.approx(0.05)]
    assert s["longest"][0][0] == 0.2 and s["device_events"] == 3
    # busy: [100, 350] and [900, 1000] of the window [0, 1000]
    assert s["device_busy_ms"] == pytest.approx(0.35)
    assert s["device_idle_share"] == pytest.approx(0.65)
    assert s["parts"] == {"voxelize": [1, 0.1]}
