"""The port's inference loop (treelearn_tpu_torch/pipeline/inference.py) on
the CPU: the prefetch thread, batch t-1 harvested behind batch t and the
packed float16 + int32 ship, held bit for bit to a serial loop written here
as the loop ran before the overlap (cut, forward, float16 round trip,
numpy harvest, one batch after the other), on tile batches of a small
seeded plot from ``TileStream``.  Each test runs under its own time limit
(``within``), so a hung thread fails it.  Run:

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_port_inference_loop.py
"""

import functools
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CFG = dict(channels=8, num_blocks=3, spatial_shape=[128, 128, 128])
KEYS = ("semantic_prediction_logits", "semantic_labels",
        "offset_predictions", "offset_labels", "coords", "instance_labels",
        "backbone_feats", "input_feats")


def within(seconds):
    """Run the test body on a thread and fail if it is not done in
    ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # handed to the test's thread
                    box["error"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"over its {seconds} s limit"
            if "error" in box:
                raise box["error"]
        return run
    return wrap


@functools.lru_cache(maxsize=1)
def _plot():
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=4, extent=10.0,
                                    points_per_tree=600, ground_points=2000,
                                    seed=3)
    data[:, :3] -= data[:, :3].mean(0)
    return data


def _stream():
    from treelearn_tpu_torch.pipeline.streaming import TileStream

    data = _plot()
    pts = np.round(data[:, :3].astype(np.float32), 2).astype(np.float64)
    return TileStream(pts, data[:, 3], np.zeros((len(pts), 1), np.float32),
                      inner_edge=4.0, outer_edge=6.0, stride=0.5)


def _batches(mode):
    stream = _stream()
    if mode == "whole_plot":
        return stream.whole_plot_batches(min_bucket=1)
    return stream.batches(batch_size=1, min_bucket=1)


def _model():
    from treelearn_tpu_torch.model import TreeLearn

    return TreeLearn(**CFG).init(0).eval()


def serial_loop(model, loader, need_backbone=True, dev="cpu",
                compute_dtype=torch.float32):
    """The loop before the overlap: per batch, inputs to ``dev``, the
    forward, the kept rows rounded through float16 and widened back on
    ``dev``, copied, then the numpy harvest; counts read with ``int()``."""
    parts, counts = [], []
    for batch in loader:
        n = int(batch["n_points"])
        inputs = [torch.from_numpy(np.ascontiguousarray(batch[k][:n])).to(dev)
                  for k in ("coords", "input_feats", "batch_ids", "valid")]
        with torch.no_grad():
            output = model(*inputs, batch_size=int(batch["batch_size"]),
                           compute_dtype=compute_dtype)
        sel = np.flatnonzero(np.asarray(batch["masks_inner"][:n])
                             & np.asarray(batch["valid"][:n]))
        sel_t = torch.from_numpy(sel).to(dev)
        preds = [output["semantic_prediction_logits"][sel_t],
                 output["offset_predictions"][sel_t]]
        if need_backbone:
            preds.append(output["backbone_feats"][sel_t])
        packed = torch.cat(preds, dim=1).to(torch.float16).float().cpu().numpy()
        counts.append(([int(x) for x in output["n_voxels_per_level"]],
                       [int(x) for x in output["rule_nnz_per_level"]]))
        part = {"semantic_prediction_logits": packed[:, :2],
                "offset_predictions": packed[:, 2:5],
                "backbone_feats": (packed[:, 5:] if need_backbone else
                                   np.zeros((len(sel), 0), np.float32)),
                "coords": batch["coords"][sel] + batch["centers"][sel],
                "point_ids": batch["point_ids"][sel]}
        for k in ("semantic_labels", "offset_labels", "instance_labels",
                  "input_feats"):
            part[k] = batch[k][sel]
        parts.append(part)
    out = tuple(np.concatenate([p[k] for p in parts]) for k in KEYS)
    return out + (np.concatenate([p["point_ids"] for p in parts]),), counts


def _assert_bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _prefetch_threads():
    from treelearn_tpu_torch.pipeline.inference import PREFETCH_THREAD

    return [t for t in threading.enumerate() if t.name == PREFETCH_THREAD]


@pytest.mark.parametrize("need_backbone", [True, False])
@pytest.mark.parametrize("mode", ["tiles", "whole_plot"])
@within(120)
def test_loop_bitwise_equals_serial(mode, need_backbone):
    from treelearn_tpu_torch.pipeline.inference import get_pointwise_preds

    model = _model()
    want, counts = serial_loop(model, _batches(mode), need_backbone)
    tm = {}
    got = get_pointwise_preds(model, _batches(mode), device="cpu",
                              timings=tm, need_backbone=need_backbone)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        _assert_bitwise(a, b)
    assert tm["steps"] == len(counts) > (1 if mode == "tiles" else 0)
    assert tm["points"] == len(want[0])
    np.testing.assert_array_equal(
        tm["n_vox_levels"], np.max([c[0] for c in counts], axis=0))
    np.testing.assert_array_equal(
        tm["rule_nnz"], np.max([c[1] for c in counts], axis=0))
    cols = 2 + 3 + (CFG["channels"] if need_backbone else 0)
    assert tm["d2h_bytes"] == 2 * cols * len(want[0]) + 4 * 6 * tm["steps"]
    for k in ("cut_s", "dispatch_s", "d2h_wait_s", "harvest_s", "device_s"):
        assert tm[k] >= 0.0, k
    assert "h2d_ms" not in tm and "d2h_ms" not in tm   # card only
    assert not _prefetch_threads()


@within(60)
def test_loader_runs_on_the_prefetch_thread():
    from treelearn_tpu_torch.pipeline.inference import (PREFETCH_THREAD,
                                                        get_pointwise_preds)

    names = []

    def loader():
        for b in _batches("tiles"):
            names.append(threading.current_thread().name)
            yield b

    get_pointwise_preds(_model(), loader(), device="cpu")
    assert len(names) > 1 and set(names) == {PREFETCH_THREAD}


class LoaderFault(RuntimeError):
    pass


@within(60)
def test_loader_exception_raised_with_its_type():
    from treelearn_tpu_torch.pipeline.inference import get_pointwise_preds

    def loader():
        for i, b in enumerate(_batches("tiles")):
            if i == 2:
                raise LoaderFault("tile 2")
            yield b

    with pytest.raises(LoaderFault, match="tile 2"):
        get_pointwise_preds(_model(), loader(), device="cpu")
    assert not _prefetch_threads()


@within(60)
def test_consumer_stopping_early_leaves_no_thread():
    """A ``break`` out of the closed prefetch generator, and a forward that
    raises in the loop, both stop and join the thread, also when it is
    blocked on a full queue (an endless loader)."""
    import contextlib
    import itertools

    from treelearn_tpu_torch.pipeline.inference import (get_pointwise_preds,
                                                        prefetch)

    batch = next(iter(_batches("tiles")))
    endless = ((i, batch) for i in itertools.count())
    with contextlib.closing(prefetch(endless, torch.device("cpu"))) as it:
        for i, _, staged, _ in it:
            assert staged["h2d"] is None and i == 0
            break
    assert not _prefetch_threads()

    class Fault(RuntimeError):
        pass

    model = _model()
    calls = []

    def forward(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise Fault("forward 2")
        return model(*args, **kwargs)

    forward.to = lambda dev: forward
    forward.eval = lambda: forward
    with pytest.raises(Fault):
        get_pointwise_preds(forward, (batch for _ in itertools.count()),
                            device="cpu")
    assert not _prefetch_threads()


@within(60)
def test_float16_ship_widens_like_the_round_trip():
    """The float32 unpacked from the float16 ship equals
    ``x.to(torch.float16).float()`` bit for bit: overflow to inf,
    subnormals, signed zeros, NaN-free random values."""
    from treelearn_tpu_torch.pipeline.inference import dispatch, harvest, stage

    rng = np.random.default_rng(0)
    batch = next(iter(_batches("tiles")))
    n = int(batch["n_points"])
    x = rng.standard_normal((n, 5 + 8)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-9, 6, (n, 1)).astype(np.float32)
    x[:4, 0] = [70000.0, -1e-7, -0.0, 6e-8]
    x = torch.from_numpy(x)
    counts = torch.tensor([n, 7, 2], dtype=torch.int32)

    def fake(*args, **kwargs):
        return {"semantic_prediction_logits": x[:, :2],
                "offset_predictions": x[:, 2:5], "backbone_feats": x[:, 5:],
                "n_voxels_per_level": counts, "rule_nnz_per_level": counts * 3}

    staged = stage(batch, torch.device("cpu"))
    out = harvest(dispatch(fake, batch, staged))
    want = x[torch.from_numpy(staged["sel"])].to(torch.float16).float().numpy()
    got = np.concatenate([out["semantic_prediction_logits"],
                          out["offset_predictions"], out["backbone_feats"]], 1)
    _assert_bitwise(got, want)
    assert np.isinf(want).any() and (want == 0).any()
    assert out["n_vox_levels"].tolist() == [n, 7, 2]
    assert out["rule_nnz"].tolist() == [3 * n, 21, 6]


@pytest.mark.parametrize("kernel_size", [3, 5])
@within(60)
def test_shipped_counts_equal_the_int_reads(kernel_size):
    """The counts in the shipped meta equal the per-level reads the forward
    made before: ``grid.n_active`` and ``int((rule >= 0).sum())``."""
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.model.network import build_level_plans
    from treelearn_tpu_torch.ops.sparse import grid_from_sorted_keys
    from treelearn_tpu_torch.ops.voxelize import voxelize_points
    from treelearn_tpu_torch.pipeline.inference import forward_harvest

    model = TreeLearn(**dict(CFG, kernel_size=kernel_size)).init(0).eval()
    for batch in list(_batches("tiles"))[:3]:
        n = int(batch["n_points"])
        inputs = [torch.from_numpy(np.ascontiguousarray(batch[k][:n]))
                  for k in ("coords", "input_feats", "batch_ids", "valid")]
        vb = voxelize_points(*inputs, batch_size=1,
                             voxel_size=model.voxel_size,
                             max_pts=model.max_pts,
                             spatial_shape=model.spatial_shape)
        plans = build_level_plans(
            grid_from_sorted_keys(vb.voxel_keys, vb.spatial_shape),
            model.num_blocks, kernel_size)
        part = forward_harvest(model, batch, torch.device("cpu"))
        assert part["n_vox_levels"].tolist() == [p.grid.n_active
                                                 for p in plans]
        assert part["rule_nnz"].tolist() == [int((p.rule >= 0).sum())
                                             for p in plans]
