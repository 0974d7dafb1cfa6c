"""The port's kernel smoke (treelearn_tpu_torch/utils/smoke.py) on the CPU,
where every wrapper takes its plain version; on the card chip_smoke.py runs
it in full."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_knot_layout_is_the_jax_smokes():
    """At 96 knots the layout is the JAX smoke's hdbscan_device_220k input
    (treelearn_tpu/utils/smoke.py:178-184), point for point."""
    from treelearn_tpu_torch.utils.smoke import knot_layout

    rng = np.random.default_rng(3)
    centers = rng.uniform(0, 240, (96, 2)).astype(np.float32)
    knots = (centers[:, None, :]
             + rng.normal(0, 0.25, (96, 2000, 2))).reshape(-1, 2)
    clutter = rng.uniform(0, 240, (28000, 2))
    want = np.concatenate([knots, clutter]).astype(np.float32)
    got = knot_layout()
    assert got.shape == (220000, 2)
    np.testing.assert_array_equal(got, want)


def test_knot_recovery_counts():
    from treelearn_tpu_torch.utils.smoke import knot_recovery

    labels = np.concatenate([np.repeat(np.arange(1, 11), 2000),
                             np.full(500, -1)])
    assert knot_recovery(labels, 10) == (10, 10, True)
    labels[:4000] = -1
    assert knot_recovery(labels, 10) == (8, 8, False)


def test_run_gpu_smoke_on_cpu():
    """Every check passes with the plain versions, the eps-ladder on a
    four-knot layout at the 220k layout's densities."""
    from treelearn_tpu_torch.utils.smoke import run_gpu_smoke

    out = run_gpu_smoke(device="cpu", n_knots=4)
    assert out["errors"] == {}
    assert out["failed"] == 0 and out["passed"] == len(out["checks"]) == 6
    assert out["hdbscan_knots_recovered"] == 4
    assert out["hdbscan_cc_launches"] == 0      # no kernel on the CPU
    assert out["hdbscan_levels_active"] > 0


def test_run_gpu_smoke_reports_a_failure(monkeypatch):
    """A failing check is reported with its message, never hidden."""
    import treelearn_tpu_torch.ops.cc as cc
    from treelearn_tpu_torch.utils.smoke import run_gpu_smoke

    def broken(p, **kw):
        raise ValueError("broken on purpose")

    monkeypatch.setattr(cc, "found_bits", broken)
    out = run_gpu_smoke(device="cpu", n_knots=1)
    assert out["checks"]["cc"] is False
    assert "broken on purpose" in out["errors"]["cc"]
    assert out["failed"] >= 1


def test_run_gpu_smoke_raises_without_cuda():
    from treelearn_tpu_torch.utils.smoke import run_gpu_smoke

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_gpu_smoke()
