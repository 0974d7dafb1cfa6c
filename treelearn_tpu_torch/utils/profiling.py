"""What the profilers in tools/ and the bench share: the card line, the
timers, the bench plot, and the per-shape conv rows with their agreement
test.

Times on a card are CUDA events on the current stream: two warm-up calls,
then the mean of ``reps`` calls, as the JAX package's ``timed``
(tools/profile_model.py) takes them.  On the CPU the same loop runs on the
host clock; those numbers say how fast PyTorch's CPU kernels are and are
printed as host times, never as a device metric.
"""

from __future__ import annotations

import shutil
import subprocess
import time

import numpy as np
import torch

H100_BF16_PEAK_FLOPS = 989e12   # dense bf16, NVIDIA H100 SXM data sheet
BENCH_FOREST = dict(n_trees=48, extent=60.0, points_per_tree=16000,
                    ground_points=200000, seed=0)   # bench.py's plot


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    what the CPU run's numbers are."""
    if torch.device(device).type != "cuda":
        return "cpu: host clock, no device metric measured"
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def timed_ms(fn, device, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` after ``warmup`` calls: CUDA events on
    a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


class ForwardTimer:
    """CUDA events and the host clock around every TreeLearn forward, through
    global module hooks: measurement only, nothing in the path changes (no
    synchronize).  Card only; ``remove()`` uninstalls the hooks, and
    ``device_ms()`` reads each forward's milliseconds once its end event
    has completed."""

    def __init__(self):
        from torch.nn.modules import module as nn_module

        from ..model import TreeLearn

        self.events, self.host_s, self._t0 = [], [], 0.0

        def before(mod, args):
            if isinstance(mod, TreeLearn):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self.events.append([start, None])
                self._t0 = time.time()

        def after(mod, args, output):
            if isinstance(mod, TreeLearn):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events[-1][1] = end
                self.host_s.append(time.time() - self._t0)

        self._handles = [nn_module.register_module_forward_pre_hook(before),
                         nn_module.register_module_forward_hook(after)]

    def remove(self):
        for h in self._handles:
            h.remove()

    def device_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def mfu_text(flops: float, ms: float, device) -> str:
    """``flops`` in ``ms`` as a share of the H100's dense bf16 peak, or
    "not measured" off the card."""
    if torch.device(device).type != "cuda":
        return "MFU not measured (CPU)"
    return f"{flops / (ms * 1e-3) / H100_BF16_PEAK_FLOPS * 100:.2f}% MFU"


def bench_points(points=None) -> np.ndarray:
    """The bench plot's (N, 3) float32 xyz (its first ``points`` rows)."""
    from ..data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(**BENCH_FOREST)
    return data[:points, :3].astype(np.float32)


def model_inputs(pts: np.ndarray, device):
    """(coords, input_feats, batch_ids, valid) tensors of one whole-plot
    batch on ``device``: the JAX profilers' inputs without their padding
    (eager shapes need none)."""
    n = len(pts)
    arrays = (pts, np.zeros((n, 1), np.float32), np.zeros(n, np.int32),
              np.ones(n, bool))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def conv_agrees(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(agrees, error over max |want|) under the tolerance chip_smoke holds
    each conv shape to: float32 rtol 1e-4 with atol 1e-4 of max |want|
    (summation order), bf16 2e-2 of max |want| (float32 sums of the same
    products in another order before the final rounding)."""
    got, wantf = got.float(), want.float()
    scale = float(wantf.abs().max().clamp(min=1e-6))
    rel = float((got - wantf).abs().max()) / scale
    if want.dtype == torch.float32:
        ok = bool(torch.allclose(got, wantf, rtol=1e-4, atol=1e-4 * scale))
    else:
        ok = rel <= 2e-2
    return ok, rel


def conv_rows(x: torch.Tensor, w: torch.Tensor, rule: torch.Tensor, device,
              reps: int) -> dict:
    """One conv shape three ways: kernel 2 through its routed plan, the SIMT
    kernel (``subm_conv_simt``) and the plain gather conv, each with its ms
    and, for the two kernels, its error against the plain output.  Off the
    card only the plain conv runs (the wrappers would take it too).
    Raises if a kernel disagrees with the plain conv."""
    from ..ops.sparse import subm_conv as plain_conv
    from ..ops.subm_conv import (conv_plan, cout_pad, subm_conv,
                                 subm_conv_simt, tensor_core_pad)

    want = plain_conv(x, w, rule)
    row = {"plain_ms": timed_ms(lambda: plain_conv(x, w, rule), device,
                                reps),
           "flops": 2.0 * float((rule >= 0).sum()) * w.shape[1] * w.shape[2]}
    if torch.device(device).type != "cuda":
        return row
    k, cin, cout = w.shape
    v = rule.shape[1]
    # the plan of the shape the wrapper launches, zero channels included
    row["route"] = conv_plan(cin + tensor_core_pad(cin, cout, v, x.dtype, k),
                             cout + cout_pad(cout, x.dtype, k), v, x.dtype,
                             k).route
    for name, fn in (("routed", subm_conv), ("simt", subm_conv_simt)):
        ok, rel = conv_agrees(fn(x, w, rule), want)
        if not ok:
            raise AssertionError(
                f"{name} conv V={rule.shape[1]} {w.shape[1]}->{w.shape[2]} "
                f"{x.dtype}: error {rel:.3e} of max |out|")
        row[f"{name}_err"] = rel
        row[f"{name}_ms"] = timed_ms(lambda fn=fn: fn(x, w, rule), device,
                                     reps)
    return row


def conv_row_text(row: dict, device) -> str:
    """One printed line of :func:`conv_rows`."""
    plain = f"plain {row['plain_ms']:9.3f} ms"
    if "routed_ms" not in row:
        return (f"{plain} (host clock; the kernels run on the card only, "
                f"{row['flops'] / 1e9:.2f} GFLOP)")
    return (f"kernel 2 {row['route']} {row['routed_ms']:8.3f} ms "
            f"({mfu_text(row['flops'], row['routed_ms'], device)}, err "
            f"{row['routed_err']:.1e}), SIMT {row['simt_ms']:8.3f} ms "
            f"({mfu_text(row['flops'], row['simt_ms'], device)}, err "
            f"{row['simt_err']:.1e}), {plain} "
            f"({mfu_text(row['flops'], row['plain_ms'], device)})")
