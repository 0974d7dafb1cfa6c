"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell; its
configuration file, its traffic's workload file
(``benchmark/workloads/<traffic>.json``, the traffic's parameters) and its
limits file (``benchmark/limits/<cell>.json``) are found by name, and so is every
per-layer metric's reader (``benchmark/metrics/<metric>.py``).  The workload
file's ``kind`` names the module of the cell's class
(``benchmark/cells/<kind>.py``, its ``Cell``).

The run fails, printing no result, without as many CUDA devices as the cell
asks for, and when JAX, flax or the JAX package is loaded once the window
has closed.  Set-up (``setup_s``) runs from the start of this process to the
end of the warm-up, less the seconds of reference work a cell does there
(its ``reference_s``).  With ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the cell's per-layer metrics; with
``--trace 0`` its end-to-end metrics.  Either way the outputs of the window
are held to the plain reference (``benchmark/reference``) once the window
has closed and the program's state is freed, and each number compared is
printed beside its limit, as the last lines on standard error and under the
last key of the result line.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "treelearn_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entries(manifest: dict, name: str):
    work = next(w for w in manifest["workloads"] if w["name"] == name)
    conf = next(c for c in manifest["configs"] if c["name"] == work["config"])
    return work, conf


def applies(metric: dict, cell: str, end_to_end=None) -> bool:
    """Whether a metric is reported in a cell: its ``workloads`` list, or,
    without one, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if end_to_end is not None:
        return metric["moves"] in end_to_end
    return True


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def finite(x: float) -> float:
    return float(x) if math.isfinite(float(x)) else 1e308


def judge(nums: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and a limit for every number."""
    checks, ok = {}, bool(limits)
    for k, v in nums.items():
        lim = limits.get(k)
        checks[k] = {"value": finite(v),
                     "limit": None if lim is None else float(lim)}
        if lim is None or not (float(v) <= float(lim)):
            ok = False
    return ok, checks


def cell_class(kind: str):
    """The ``Cell`` class of ``benchmark/cells/<kind>.py``."""
    import importlib

    return importlib.import_module(f"benchmark.cells.{kind}").Cell


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             manifest: dict, work: dict = None, cfg: dict = None,
             limits: dict = None, log=None) -> dict:
    """Set-up, window, check and metrics of one cell on ``device``; the
    result dict (without the import check).  ``work``, ``cfg`` and
    ``limits`` default to the cell's files."""
    import torch

    from treelearn_tpu_torch.config import ConfigDict

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    wentry, centry = cell_entries(manifest, name)
    work = work or read_json(os.path.join(HERE, "workloads",
                                          f"{wentry['traffic']}.json"))
    cfg = cfg or read_json(os.path.join(ROOT, centry["file"]))
    lim_path = os.path.join(HERE, "limits", f"{name}.json")
    if limits is None:
        limits = read_json(lim_path) if os.path.exists(lim_path) else {}
    cuda = torch.device(device).type == "cuda"
    run_dir = tempfile.mkdtemp(prefix="treelearn_bench_",
                               dir=os.environ.get("TMPDIR"))
    try:
        cell = cell_class(work["kind"])(cfg, work, seed, device, run_dir,
                                    ConfigDict)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cell.setup()
        # reference work done in set-up (segmentation: the reference's
        # forward that sets the semantic bias) is not the program's
        ref_s = float(getattr(cell, "reference_s", 0.0))
        setup_s = time.time() - T_START - ref_s
        log(f"set-up {setup_s:.3f} s (reference {ref_s:.3f} s apart)")
        ctx = cell.window(seconds, trace)
        e2e = cell.result()
        e2e["setup_s"] = setup_s
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        cell.release()
        t = time.time()
        nums = cell.check()
        log(f"check {time.time() - t:.3f} s")
        ctx.update(cell=name,
                   forward_levels=(cell.forward_levels()
                                   if hasattr(cell, "forward_levels")
                                   else None),
                   info=getattr(cell, "info", {}), kind=work["kind"])
    finally:
        if "cell" in locals():
            cell.cleanup()
            if "ctx" in locals():
                ctx["info"] = getattr(cell, "info", {})
        shutil.rmtree(run_dir, ignore_errors=True)
    correct, checks = judge(nums, limits)
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    e2e_names = [m["name"] for m in manifest["end_to_end"]
                 if applies(m, name)]
    metrics = {}
    if trace:
        if hasattr(cell, "step_levels"):
            ctx["levels_per_step"] = cell.step_levels()
        for m in manifest["per_layer"]:
            if not applies(m, name, e2e_names):
                continue
            val = metric_reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        for k in e2e_names:
            if k in e2e:
                metrics[k] = {"value": float(e2e[k]), "unit": units[k]}
    for k, v in ctx.get("info", {}).items():
        log(f"info {k}: {v}")
    for k, v in e2e.items():
        log(f"end-to-end {k}: {v!r}")
    out = {"correct": bool(correct), "attempted": int(cell.attempted()),
           "failed": 0 if correct else int(cell.attempted()),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": int(wentry["chips"]),
                      "memory_peak_bytes": peak}}
    if trace and "trace" in ctx:
        tr = ctx["trace"]
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    work, _ = cell_entries(manifest, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(work["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{work['chips']}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), manifest)
    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
