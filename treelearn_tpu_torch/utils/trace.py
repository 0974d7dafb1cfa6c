"""Named spans and counters of the host's work, and the summary of a
``torch.profiler`` chrome trace (the counterpart of the JAX package's
scripts/parse_trace.py).

``span(name)`` marks a part of the host's work: the pipeline's stages and
their parts, the loader, the forward, the harvest and the training step.
It records only while something listens: inside ``torch.profiler.profile``
it is a ``record_function`` range (a ``user_annotation`` event of the
trace); while a :class:`SpanTimer` is installed it takes the host clock and
a pair of CUDA events on the current stream; otherwise it does nothing.  It
never synchronizes, so it changes no output and no timing but its own few
microseconds.  A span's name is a fixed string: sizes and file names go
into counters or nowhere.

``count(name, n)`` adds ``n`` to a counter under the same rule: while
something listens it keeps the sample ``(time.time_ns(), name, n)`` (the
profiler's clock), the newest ``MAX_COUNTS`` of them;
:func:`counter_totals` sums them over a window.

:func:`trace_parts` runs a function once under the profiler and prints what
``tools/profile_model.py --trace`` and ``tools/profile_step.py --train
--trace`` report: device milliseconds by kernel family and by the op that
launched them, the longest device ops, host milliseconds per named part,
the host's waits on the card (``cudaStreamSynchronize`` and the like) per
part, and the device-idle share of the window.  Where the profiler gives a
card no device events, it says so on a line of its own and falls back to
the CUDA-event split of the spans.
"""

from __future__ import annotations

import collections
import json
import os
import os.path as osp
import re
import sys
import time
from contextlib import contextmanager

WINDOW = "window"          # the span around a traced call, its sync included
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")  # host waits on the card
NO_DEVICE_EVENTS = ("trace: ProfilerActivity.CUDA gave no device events on "
                    "this host; the CUDA-event split of the spans follows")

MAX_COUNTS = 1_000_000     # counter samples kept, the newest

_TIMER = None              # the installed SpanTimer, if any
_COUNTS = collections.deque(maxlen=MAX_COUNTS)   # (t_ns, name, n)


def _profiling() -> bool:
    """Whether ``torch.profiler`` records; a process that has not imported
    torch (the loader's producer) runs no profiler."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextmanager
def span(name: str):
    """A named part of the host's work (see the module docstring)."""
    timer = _TIMER
    if timer is not None:
        with timer.part(name):
            yield
    elif _profiling():
        with sys.modules["torch"].profiler.record_function(name):
            yield
    else:
        yield


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a span would record."""
    if _TIMER is not None or _profiling():
        _COUNTS.append((time.time_ns(), name, int(n)))


def counter_totals(lo_ns: int, hi_ns: int) -> dict:
    """{name: total} of the counter samples taken in [lo_ns, hi_ns]
    (``time.time_ns`` clock)."""
    out = {}
    for t, name, n in list(_COUNTS):
        if lo_ns <= t <= hi_ns:
            out[name] = out.get(name, 0) + n
    return out


def _torch():
    import torch

    return torch


class SpanTimer:
    """The CUDA-event split: while installed (``with SpanTimer(device):``)
    every span takes its host seconds and, on a card, a CUDA event before
    and after it on the current stream.  Nothing synchronizes inside a
    span; :meth:`summary` synchronizes once, after the run."""

    def __init__(self, device):
        # "cpu" imports no torch: the loader's producer process times its
        # parts under such a timer
        self.cuda = device != "cpu" and _torch().device(device).type == "cuda"
        self.parts = []      # (name, host seconds, start event, end event)
        self.window_ns = (0, 0)  # time.time_ns() when installed, removed

    def __enter__(self):
        global _TIMER
        _TIMER = self
        self.window_ns = (time.time_ns(), 0)
        return self

    def __exit__(self, *exc):
        global _TIMER
        _TIMER = None
        self.window_ns = (self.window_ns[0], time.time_ns())

    @contextmanager
    def part(self, name):
        start = end = None
        if self.cuda:
            start = _torch().cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host_s = time.perf_counter() - t0
            if self.cuda:
                end = _torch().cuda.Event(enable_timing=True)
                end.record()
            self.parts.append((name, host_s, start, end))

    def summary(self) -> dict:
        """{name: [calls, host ms, stream ms or None]} in first-seen order;
        stream ms is the card's time between each span's two events."""
        if self.cuda:
            _torch().cuda.synchronize()
        out = {}
        for name, host_s, start, end in self.parts:
            row = out.setdefault(name, [0, 0.0, 0.0 if self.cuda else None])
            row[0] += 1
            row[1] += host_s * 1e3
            if self.cuda:
                row[2] += start.elapsed_time(end)
        return out

    def counters(self) -> dict:
        """{name: total} of the counters taken while it was installed."""
        return counter_totals(*self.window_ns)


def family(kernel_name: str) -> str:
    """A device op's family: its name without template arguments and
    parameter list (``void ns::k<128, 4>(int, float*)`` -> ``ns::k``)."""
    name = kernel_name
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    name = re.sub(r"\s*const\s*$", "", name)
    if name.endswith(")"):     # drop the parameter list, nested parens too
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name).strip() or kernel_name


def _union_ms(intervals, lo, hi):
    """Milliseconds of [lo, hi] (microseconds) covered by ``intervals``."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy / 1e3


def summarize_trace(path: str, top: int = 16, longest: int = 14) -> dict:
    """Summary of a chrome trace written by ``torch.profiler``:

    * ``families``: [(device ms, count, family)], the ``top`` largest;
    * ``longest``: [(ms, name)], the ``longest`` individual device ops;
    * ``ops``: [(device ms, count, op)], the ``top`` largest, each device
      op charged to the host op that launched it (``External id``);
    * ``parts``: {span name: [calls, host ms]} over ``user_annotation``
      events, the ``window`` span aside;
    * ``syncs``: {span name: [waits, host ms]}: the host's waits on the
      card (``SYNC_CALLS``), each charged to the innermost span around it
      (``-`` outside every span), and ``sync_total`` [waits, host ms];
    * ``window_ms``, ``device_busy_ms``, ``device_idle_share``: the window
      is the ``window`` span (or, without one, the whole trace), and the
      busy time the union of the device ops inside it; the share is None
      when the trace holds no device op;
    * ``device_events``: how many device ops the trace holds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    windows = [e for e in spans if e["name"] == WINDOW]
    if windows:
        lo = min(e["ts"] for e in windows)
        hi = max(e["ts"] + e["dur"] for e in windows)
    else:
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        lo = min(e["ts"] for e in timed)
        hi = max(e["ts"] + e["dur"] for e in timed)
    launcher = {e["args"]["External id"]: e["name"] for e in events
                if e.get("cat") == "cpu_op"
                and "External id" in e.get("args", {})}

    def ranked(key):
        agg = collections.defaultdict(lambda: [0, 0.0])
        for e in device:
            row = agg[key(e)]
            row[0] += 1
            row[1] += e["dur"] / 1e3
        return sorted(((ms, n, name) for name, (n, ms) in agg.items()),
                      reverse=True)[:top]

    parts = {}
    for e in spans:
        if e["name"] == WINDOW:
            continue
        row = parts.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e3
    inner = sorted((e for e in spans if e["name"] != WINDOW),
                   key=lambda e: e["dur"])
    syncs = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or e["name"] not in SYNC_CALLS:
            continue
        where = next((s["name"] for s in inner if s["tid"] == e["tid"]
                      and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]), "-")
        row = syncs.setdefault(where, [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e3
    window_ms = (hi - lo) / 1e3
    busy_ms = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in device],
                        lo, hi)
    return {
        "path": path,
        "families": ranked(lambda e: family(e["name"])),
        "ops": ranked(lambda e: launcher.get(
            e.get("args", {}).get("External id"), "?")),
        "longest": [(e["dur"] / 1e3, e["name"]) for e in sorted(
            device, key=lambda e: -e["dur"])[:longest]],
        "parts": parts,
        "syncs": syncs,
        "sync_total": [sum(r[0] for r in syncs.values()),
                       sum(r[1] for r in syncs.values())],
        "window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / window_ms
                              if device and window_ms > 0 else None),
        "device_events": len(device),
    }


def print_trace_summary(s: dict, log=print) -> None:
    log(f"trace {s['path']}: {s['device_events']} device ops in a window "
        f"of {s['window_ms']:.3f} ms")
    if s["device_events"]:
        log("device ms by kernel family (top 16):")
        for ms, n, name in s["families"]:
            log(f"  {ms:10.3f} ms  x{n:<5d} {name[:90]}")
        log("device ms by launching op (top 16):")
        for ms, n, name in s["ops"]:
            log(f"  {ms:10.3f} ms  x{n:<5d} {name[:90]}")
        log("longest device ops:")
        for ms, name in s["longest"]:
            log(f"  {ms:10.3f} ms  {family(name)[:90]}")
    log("host ms per part:")
    for name, (n, ms) in s["parts"].items():
        log(f"  {name:<28s} {ms:10.3f} ms  x{n}")
    print_counters(s.get("counters"), log)
    if s["syncs"]:
        n, ms = s["sync_total"]
        log(f"host waits on the card: {n} in {ms:.3f} ms; per innermost "
            "part:")
        for name, (n, ms) in sorted(s["syncs"].items(),
                                    key=lambda kv: -kv[1][1]):
            log(f"  {name:<28s} {ms:10.3f} ms  x{n}")
    share = s["device_idle_share"]
    log("device idle share of the window: " + (
        f"{share:.4f} (busy {s['device_busy_ms']:.3f} of "
        f"{s['window_ms']:.3f} ms)" if share is not None
        else "not measured (no device ops in the trace)"))


def print_counters(counters, log=print) -> None:
    if counters:
        log("counters:")
        for name, total in sorted(counters.items()):
            log(f"  {name:<28s} {total:12d}")


def print_span_split(split: dict, log=print, counters=None) -> None:
    log("span split, no profiler (CUDA events on the stream; host clock):")
    for name, (n, host_ms, dev_ms) in split.items():
        dev = "not measured" if dev_ms is None else f"{dev_ms:10.3f} ms"
        log(f"  {name:<28s} stream {dev}, host {host_ms:10.3f} ms  x{n}")
    print_counters(counters, log)


def trace_parts(fn, trace_dir: str, name: str, device, log=print) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CPU activity, and CUDA on
    a card) inside the ``window`` span, which ends in a synchronize, write
    ``<trace_dir>/<name>.trace.json`` and print its summary; then run it
    once more under a :class:`SpanTimer` and print that split: the host ms
    per part without the profiler's cost per op, and on a card each part's
    stream ms.  Where a card's trace holds no device op, a line says so
    first, and the split is the only device-side account.  Each run's
    counter totals are printed after its parts.  Returns the summary with
    the profiled run's counters under ``counters``, the split under
    ``span_split`` and its counters under ``span_counters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = osp.join(trace_dir, f"{name}.trace.json")
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    summary = summarize_trace(path)
    summary["counters"] = counter_totals(t0, t1)
    print_trace_summary(summary, log)
    if cuda and not summary["device_events"]:
        log(NO_DEVICE_EVENTS)
    with SpanTimer(device) as timer:
        with timer.part(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    summary["span_split"] = timer.summary()
    summary["span_counters"] = timer.counters()
    print_span_split(summary["span_split"], log, summary["span_counters"])
    return summary
