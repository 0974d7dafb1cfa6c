"""Reduction of a ``torch.profiler`` run to the numbers the benchmark reports.

A frozen counterpart of the port's trace summary (``utils/trace.py``:
device milliseconds by kernel family, the host's named parts, the idle share
of a window), read from the profiler's events in memory instead of an
exported chrome trace, so that a traced window of tens of seconds costs no
disk.  Times are nanoseconds on the profiler's clock, which is the host's
wall clock (``time.time_ns``).
"""

from __future__ import annotations

import bisect
import collections
import functools
import re

def _start_ns(e) -> int:
    if hasattr(e, "start_ns"):
        return int(e.start_ns())
    return int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    if hasattr(e, "duration_ns"):
        return int(e.duration_ns())
    return int(e.duration_us() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).split(".")[-1].upper() == "CUDA"


def _is_annotation(e) -> bool:
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    return False


@functools.lru_cache(maxsize=None)
def family(kernel_name: str) -> str:
    """A device op's name without template arguments and parameter list."""
    name = kernel_name
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    name = re.sub(r"\s*const\s*$", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name).strip() or kernel_name


def collect(prof) -> dict:
    """The events of a finished ``torch.profiler.profile`` as plain lists:
    ``device`` [(start_ns, end_ns, name)] of the card's ops and ``spans``
    [(start_ns, end_ns, name)] of the named ranges (``record_function``)."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s = _start_ns(e)
        d = _dur_ns(e)
        if _is_annotation(e):
            # a range also has a copy on the card's timeline, which covers
            # its kernels and the gaps between them: not a device op
            if not _is_device(e):
                spans.append((s, s + d, e.name()))
        elif _is_device(e):
            device.append((s, s + d, e.name()))
    names = {n for _, _, n in spans}
    device = sorted(x for x in device if x[2] not in names)
    spans.sort()
    return {"device": device, "spans": spans}


def _innermost(spans, starts, t: int, reach: int = 4096):
    """The name of the latest-starting range that covers ``t`` (the
    innermost, for nested ranges), or None."""
    j = bisect.bisect_right(starts, t)
    for i in range(j - 1, max(j - 1 - reach, -1), -1):
        if spans[i][1] >= t:
            return spans[i][2]
    return None


def busy_intervals(device, lo: int, hi: int):
    """The union of the device ops' intervals inside [lo, hi], merged."""
    out = []
    for a, b, _ in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: dict, lo: int, hi: int, stages=(), top: int = 10) -> dict:
    """Busy and window seconds, device seconds by kernel family, and the
    longest idle gaps by what the host was doing, over the window [lo, hi].

    ``stages`` is [(end_ns, name)] of the program's stages in time order: a
    gap is cut at the stages' ends, and each piece is charged to its stage
    and to the innermost named range around its midpoint."""
    dev = [d for d in events["device"] if d[1] > lo and d[0] < hi]
    busy = busy_intervals(dev, lo, hi)
    busy_ns = sum(b - a for a, b in busy)
    fam = collections.defaultdict(float)
    for a, b, name in dev:
        fam[family(name)] += (min(b, hi) - max(a, lo)) / 1e9
    gaps = []
    prev = lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    spans = events["spans"]
    starts = [s[0] for s in spans]
    ends = [end for end, _ in stages]
    by_what = collections.defaultdict(float)
    for a, b in gaps:
        cuts = [a] + ends[bisect.bisect_right(ends, a):
                          bisect.bisect_left(ends, b)] + [b]
        for lo_, hi_ in zip(cuts[:-1], cuts[1:]):
            mid = (lo_ + hi_) // 2
            what = _innermost(spans, starts, mid) or "host"
            k = bisect.bisect_left(ends, mid)
            key = what if k >= len(stages) else f"{stages[k][1]}/{what}"
            by_what[key] += (hi_ - lo_) / 1e9
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": sorted(([k, v] for k, v in fam.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_what.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def span_seconds(events: dict, name: str, lo: int, hi: int):
    """Host seconds of every range called ``name`` inside [lo, hi]."""
    return [(b - a) / 1e9 for a, b, n in events["spans"]
            if n == name and a >= lo and b <= hi]


def kernel_seconds(events: dict, pattern: str, lo: int, hi: int):
    """(seconds, launches) of the device ops whose family contains
    ``pattern`` inside [lo, hi]."""
    total, n = 0.0, 0
    for a, b, name in events["device"]:
        if b <= lo or a >= hi or pattern not in family(name):
            continue
        total += (min(b, hi) - max(a, lo)) / 1e9
        n += 1
    return total, n
