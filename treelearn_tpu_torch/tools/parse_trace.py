"""Summarize a ``torch.profiler`` chrome trace by op family (port of
scripts/parse_trace.py).

    python -m treelearn_tpu_torch.tools.parse_trace TRACE.json

Prints device milliseconds by kernel family (top 16), the longest device
ops, host milliseconds per named span and the device-idle share of the
window (``utils/trace.py:summarize_trace``).  The traces come from
``tools/profile_model.py --trace DIR`` and ``tools/profile_step.py --train
--trace DIR``.
"""

from __future__ import annotations

import argparse

from ..utils.trace import print_trace_summary, summarize_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a chrome trace (.json) torch.profiler wrote")
    summary = summarize_trace(ap.parse_args(argv).trace)
    print_trace_summary(summary)
    return summary


if __name__ == "__main__":
    main()
