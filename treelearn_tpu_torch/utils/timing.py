"""Sub-stage wall-clock instrumentation for the pipeline's host stages.

``TL_STAGE_DEBUG=1`` activates per-substage log lines; off by default so the
hot path pays one env lookup at import and nothing else.  The coarse stage
table (pipeline/run.py ``_stage``) answers "which stage"; this answers
"which part of the stage" — the resolution VERDICT r2 item 3's host-stage
work is driven by.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

_ON = os.environ.get("TL_STAGE_DEBUG") == "1"


@contextmanager
def substage(name: str, logger=None):
    if not _ON:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        msg = f"  [substage] {name}: {time.time() - t0:.2f}s"
        if logger is not None:
            logger.info(msg)
        else:
            print(msg, flush=True)
