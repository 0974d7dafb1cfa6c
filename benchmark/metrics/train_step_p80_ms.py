"""train_step_p80_ms (ms): the 80th percentile of the window's step times,
a step from the loader's batch request to its loss read back on the host
(the port's own loop reads the loss every step).  A tail of ~70 steps
spreads too widely between runs to hold a bound, so it stands here beside
``train_crops_per_s``."""

import numpy as np


def read(ctx):
    s = ctx.get("steps") or []
    if not s:
        return None
    return float(np.percentile([1e3 * x["step_s"] for x in s], 80))
