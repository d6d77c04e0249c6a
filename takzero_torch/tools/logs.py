"""Training-log helpers (reference python/extract_from_logs.py).

The port's own copy of ``moving_average`` from ``takzero_tpu/tools/logs.py``,
which the EEE plots smooth their curves with.
"""

from __future__ import annotations

import numpy as np


def moving_average(a, n: int = 128):
    a = np.asarray(a, float)
    if len(a) < n:
        return a
    ret = np.cumsum(a)
    ret[n:] = ret[n:] - ret[:-n]
    return ret[n - 1 :] / n
