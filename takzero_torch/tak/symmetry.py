"""Board symmetries (D4) as square permutations.

The port's own copy of the part of ``takzero_tpu/tak/symmetry.py`` that
opening generation needs (plain numpy; the port never imports the JAX
package): symmetry ``t = k + 4*m`` applies ``rot90^k`` then ``mirror^m``
where rot90(r, c) = (c, n-1-r) and mirror(r, c) = (r, n-1-c).  Identity is
t=0.
"""

from __future__ import annotations

import functools

import numpy as np


def transform_rc(t: int, r: int, c: int, n: int) -> tuple[int, int]:
    for _ in range(t & 3):
        r, c = c, n - 1 - r
    if t >= 4:
        c = n - 1 - c
    return r, c


@functools.lru_cache(maxsize=None)
def square_maps(n: int) -> np.ndarray:
    """[8, S] array: new square index of old square sq under symmetry t."""
    out = np.zeros((8, n * n), np.int32)
    for t in range(8):
        for r in range(n):
            for c in range(n):
                rr, cc = transform_rc(t, r, c, n)
                out[t, r * n + c] = rr * n + cc
    return out
