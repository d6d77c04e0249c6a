"""One-buffer host readbacks for the learners' flushes.

The port's copy of ``takzero_tpu/utils/flush.py``.  A flush needs the
metrics of some steps and the (indices, fresh) pairs of the SimHash bits
those steps set.  Reading each tensor on its own costs one blocking
device-to-host copy each; these helpers pack what a flush needs into one
tensor on the device and read it with one ``.cpu()``.

Words are uint32.  ``pack_flush`` builds them as int32 bit patterns (the
port's seen-set holds its words the same way) and returns them viewed as
``torch.uint32``.
"""

from __future__ import annotations

import numpy as np
import torch


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor whose bits are ``x``'s values modulo 2**32."""
    return x.reshape(-1).to(torch.int64).to(torch.int32)


def pack_flush(metrics: dict, idx=None, fresh=None) -> torch.Tensor:
    """One uint32 vector: the float32 metric tensors (any shape) in sorted
    key order, flattened and bitcast, then ``idx`` and ``fresh`` when
    given."""
    parts = [metrics[k].to(torch.float32).reshape(-1).contiguous().view(torch.int32) for k in sorted(metrics)]
    if idx is not None:
        parts += [_u32_bits(idx), _u32_bits(fresh)]
    return torch.cat(parts).view(torch.uint32)


def unpack_flush(buf, keys, c: int, has_idx: bool):
    """Inverse of :func:`pack_flush` on the host.

    Returns ``(metrics, new_indices)``: float32[c] per key, and the
    deduplicated ``<u4`` indices whose fresh bit is set (for
    ``ckpt.append_hash_indices``), or None without ``has_idx``.
    """
    if isinstance(buf, torch.Tensor):
        buf = buf.cpu().view(torch.int32).numpy()
    buf = np.asarray(buf).view(np.uint32)
    keys = sorted(keys)
    nk = len(keys)
    mf = buf[: nk * c].view(np.float32)
    metrics = {k: mf[i * c : (i + 1) * c] for i, k in enumerate(keys)}
    new_idx = None
    if has_idx:
        rest = buf[nk * c :]
        half = rest.shape[0] // 2
        new_idx = np.unique(rest[:half][rest[half:].astype(bool)]).astype("<u4")
    return metrics, new_idx


def drain_index_pairs(pairs, group: int = 64) -> np.ndarray:
    """The deduplicated ``<u4`` fresh indices of a list of device
    ``(indices, fresh)`` pairs (``models.agent.hash_indices_fresh``), read
    with one ``torch.cat`` and one ``.cpu()`` per ``group`` pairs."""
    out = []
    for i in range(0, len(pairs), group):
        chunk = pairs[i : i + group]
        flat = torch.cat([p[0].reshape(-1).to(torch.int64) for p in chunk]
                         + [p[1].reshape(-1).to(torch.int64) for p in chunk]).cpu().numpy()
        half = flat.shape[0] // 2
        out.append(flat[:half][flat[half:].astype(bool)])
    if not out:
        return np.zeros((0,), "<u4")
    return np.unique(np.concatenate(out)).astype("<u4")
