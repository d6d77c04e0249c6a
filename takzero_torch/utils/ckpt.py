"""Checkpoints with the reference's naming protocol, and the hash log.

Counterpart of ``takzero_tpu/utils/ckpt.py``: a mutable
``model_latest.ckpt`` (every N steps, weights only) plus immutable
``model_{step:07d}.ckpt`` checkpoints that embed the SimHash seen-set;
resume picks the highest-numbered one (learn/src/main.rs:107-120,
270-290).  Writes are atomic (a temporary file, then a rename), so readers
never see a torn file.

Actors follow the learner through :class:`LatestPoller`.

Model files are the port's own format, not the JAX package's flax
msgpack: ``torch.save`` of a dict of tensors only, the bundle's modules
as state dicts and its tensors as they are (each where the novelty has
it; see ``models/agent.py``),

    {"net": TakNet.state_dict(),
     "rnd": RndPair.state_dict(),             # predictor and target
     "ensemble": EnsembleHeads.state_dict(),
     "hash_matrix": f32[In, bits], "hash_scale": f32[C, N, N],
     "rnd_min": f32[], "rnd_max": f32[],
     "hash_bits": int32[2**bits / 32]}        # hash_bits: step checkpoints only

read back with ``torch.load(..., weights_only=True)``.  A JAX run's
file (flax msgpack of its bundle) is read too, into the same layout
(``utils/flax_msgpack.py``, ``bridge.jax_checkpoint_state``), by every
loader below: a TPU run's checkpoints load on the card.

``hash_log.bin`` is the JAX package's file, byte for byte: an append-only
log of bit indices as uint32 little-endian.  Replaying it through
``bitset_set`` rebuilds the seen-set, so actors keep their bitset on the
device and apply small deltas instead of reloading 512 MiB per model.
"""

from __future__ import annotations

import collections
import logging
import os
import pathlib
import pickle
import re
import tempfile
import threading

import numpy as np
import torch

from ..bridge import jax_checkpoint_state
from ..ops.bitset import bitset_set
from . import flax_msgpack
from .flush import drain_index_pairs

_STEP_RE = re.compile(r"model_(\d+)\.ckpt$")
HASH_LOG = "hash_log.bin"
MODULES = ("net", "rnd", "ensemble")  # saved as state dicts
TENSORS = ("hash_matrix", "hash_scale", "rnd_min", "rnd_max", "hash_bits")


def strip_hash_bits(bundle: dict) -> dict:
    """Weights-only view of a bundle (without the novelty bitset)."""
    return {k: v for k, v in bundle.items() if k != "hash_bits"}


def fresh_indices(idx, fresh) -> np.ndarray:
    """Keep only the bits newly set by a batch, deduplicated, as uint32 LE.

    ``(idx, fresh)`` come from ``models.agent.hash_indices_fresh``.  This
    bounds ``hash_log.bin`` by the number of distinct bits ever set.
    """
    return drain_index_pairs([(torch.as_tensor(idx), torch.as_tensor(fresh))])


def append_hash_indices(directory, idx) -> None:
    """Append uint32 bit indices to the hash log (one write)."""
    arr = np.ascontiguousarray(np.asarray(idx).ravel(), dtype="<u4")
    if arr.size == 0:
        return
    with open(pathlib.Path(directory) / HASH_LOG, "ab") as f:
        f.write(arr.tobytes())


def read_hash_indices(path, offset: int):
    """(uint32 indices appended since ``offset``, new offset)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return np.zeros((0,), np.uint32), offset
    size -= size % 4  # ignore a torn trailing write
    if size <= offset:
        return np.zeros((0,), np.uint32), offset
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(size - offset)
    return np.frombuffer(data, dtype="<u4"), size


def reconcile_hash_log(directory, bits_host: np.ndarray) -> int:
    """Append the bits set in ``bits_host`` (uint32 words) but absent from
    the log; returns how many were appended.  Run once at learner resume:
    a crash can leave the deferred log behind the checkpointed bitset."""
    idx, _ = read_hash_indices(pathlib.Path(directory) / HASH_LOG, 0)
    have = np.zeros(bits_host.size, np.uint32)
    if idx.size:
        np.bitwise_or.at(have, (idx >> 5).astype(np.int64), np.uint32(1) << (idx & 31))
    missing = np.asarray(bits_host, np.uint32) & ~have
    words = np.flatnonzero(missing)
    if words.size == 0:
        return 0
    out = []
    mw = missing[words]
    for b in range(32):
        hit = (mw >> np.uint32(b)) & np.uint32(1) != 0
        if hit.any():
            out.append((words[hit].astype(np.uint32) << 5) | np.uint32(b))
    all_missing = np.concatenate(out)
    append_hash_indices(directory, all_missing)
    return int(all_missing.size)


def checkpoint_state(bundle: dict, clone: bool = False) -> dict:
    """The tensors a checkpoint of ``bundle`` holds (on the bundle's device).

    ``clone`` copies them, for a snapshot that later in-place train steps
    cannot change.
    """
    take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
    state = {key: {k: take(v) for k, v in bundle[key].state_dict().items()} for key in MODULES if key in bundle}
    state.update({key: take(bundle[key]) for key in TENSORS if key in bundle})
    return state


def _write(directory, name: str, state: dict) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in state.items()}
    path = directory / name
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(host, f)
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def save_checkpoint(directory, name: str, bundle: dict) -> pathlib.Path:
    return _write(directory, name, checkpoint_state(bundle))


class ForeignCheckpoint(ValueError):
    """A file in neither the port's format nor a JAX run's flax msgpack."""


class CheckpointMismatch(RuntimeError):
    """A checkpoint whose structure does not fit the bundle it is loaded into."""


_ZIP_MAGIC = b"PK\x03\x04"  # torch.save writes a zip archive


def read_checkpoint(path) -> dict:
    """The tensors of a checkpoint file, on the CPU (tensors only are read):
    the port's own, or a JAX run's flax msgpack file in the port's layout.

    Raises :class:`ForeignCheckpoint` for a file of another format; a torn
    or truncated file raises ``ValueError`` or torch's ``RuntimeError``.
    """
    with open(path, "rb") as f:
        head = f.read(len(_ZIP_MAGIC))
    if len(head) < len(_ZIP_MAGIC):
        raise ValueError(f"{path}: truncated checkpoint ({len(head)} bytes)")
    if head == _ZIP_MAGIC:
        return torch.load(path, map_location="cpu", weights_only=True)
    if flax_msgpack.is_msgpack_map(head):
        tree = flax_msgpack.restore(pathlib.Path(path).read_bytes())
        if not isinstance(tree, dict) or not isinstance(tree.get("params"), dict):
            raise ForeignCheckpoint(f"{path}: a msgpack file without a JAX bundle's 'params'")
        return jax_checkpoint_state(tree)
    raise ForeignCheckpoint(
        f"{path} is neither a takzero_torch checkpoint (torch.save zip) nor a JAX run's flax msgpack file"
    )


def _bundle_tensors(bundle: dict) -> dict:
    """The bundle's checkpointed tensors by flat key (``net.<name>``,
    ``rnd.<name>``, ``ensemble.<name>``, ``hash_matrix``, ...); they share
    storage with the bundle."""
    out = {f"{key}.{k}": v for key in MODULES if key in bundle for k, v in bundle[key].state_dict().items()}
    out.update({k: bundle[k] for k in TENSORS if k in bundle})
    return out


def _file_tensors(state: dict) -> dict:
    """A checkpoint's entries by the same flat keys."""
    out = {}
    for key, v in state.items():
        if isinstance(v, dict):
            out.update({f"{key}.{k}": vv for k, vv in v.items()})
        else:
            out[key] = v
    return out


def _check_fits(path, state: dict, bundle: dict) -> None:
    """Raise :class:`CheckpointMismatch` unless every tensor of ``state``
    has its place in ``bundle`` with the same shape and dtype, and every
    tensor of the bundle but its seen-set is in ``state``; the message
    names each missing and each unexpected key."""
    if not isinstance(state.get("net"), dict):
        raise CheckpointMismatch(f"{path}: no 'net' weights")
    want, have = _bundle_tensors(bundle), _file_tensors(state)
    missing = sorted(k for k in want if k != "hash_bits" and k not in have)
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise CheckpointMismatch(f"{path}: does not fit the bundle: missing {missing}, unexpected {extra}")
    for k, v in have.items():
        if not isinstance(v, torch.Tensor) or v.shape != want[k].shape or v.dtype != want[k].dtype:
            got = (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else type(v).__name__
            raise CheckpointMismatch(
                f"{path}: {k} is {got}, the bundle holds {(tuple(want[k].shape), want[k].dtype)}"
            )


def load_checkpoint(path, bundle: dict) -> dict:
    """Load a checkpoint into ``bundle`` in place (its modules and tensors
    keep their device); returns ``bundle``.

    The whole file is checked against the bundle (keys, shapes, dtypes,
    bitset size) before the first tensor is copied, so a file that does
    not fit raises :class:`CheckpointMismatch` and leaves every tensor as
    it was.  A weights-only file (no ``hash_bits`` key) leaves the
    bundle's bitset as it is.
    """
    state = read_checkpoint(path)
    _check_fits(path, state, bundle)
    for key in MODULES:
        if key in bundle:
            bundle[key].load_state_dict(state[key])
    with torch.no_grad():
        for key in TENSORS:
            if key in state:
                bundle[key].copy_(state[key])
    bundle.pop("folded", None)
    return bundle


def load_checkpoint_partial(path, bundle: dict) -> dict:
    """Best-effort load into ``bundle`` in place; returns ``bundle``.

    The port of JAX's ``load_checkpoint_partial`` (the reference's
    ``load_partial``, network/mod.rs:28-35, which evaluation uses on
    checkpoints of other architectures): a tensor of the file whose key the
    bundle lacks is ignored, and a weight the file lacks or holds in another
    shape or dtype keeps the bundle's value.  Each such key is logged.  A
    JAX run's flax file is read leaf by leaf in the port's layout, so the
    same tolerance holds for it (``takzero_tpu/utils/ckpt.py:176``).  A
    file of neither format still raises :class:`ForeignCheckpoint`: a
    partial load is no fallback for a file of another format.
    """
    log = logging.getLogger("ckpt")
    have, targets = _file_tensors(read_checkpoint(path)), _bundle_tensors(bundle)
    with torch.no_grad():
        for key, dst in targets.items():
            src = have.get(key)
            if src is None:
                if key != "hash_bits":  # a weights-only file keeps the seen-set
                    log.warning("%s: no %s, keeping the bundle's", path, key)
                continue
            if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
                got = (tuple(src.shape), src.dtype) if isinstance(src, torch.Tensor) else type(src).__name__
                log.warning("%s: %s is %s, the bundle holds %s; keeping the bundle's",
                            path, key, got, (tuple(dst.shape), dst.dtype))
                continue
            dst.copy_(src)
    for key in sorted(set(have) - set(targets)):
        log.warning("%s: ignoring %s, which the bundle has not", path, key)
    bundle.pop("folded", None)
    return bundle


def model_path_with_most_steps(directory):
    """(step, path) of the highest-numbered checkpoint, or None."""
    directory = pathlib.Path(directory)
    best = None
    if not directory.is_dir():
        return None
    for p in directory.iterdir():
        m = _STEP_RE.search(p.name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, p)
    return best


def resume_with_hash_log(directory, bundle: dict, log, reconcile: bool):
    """Load the highest-step checkpoint into ``bundle`` and, with
    ``reconcile``, re-append the bitset's bits missing from the hash log.

    Returns ``(bundle, steps)``; ``steps == 0`` means a fresh start (the
    caller writes ``model_0000000.ckpt``)."""
    resume = model_path_with_most_steps(directory)
    if resume is None:
        return bundle, 0
    steps, path = resume
    log.info("resuming from %s at step %d", path, steps)
    load_checkpoint(path, bundle)
    if reconcile:
        bits = bundle["hash_bits"].cpu().numpy().view(np.uint32)
        missing = reconcile_hash_log(directory, bits)
        if missing:
            log.info("hash log reconciled: %d bits re-appended", missing)
    return bundle, steps


def latest_path(directory) -> pathlib.Path:
    return pathlib.Path(directory) / "model_latest.ckpt"


class LatestPoller:
    """An actor's view of the learner's ``model_latest.ckpt`` and
    ``hash_log.bin`` (selfplay/src/main.rs:89-125).

    ``reload_if_changed`` ORs the hash-log indices appended since the last
    call into the bundle's seen-set, in place, with ``bitset_set``, and
    reloads the weights only when the file's ``(mtime_ns, size)`` changed.
    A weights-only file leaves the seen-set to the hash log (the rule of
    :func:`load_checkpoint`); everything else comes with the file: the
    hash constants, so the actor hashes as the learner does from its first
    reload on, and the RND predictor, target and bounds, so it normalizes
    the RND error as the learner does.

    A torn or truncated read keeps the current weights, logs why, and is
    tried again at the next call.  A file of another format
    (:class:`ForeignCheckpoint`) or structure (:class:`CheckpointMismatch`)
    raises: trying again would not help.
    """

    def __init__(self, directory):
        self._path = latest_path(directory)
        self._hash_path = pathlib.Path(directory) / HASH_LOG
        self._hash_off = 0
        self._sig = None
        self.reloads = 0  # weight reloads so far

    def _apply_hash_delta(self, bundle: dict) -> bool:
        if "hash_bits" not in bundle:
            return False
        idx, self._hash_off = read_hash_indices(self._hash_path, self._hash_off)
        if idx.size == 0:
            return False
        bits = bundle["hash_bits"]
        bitset_set(bits, torch.from_numpy(idx.astype(np.int64)).to(bits.device))
        return True

    def reload_if_changed(self, bundle: dict, log=None):
        """``(bundle, changed)``: the bundle updated in place, and whether
        its weights or its seen-set changed."""
        hash_changed = self._apply_hash_delta(bundle)
        try:
            st = os.stat(self._path)
        except OSError:
            return bundle, hash_changed
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._sig:
            return bundle, hash_changed
        try:
            load_checkpoint(self._path, bundle)
        except (ForeignCheckpoint, CheckpointMismatch):
            raise
        except (OSError, ValueError, RuntimeError, EOFError, pickle.UnpicklingError) as e:  # a torn read
            if log is not None:
                log.warning("cannot load %s (%s), keeping the current weights", self._path, e)
            return bundle, hash_changed
        self._sig = sig
        self.reloads += 1
        return bundle, True


class AsyncSaver:
    """Background checkpoint writer.

    ``submit`` snapshots the bundle at once (tensor copies on its device,
    queued on the current stream before any later train step), and a
    worker thread moves the snapshot to the host and writes it, so the
    training loop keeps going.  Writes keep their order.  A failed write is
    logged at once and re-raised at the next ``submit`` or ``drain``.
    Submitting a name that is still queued replaces its snapshot (newest
    wins), so slow saves coalesce instead of queueing without bound.
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._order: collections.deque = collections.deque()
        self._pending: dict = {}
        self._errors: list = []
        self._busy = False
        self._log = logging.getLogger("ckpt")
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            with self._lock:
                while not self._order:
                    self._lock.wait()
                name = self._order.popleft()
                directory, state = self._pending.pop(name)
                self._busy = True
            try:
                _write(directory, name, state)
            except Exception as e:  # logged now, re-raised at the next submit
                self._log.error("async checkpoint save of %s failed: %s", name, e)
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    self._busy = False
                    self._lock.notify_all()

    def _raise_pending_errors(self):
        with self._lock:
            if self._errors:
                err = self._errors[0]
                self._errors.clear()
                raise err

    def submit(self, directory, name: str, bundle: dict):
        self._raise_pending_errors()
        state = checkpoint_state(bundle, clone=True)
        with self._lock:
            if name not in self._pending:
                self._order.append(name)
            self._pending[name] = (directory, state)  # newest wins
            self._lock.notify_all()

    def drain(self):
        """Block until every queued save is on disk; re-raise the first error."""
        with self._lock:
            while self._order or self._busy:
                self._lock.wait()
        self._raise_pending_errors()
