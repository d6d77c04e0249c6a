"""Shared-filesystem actor-learner coordination protocol.

The port's own copy of ``takzero_tpu/parallel/coordinator.py``.  Processes coordinate through a
shared directory: append-only target and replay files tailed through
persistent byte offsets, and a checksummed ``buffer_lengths.txt`` that the
learner writes and the actors wait on (backpressure).  The file names and
formats are those of the JAX package (and of the reference), because JAX
and torch processes may share one run directory.
"""

from __future__ import annotations

import pathlib
import time

TARGETS_SELFPLAY = "targets-selfplay.txt"
TARGETS_REANALYZE = "targets-reanalyze.txt"
TARGETS_INITIAL = "targets-initial.txt"
REPLAYS = "replays.txt"
REPLAYS_EXPLORATION = "replays-exploration.txt"
BUFFER_LENGTHS = "buffer_lengths.txt"


def append_lines(directory, name: str, lines) -> None:
    path = pathlib.Path(directory) / name
    data = "".join(line.rstrip("\n") + "\n" for line in lines)
    with open(path, "a", encoding="utf-8") as f:
        f.write(data)


class Tailer:
    """Incremental line reader with a persistent offset (learn:292-320).

    A rotated or rewritten file resets the offset to 0 instead of leaving
    the reader seeking past its end forever.  Size alone cannot detect an
    equal-or-longer replacement, so the inode and the first consumed bytes
    are checked too.
    """

    _SIG_LEN = 64

    def __init__(self, directory, name: str):
        self.path = pathlib.Path(directory) / name
        self.offset = 0
        self.inode = None
        self.sig = b""  # first min(offset, _SIG_LEN) bytes already consumed

    def read_new_lines(self) -> list[str]:
        if not self.path.exists():
            return []
        st = self.path.stat()
        if st.st_size < self.offset or (self.inode is not None and st.st_ino != self.inode):
            self.offset = 0  # file was truncated/rotated
            self.sig = b""
        self.inode = st.st_ino
        if self.sig:
            # Same inode, size >= offset: confirm it is still the same
            # content (an in-place rewrite reuses the inode).
            with open(self.path, "rb") as f:
                if f.read(len(self.sig)) != self.sig:
                    self.offset = 0
                    self.sig = b""
        # Binary read: offsets, sig and st_size all count bytes.
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read()
            # Only consume complete lines (writers append whole lines).
            last_nl = data.rfind(b"\n")
            if last_nl < 0:
                return []
            consumed = data[: last_nl + 1]
            if len(self.sig) < self._SIG_LEN:
                self.sig += consumed[: self._SIG_LEN - len(self.sig)]
            self.offset += last_nl + 1
            return consumed.decode("utf-8").splitlines()


def write_buffer_lengths(directory, selfplay: int, reanalyze: int) -> None:
    """Truncate-rewrite with a sum checksum (learn:195-209)."""
    path = pathlib.Path(directory) / BUFFER_LENGTHS
    tmp = path.with_suffix(".tmp")
    tmp.write_text(f"{selfplay},{reanalyze},{selfplay + reanalyze}")
    tmp.replace(path)


def read_buffer_lengths(directory) -> tuple[int, int] | None:
    """Returns (selfplay, reanalyze) or None on missing/torn/bad checksum
    (selfplay/src/main.rs:371-387)."""
    path = pathlib.Path(directory) / BUFFER_LENGTHS
    try:
        parts = path.read_text().split(",")
        s, r, c = (int(x) for x in parts[:3])
    except (OSError, ValueError):
        return None
    if s + r != c:
        return None
    return s, r


def backpressure_hit(directory, max_buffer: int, which: int = 0) -> bool:
    """One non-blocking check: is buffer ``which`` (0 selfplay, 1
    reanalyze) over ``max_buffer``?  A missing or torn file is no hit."""
    lengths = read_buffer_lengths(directory)
    return lengths is not None and lengths[which] > max_buffer


def coordinated_backpressure(multi, coord: bool, directory, max_buffer: int, which: int = 0,
                             max_wait: float | None = None) -> None:
    """Backpressure for the ranks of one job: polling the file on every
    rank can diverge (a rank reads the learner's rewrite a moment later)
    and leave one rank asleep while its peers wait in a collective of the
    next step, so the coordinator decides and every rank follows, through
    one short broadcast a second (never one long blocking one).
    ``multi`` is the ``parallel.multihost`` module (``broadcast_scalar``)."""
    waited = 0.0
    while True:
        clear = True
        if coord:
            clear = not backpressure_hit(directory, max_buffer, which)
        if bool(multi.broadcast_scalar(clear)):
            return
        time.sleep(1.0)
        waited += 1.0
        if max_wait is not None and waited >= max_wait:
            return


def wait_for_backpressure(directory, max_buffer: int, which: int = 0, poll_seconds: float = 1.0,
                          max_wait: float | None = None) -> None:
    """Sleep while our buffer is over ``max_buffer`` (selfplay:93-104), at
    most ``max_wait`` seconds when it is given."""
    waited = 0.0
    while backpressure_hit(directory, max_buffer, which):
        if max_wait is not None and waited >= max_wait:
            return
        time.sleep(poll_seconds)
        waited += poll_seconds
