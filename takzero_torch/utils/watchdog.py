"""Host-RSS watchdog for long-lived driver processes.

Counterpart of ``takzero_tpu/utils/watchdog.py``: a daemon thread polls
``/proc/self/status`` VmRSS and calls ``os._exit(42)`` once it passes the
limit, so a leaking evaluation subprocess ends with an exit code that its
supervisor (``tools/elo_curve.py``) recognises and relaunches, instead of
the kernel's OOM killer taking the host.  ``os._exit`` because normal
interpreter teardown may hang in a stalled device runtime.
"""

from __future__ import annotations

import logging
import os
import threading
import time

log = logging.getLogger("watchdog")

RSS_EXIT_CODE = 42


def read_rss_gb(pid: int | None = None) -> float:
    """Current resident set size in GiB (0.0 if unreadable)."""
    try:
        with open(f"/proc/{pid or 'self'}/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


def start_rss_watchdog(limit_gb: float, interval_s: float = 5.0) -> threading.Thread | None:
    """Start a daemon thread that exits with ``RSS_EXIT_CODE`` once RSS
    exceeds ``limit_gb``.

    Returns the thread, or None when ``limit_gb`` is falsy (disabled).
    """
    if not limit_gb:
        return None

    def watch() -> None:
        while True:
            rss = read_rss_gb()
            if rss > limit_gb:
                log.error("RSS %.1f GiB exceeds limit %.1f GiB, exiting %d", rss, limit_gb, RSS_EXIT_CODE)
                for h in logging.getLogger().handlers:
                    h.flush()
                os._exit(RSS_EXIT_CODE)
            time.sleep(interval_s)

    t = threading.Thread(target=watch, name="rss-watchdog", daemon=True)
    t.start()
    log.info("RSS watchdog armed at %.1f GiB", limit_gb)
    return t
