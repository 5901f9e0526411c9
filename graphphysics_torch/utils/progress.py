"""In-place terminal progress line for the training and validation loops
(counterpart of ``graphphysics_tpu/utils/progress.py``): one carriage-return
line, on only when the stream is a TTY unless asked, throttled, and fed only
host values, so it never synchronizes the device."""

from __future__ import annotations

import sys
import time
from typing import Optional, TextIO


class ProgressReporter:
    """Throttled single-line progress display. ``enable=None`` turns it on
    when ``stream.isatty()``. Every value passed to ``update`` must already
    be on the host."""

    def __init__(
        self,
        total: Optional[int],
        prefix: str = "",
        stream: Optional[TextIO] = None,
        enable: Optional[bool] = None,
        min_interval: float = 0.5,
    ):
        self.stream = stream if stream is not None else sys.stderr
        if enable is None:
            enable = bool(getattr(self.stream, "isatty", lambda: False)())
        self.enabled = enable
        self.total = total
        self.prefix = prefix
        self.min_interval = min_interval
        self._start = time.perf_counter()
        self._last_write = 0.0
        self._last_len = 0

    def update(self, n: int, **stats) -> None:
        """Report progress ``n`` (a running count, not an increment)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_write < self.min_interval and (self.total is None or n < self.total):
            return
        self._last_write = now
        parts = [self.prefix] if self.prefix else []
        parts.append(f"{n}/{self.total}" if self.total else str(n))
        parts.append(f"{n / max(now - self._start, 1e-9):.2f} it/s")
        parts += [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in stats.items()]
        line = " ".join(parts)
        self.stream.write("\r" + line + " " * max(self._last_len - len(line), 0))
        self.stream.flush()
        self._last_len = len(line)

    def close(self) -> None:
        """End the in-place line (nothing when disabled)."""
        if self.enabled and self._last_len:
            self.stream.write("\r" + " " * self._last_len + "\r")
            self.stream.flush()
            self._last_len = 0
