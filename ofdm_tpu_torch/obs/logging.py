"""Colored console logging (rebuilds src/logging.rs:4-50's fern setup)."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[35m",     # magenta
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        ts = self.formatTime(record, "%H:%M:%S")
        return (f"{color}[{ts}.{int(record.msecs * 1e6):09d}]"
                f"[{record.name}][{record.levelname}]{_RESET} {record.getMessage()}")


def set_up_logging(binname: str = "ofdm_tpu", level: int = logging.INFO) -> logging.Logger:
    """Console logger: ns-ish timestamps, per-level colors, Debug for the
    named binary (mirrors set_up_logging's level policy)."""
    root = logging.getLogger()
    root.setLevel(level)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(_ColorFormatter())
    root.handlers[:] = [handler]
    logging.getLogger(binname).setLevel(logging.DEBUG)
    return logging.getLogger(binname)
