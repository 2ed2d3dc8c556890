"""Session logger: printf-style tee to stdout + append/overwrite log file.

A copy of ``volrt/utils/logger.py``, which cannot be imported without
loading jax (``volrt/__init__.py``); ``tests/test_torch_utils.py`` holds
the two to the same code. Rebuilds the reference ``Logger`` (reference:
Logger.cpp:14-70): session banner with timestamp on init, every message
tee'd to console and flushed to file, optional per-message timestamps,
total runtime accounting on close.
"""
from __future__ import annotations

import atexit
import time
from typing import IO


class Logger:
    def __init__(self, path: str | None = "volrt.log", mode: str = "a",
                 quiet: bool = False):
        self._file: IO | None = None
        self._quiet = quiet
        self._start = time.time()
        if path:
            self._file = open(path, mode)
        self.log(
            "session started at %s",
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(self._start)),
        )
        atexit.register(self.close)

    def log(self, fmt: str, *args) -> None:
        msg = (fmt % args) if args else fmt
        if not self._quiet:
            print(msg, flush=True)
        if self._file:
            self._file.write(msg + "\n")
            self._file.flush()

    def log_time(self, fmt: str, *args) -> None:
        """Message prefixed with seconds since session start
        (reference: Logger.cpp log_time)."""
        self.log(f"[{time.time() - self._start:9.3f}s] {fmt}", *args)

    def close(self) -> None:
        if self._file:
            self.log(
                "session closed; total runtime %.1f s",
                time.time() - self._start,
            )
            f, self._file = self._file, None
            f.close()


_default: Logger | None = None


def get_logger() -> Logger:
    global _default
    if _default is None:
        _default = Logger(path=None)
    return _default


def set_logger(logger: Logger) -> None:
    global _default
    _default = logger
