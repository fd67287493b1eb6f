"""Structured event output: the JSONL sink + the shared ``repro_torch`` logger.

The port of ``repro.runtime.events``, the thin I/O half of the KronScope
telemetry spine (``repro_torch.runtime.telemetry``): telemetry decides WHAT
to record, this module decides WHERE it goes.  Two destinations:

* ``EventSink`` — an append-only JSONL file (one JSON object per line).
  Opened lazily on the first emit, so configuring telemetry without ever
  recording costs no filesystem work; every write is a single line, so a
  killed process leaves a valid prefix, never a torn file.

* ``get_logger`` — the shared ``repro_torch`` logger hierarchy.  Its root
  gets ONE stdout handler with a bare ``%(message)s`` format, so output
  routed through it reads like ``print`` while staying capturable and
  redirectable like any stdlib logger.  The root is ``repro_torch``, not the
  reference's ``repro``, so the two packages in one process keep separate
  handlers.
"""
from __future__ import annotations

import json
import logging
import sys
import threading


class EventSink:
    """Append-only JSONL sink: one JSON object per ``emit``, one per line."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = None
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, record: dict) -> None:
        line = json.dumps(record, default=str, sort_keys=True)
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(line + "\n")
            self.emitted += 1

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_LOGGER_LOCK = threading.Lock()
ROOT_LOGGER = "repro_torch"


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that resolves ``sys.stdout`` at emit time, not at
    construction, so the logger follows stdout redirection exactly like
    ``print`` does."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):  # base __init__/setStream assign; late-bound
        pass


def get_logger(name: str = ROOT_LOGGER) -> logging.Logger:
    """The shared ``repro_torch`` logger (or a child, e.g.
    ``repro_torch.guard``).  The root is configured once per process with a
    single stdout handler and a bare message format."""
    root = logging.getLogger(ROOT_LOGGER)
    with _LOGGER_LOCK:
        if not root.handlers:
            handler = _StdoutHandler()
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
            root.setLevel(logging.INFO)
            root.propagate = False
    return logging.getLogger(name) if name else root


__all__ = ["EventSink", "get_logger"]
