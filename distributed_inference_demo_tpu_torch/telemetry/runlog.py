"""Structured JSONL run logs: one event per line, one file per run.

Replaces scattered prints as the machine-readable record of a run: the
bench harness, the engines, and the control-plane lifecycle all emit
through one surface.  Every line is a self-contained JSON object::

    {"ts": <epoch seconds>, "run_id": "...", "event": "<kind>", ...fields}

Enabling: pass a path explicitly (``RunLog(path)`` + ``set_run_log``), use
``serve --run-log`` / ``bench --run-log``, or set ``DWT_RUN_LOG=<path>``
in the environment — any process in the deployment then appends to its
own file (the path gets a ``.<pid>`` suffix when it would be shared, so
workers never interleave partial lines with the header).  When nothing is
configured, ``get_run_log()`` returns a no-op sink: instrumented hot paths
cost one attribute check.

A copy of ``distributed_inference_demo_tpu/telemetry/runlog.py``: the
port keeps its own, so a process that imports both packages holds two
independent instances.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import IO, Optional


def new_run_id() -> str:
    return uuid.uuid4().hex[:16]


class RunLog:
    """Append-only JSONL event sink.  Thread-safe; every event is one
    ``write`` + ``flush`` so a crash loses at most the in-flight line.

    ``max_bytes`` (or ``DWT_RUN_LOG_MAX_BYTES``) bounds the file for
    long serving runs: when appending a line would push the file past
    the limit, the current file rolls to ``<path>.1`` (replacing any
    previous rollover) and a fresh file starts — at most two
    generations, so disk stays O(2 x max_bytes) forever.  0 disables
    rollover; fileobj-backed logs never roll (no path to rename)."""

    enabled = True

    def __init__(self, path: Optional[str] = None,
                 fileobj: Optional[IO[str]] = None,
                 run_id: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        if (path is None) == (fileobj is None):
            raise ValueError("RunLog needs exactly one of path/fileobj")
        if max_bytes is None:
            from ._env import env_int
            max_bytes = env_int("DWT_RUN_LOG_MAX_BYTES", 0)
        self.max_bytes = max(0, max_bytes)
        self.run_id = run_id or new_run_id()
        self.path = path
        # opened EAGERLY: a bad --run-log path must fail loudly at
        # startup, not silently drop every event of the run
        self._f = fileobj if fileobj is not None else open(
            path, "a", encoding="utf-8")
        self._nbytes = 0
        if path is not None:
            try:
                self._nbytes = os.path.getsize(path)
            except OSError:
                pass
        self._lock = threading.Lock()

    def _maybe_roll(self, incoming: int) -> None:
        """Roll the file when the next line would cross ``max_bytes``.
        Caller holds the lock.  ``_nbytes > 0`` guards a line larger
        than the whole budget: it lands in a fresh file instead of
        rolling forever."""
        if (self.path is None or not self.max_bytes
                or self._nbytes + incoming <= self.max_bytes
                or self._nbytes == 0):
            return
        # each step is isolated: a failed rename must not leave a CLOSED
        # handle installed (every later event would silently die on it) —
        # the reopen below runs regardless, so appending continues into
        # whichever file the filesystem let us keep
        try:
            self._f.close()
        except (OSError, ValueError):
            pass
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass    # rename refused: reopen the (unrotated) file below
        try:
            self._f = open(self.path, "a", encoding="utf-8")
            self._nbytes = os.path.getsize(self.path)
        except OSError:
            self._f = None    # event() treats None as closed

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": round(time.time(), 6), "run_id": self.run_id,
               "event": kind}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError):
            line = json.dumps({"ts": rec["ts"], "run_id": self.run_id,
                               "event": kind,
                               "error": "unserializable fields"}) + "\n"
        nbytes = len(line.encode("utf-8"))
        with self._lock:
            if self._f is None:
                return          # closed
            self._maybe_roll(nbytes)
            if self._f is None:
                return          # rollover reopen failed (disk/perm)
            try:
                self._f.write(line)
                self._f.flush()
                self._nbytes += nbytes
            except (OSError, ValueError):
                pass    # a full disk must never take down the serving loop

    def close(self) -> None:
        with self._lock:
            if self._f is not None and self.path is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


class _NullRunLog:
    """No-op sink returned when no run log is configured."""

    enabled = False
    run_id = ""

    def event(self, kind: str, **fields) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _NullRunLog()
_default: object = None
_default_lock = threading.Lock()


def set_run_log(runlog) -> None:
    """Install the process-default run log (``None`` restores the no-op)."""
    global _default
    with _default_lock:
        _default = runlog


def get_run_log():
    """The process-default run log.  Lazily honors ``DWT_RUN_LOG``: the
    first call in a process with the env var set opens
    ``$DWT_RUN_LOG.<pid>`` (per-process files — concurrent workers must
    not interleave lines in one file).  An unopenable env path degrades
    to the no-op sink with one stderr warning — the env var is ambient
    configuration and must not crash a serving hot path."""
    global _default
    if _default is not None:
        return _default
    with _default_lock:
        if _default is None:
            path = os.environ.get("DWT_RUN_LOG", "")
            if path:
                try:
                    _default = RunLog(f"{path}.{os.getpid()}")
                except OSError as e:
                    import sys
                    print(f"runlog: cannot open {path!r}: {e}; run-log "
                          "events disabled", file=sys.stderr)
                    _default = NULL
            else:
                _default = NULL
    return _default
