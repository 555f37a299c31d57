"""Postmortem bundles: dump everything diagnosable the moment it breaks.

A bundle is one directory capturing the state around a trigger — an
anomaly, a ring stall, an unhandled crash — written by
:class:`PostmortemWriter`:

- ``manifest.json``   — reason, trigger detail, timestamps, pid/proc;
- ``flight.jsonl``    — the flight-recorder ring (the moments *before*);
- ``metrics.prom``    — a full ``REGISTRY.render()`` snapshot;
- ``trace.json``      — Chrome trace-event JSON of the offending window
  (caller-provided spans as duration events + flight events as instant
  events — loadable in Perfetto next to a ``/trace`` export);
- ``config.json``     — whatever run configuration the caller holds;
- ``runlog_tail.jsonl`` — the tail of the active structured run log;
- ``timelines.jsonl`` — recent per-request SLO timeline records from
  the SLO ledger (``telemetry/slo.py``): queue wait / TTFT / per-token
  / migration-pause decomposition for the requests leading up to the
  trigger.

Writing is best-effort everywhere: a postmortem must never add a second
failure to the one being recorded (a full disk degrades to a partial
bundle, not an exception in the serving loop).  Bundles are pruned to
``max_bundles`` newest so a flapping detector cannot fill the disk, and
the module-level :func:`trigger` is the one call sites use — it is a
no-op until a writer is configured (``DWT_POSTMORTEM_DIR`` or
:func:`set_postmortem_writer`), so the hot paths stay free when the
operator hasn't asked for black-box capture.

``tools/postmortem.py`` is the offline half: it reads a bundle back and
summarizes it down to the offending hop/window.

A copy of ``distributed_inference_demo_tpu/telemetry/postmortem.py``:
the port keeps its own, so a process that imports both packages holds
two independent instances.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import List, Optional

_RUNLOG_TAIL_BYTES = 64 * 1024


def _json_default(o):
    return str(o)


class PostmortemWriter:
    """Writes bundles under ``out_dir``; thread-safe; prunes old ones."""

    def __init__(self, out_dir: str, max_bundles: int = 16,
                 clock=time.time, proc: str = ""):
        self.out_dir = out_dir
        self.max_bundles = max(1, max_bundles)
        self.proc = proc
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        os.makedirs(out_dir, exist_ok=True)   # fail loudly at CONFIG time

    # -- capture -----------------------------------------------------------

    def write_bundle(self, reason: str, detail: Optional[dict] = None,
                     config: Optional[dict] = None,
                     spans: Optional[List[dict]] = None) -> Optional[str]:
        """Capture one bundle; returns its directory path (None if even
        the directory could not be created)."""
        from .flightrecorder import get_flight_recorder
        ts = self._clock()
        with self._lock:
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(ts))
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        # pid in the name: processes routinely SHARE an out_dir (a ring's
        # workers + header), and two same-second crashes with the same
        # per-process seq must not overwrite each other's black box
        path = os.path.join(
            self.out_dir,
            f"pm-{stamp}-p{os.getpid()}-{seq:03d}-{safe}")
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None

        events = get_flight_recorder().snapshot()
        manifest = {
            "reason": reason,
            "ts": round(ts, 6),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "pid": os.getpid(),
            "proc": self.proc,
            "detail": detail or {},
            "flight_events": len(events),
        }
        self._write_json(path, "manifest.json", manifest)
        self._write_lines(path, "flight.jsonl",
                          (json.dumps(e, default=_json_default)
                           for e in events))
        self._write_text(path, "metrics.prom", self._render_metrics())
        self._write_json(path, "trace.json",
                         self._chrome_trace(spans or [], events))
        if config is not None:
            self._write_json(path, "config.json", config)
        tail = self._runlog_tail()
        if tail:
            self._write_text(path, "runlog_tail.jsonl", tail)
        timelines = self._timelines()
        if timelines:
            self._write_text(path, "timelines.jsonl", timelines)
        self._count_bundle()
        self._prune()
        return path

    # -- pieces (each isolated: one failing source loses one file) ---------

    @staticmethod
    def _render_metrics() -> str:
        try:
            from .catalog import REGISTRY, update_flight_series
            update_flight_series()
            return REGISTRY.render()
        except Exception as e:
            return f"# metrics snapshot failed: {e}\n"

    @staticmethod
    def _chrome_trace(spans: List[dict], events: List[dict]) -> dict:
        from .tracing import to_chrome_trace
        try:
            trace = to_chrome_trace(spans)
        except Exception:
            trace = {"traceEvents": [], "displayTimeUnit": "ms"}
        for e in events:
            # flight events as instant markers on one shared lane, so
            # Perfetto shows admissions/hops/stalls against the spans
            trace["traceEvents"].append({
                "ph": "i", "s": "g", "name": e.get("kind", "?"),
                "pid": 0, "tid": 0,
                "ts": int(float(e.get("ts", 0)) * 1e6),
                "args": {k: v for k, v in e.items()
                         if k not in ("ts", "kind")},
            })
        return trace

    @staticmethod
    def _timelines() -> str:
        try:
            from .slo import timelines_jsonl
            lines = timelines_jsonl()
            return "\n".join(lines) + "\n" if lines else ""
        except Exception:
            return ""

    @staticmethod
    def _runlog_tail() -> str:
        from .runlog import get_run_log
        rl = get_run_log()
        path = getattr(rl, "path", None)
        if not path or not os.path.exists(path):
            return ""
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - _RUNLOG_TAIL_BYTES))
                data = f.read()
            # drop a partial first line after the seek
            if size > _RUNLOG_TAIL_BYTES and b"\n" in data:
                data = data.split(b"\n", 1)[1]
            return data.decode("utf-8", "replace")
        except OSError:
            return ""

    def _write_json(self, path: str, name: str, obj) -> None:
        try:
            with open(os.path.join(path, name), "w",
                      encoding="utf-8") as f:
                json.dump(obj, f, indent=1, default=_json_default)
        except OSError:
            pass

    def _write_text(self, path: str, name: str, text: str) -> None:
        try:
            with open(os.path.join(path, name), "w",
                      encoding="utf-8") as f:
                f.write(text)
        except OSError:
            pass

    def _write_lines(self, path: str, name: str, lines) -> None:
        try:
            with open(os.path.join(path, name), "w",
                      encoding="utf-8") as f:
                for line in lines:
                    f.write(line + "\n")
        except OSError:
            pass

    @staticmethod
    def _count_bundle() -> None:
        try:
            from .catalog import ANOMALY_POSTMORTEMS
            ANOMALY_POSTMORTEMS.inc()
        except Exception:
            pass

    def _bundle_names(self) -> List[str]:
        """Bundle directory names, oldest first — ordered by mtime, not
        name (the unpadded pid in the name makes lexicographic order
        non-chronological across processes sharing the directory)."""

        def mtime(d: str) -> float:
            try:
                return os.path.getmtime(os.path.join(self.out_dir, d))
            except OSError:
                return 0.0

        try:
            dirs = [d for d in os.listdir(self.out_dir)
                    if d.startswith("pm-")]
        except OSError:
            return []
        return sorted(dirs, key=lambda d: (mtime(d), d))

    def _prune(self) -> None:
        for d in self._bundle_names()[:-self.max_bundles]:
            full = os.path.join(self.out_dir, d)
            try:
                for name in os.listdir(full):
                    os.unlink(os.path.join(full, name))
                os.rmdir(full)
            except OSError:
                pass

    def bundle_dirs(self) -> List[str]:
        """Bundle paths, oldest first (same mtime order as the pruner)."""
        return [os.path.join(self.out_dir, d)
                for d in self._bundle_names()]


# -- process-default writer + trigger (the call-site surface) --------------

_default: Optional[object] = None      # None-not-yet / _DISABLED / writer
_DISABLED = object()
_default_lock = threading.Lock()


def set_postmortem_writer(writer: Optional[PostmortemWriter]) -> None:
    """Install the process-default writer (``None`` resets to the lazy
    ``DWT_POSTMORTEM_DIR`` resolution)."""
    global _default
    with _default_lock:
        _default = writer


def get_postmortem_writer() -> Optional[PostmortemWriter]:
    """The process-default writer, or None when postmortem capture is
    not configured.  Lazily honors ``DWT_POSTMORTEM_DIR``; an unusable
    path degrades to disabled with one stderr warning (ambient config
    must not crash a serving path)."""
    global _default
    if _default is _DISABLED:
        return None
    if _default is not None:
        return _default
    with _default_lock:
        if _default is None:
            out = os.environ.get("DWT_POSTMORTEM_DIR", "")
            if not out:
                _default = _DISABLED
            else:
                try:
                    _default = PostmortemWriter(out)
                except OSError as e:
                    print(f"postmortem: cannot use {out!r}: {e}; "
                          "bundles disabled", file=sys.stderr)
                    _default = _DISABLED
    return None if _default is _DISABLED else _default


def trigger(reason: str, detail: Optional[dict] = None,
            config: Optional[dict] = None,
            spans: Optional[List[dict]] = None) -> Optional[str]:
    """Write a bundle through the process-default writer.  No-op (None)
    when capture is unconfigured; never raises into the caller — the
    trigger sits on failure paths that must stay failure paths."""
    w = get_postmortem_writer()
    if w is None:
        return None
    try:
        return w.write_bundle(reason, detail=detail, config=config,
                              spans=spans)
    except Exception as e:
        print(f"postmortem: bundle write failed: {e}", file=sys.stderr)
        return None


def debug_state() -> dict:
    """The postmortem fragment of a ``GET /debugz`` payload — ONE owner
    for the shape (see ``flightrecorder.debug_state``)."""
    w = get_postmortem_writer()
    return ({"dir": w.out_dir, "bundles": w.bundle_dirs()}
            if w is not None else {"dir": None, "bundles": []})


_crash_installed = False


def install_crash_handler(config: Optional[dict] = None) -> None:
    """Chain sys/threading excepthooks so an unhandled crash dumps a
    ``crash`` bundle before the process dies (the black box's raison
    d'être).  Idempotent; the previous hooks still run afterwards."""
    global _crash_installed
    if _crash_installed:
        return
    _crash_installed = True
    prev_sys = sys.excepthook

    def _detail(exc_type, exc, tb) -> dict:
        return {"exc_type": getattr(exc_type, "__name__", str(exc_type)),
                "exc": str(exc),
                "traceback": traceback.format_exception(exc_type, exc,
                                                        tb)}

    def hook(exc_type, exc, tb):
        # deliberate shutdowns are not crashes: a Ctrl-C'd rolling
        # restart must not write bundles that prune real incidents
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            trigger("crash", detail=_detail(exc_type, exc, tb),
                    config=config)
        prev_sys(exc_type, exc, tb)

    sys.excepthook = hook

    prev_thread = threading.excepthook

    def thread_hook(args):
        if not issubclass(args.exc_type,
                          (KeyboardInterrupt, SystemExit)):
            trigger("crash", detail=dict(
                _detail(args.exc_type, args.exc_value, args.exc_traceback),
                thread=getattr(args.thread, "name", "?")), config=config)
        prev_thread(args)

    threading.excepthook = thread_hook
