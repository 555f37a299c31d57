"""Flight recorder: a bounded, always-on ring of recent runtime events.

The aircraft-black-box layer: every process keeps the last N interesting
moments — engine generate calls, ring hop send/recv, batching admissions
and completions, lifecycle transitions — in a fixed-size in-memory ring.
Nothing is written anywhere until something goes wrong; then the
postmortem writer (``telemetry/postmortem.py``) dumps the ring next to a
metrics snapshot and the run-log tail, so the moments *before* a stall or
crash are diagnosable after the fact without re-running.

Events are plain dicts ``{"ts": <epoch s>, "kind": "<what>", ...fields}``
— the same shape as run-log lines, so a bundle's ``flight.jsonl`` and
``runlog_tail.jsonl`` read with the same tools.  Recording is one dict
build + a locked deque append (~µs), cheap enough to leave on in the ring
hot loop; memory is O(``max_events``) forever.

Like ``runlog``, a process-default recorder is available via
:func:`get_flight_recorder` so instrumentation points don't thread a
recorder handle through every constructor.  Unlike runlog there is no
null variant: the ring is always on (that is the point of a black box),
and ``DWT_FLIGHT_EVENTS=0`` shrinks it to a single slot rather than
adding an enabled-check branch to every call site.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from ._env import env_int

_MAX_EVENTS = 4096


class FlightRecorder:
    """Bounded per-process event ring.  Thread-safe; ``total`` counts
    every event ever recorded (overwritten ones included) so the
    ``dwt_flight_events_total`` counter stays monotone while the ring
    wraps."""

    def __init__(self, proc: str = "", max_events: Optional[int] = None,
                 clock=time.time):
        if max_events is None:
            max_events = env_int("DWT_FLIGHT_EVENTS", _MAX_EVENTS)
        self.proc = proc
        self.capacity = max(1, int(max_events))
        self._clock = clock
        self._events: "deque[dict]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total = 0

    def record(self, kind: str, **fields) -> None:
        ev = {"ts": round(self._clock(), 6), "kind": kind}
        if self.proc:
            ev["proc"] = self.proc
        if fields:
            ev.update(fields)
        with self._lock:
            self._events.append(ev)
            self.total += 1

    def snapshot(self) -> List[dict]:
        """Every buffered event, oldest first (does not drain — the ring
        keeps recording; a postmortem capture must not blind the next
        one)."""
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> List[dict]:
        with self._lock:
            if n >= len(self._events):
                return list(self._events)
            return list(self._events)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Install the process-default recorder (``None`` resets so the next
    :func:`get_flight_recorder` builds a fresh one — test isolation)."""
    global _default
    with _default_lock:
        _default = recorder


def get_flight_recorder() -> FlightRecorder:
    """The process-default flight recorder, created on first use."""
    global _default
    if _default is not None:
        return _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
    return _default


def debug_state(tail: int = 128) -> dict:
    """The flight fragment of a ``GET /debugz`` payload — ONE owner for
    the shape, shared by the header HTTP server and the worker metrics
    server so the two endpoints cannot drift."""
    fr = get_flight_recorder()
    return {"total": fr.total, "buffered": len(fr),
            "capacity": fr.capacity, "tail": fr.tail(tail)}
