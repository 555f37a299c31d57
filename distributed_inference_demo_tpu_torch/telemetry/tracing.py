"""Distributed request tracing: spans across the ring, Chrome trace export.

Each generate/classify request is assigned a 64-bit trace id at the header.
The id (plus the sender's span id as parent) rides every data-plane hop as
a wire trailer (``comm/wire.py`` ``FLAG_TRACE_CONTEXT``), so every stage
tags its ``recv_wait`` / ``compute`` / ``send`` spans — and the header its
``ring_rtt`` span — to the request that caused them.  Worker spans flow
back to the header on the existing ``statsreq`` control path
(``runtime/distributed.py``), and the merged set exports as Chrome
trace-event JSON (``to_chrome_trace``) loadable in Perfetto /
``chrome://tracing``.

Timestamps are epoch microseconds (``time.time()``); durations come from
``perf_counter`` deltas.  Within one host the span chain for a token step
nests exactly; across hosts it is as aligned as the hosts' clocks — good
enough for "which hop ate the time", which is the question this exists to
answer.

The two clocks are never mixed: :class:`SpanClock` captures the
wall-clock start ONCE at span open and measures the duration on
``perf_counter``, so a span's start cannot drift when NTP steps the wall
clock mid-span (reconstructing start as ``time.time() - dur`` at close
would move it by exactly the step).

A copy of ``distributed_inference_demo_tpu/telemetry/tracing.py``: the
port keeps its own, so a process that imports both packages holds two
independent instances.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

_MAX_SPANS = 8192          # bounded: long runs keep O(1) memory

# Trace/span ids must stay unique across processes that FORKED from one
# parent: the module-level ``random`` generator's state is copied by
# fork, so two replicas forked after import would mint the *same* id
# sequence and their traces would merge into one request at the gateway.
# ``SystemRandom`` reads the kernel CSPRNG per call — no Python-level
# state to inherit.
_SYS_RANDOM = random.SystemRandom()


def new_trace_id() -> int:
    """Random nonzero 64-bit trace id (collision odds are irrelevant at
    any realistic request volume).  Drawn from ``os.urandom`` via
    ``SystemRandom`` so ids stay distinct across forked replicas."""
    return _SYS_RANDOM.getrandbits(64) | 1


class SpanClock:
    """Span timing with the clocks kept apart: ``ts`` is the wall-clock
    start captured once at construction (span open); ``seconds`` is the
    elapsed ``perf_counter`` duration, frozen on first read or on context
    exit.  The one timing helper for instrumented spans
    (``with SpanClock() as t: ...`` then ``t.ts`` / ``t.seconds``)."""

    __slots__ = ("ts", "_t0", "_dur")

    def __init__(self):
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self._dur: Optional[float] = None

    def stop(self) -> float:
        if self._dur is None:
            self._dur = time.perf_counter() - self._t0
        return self._dur

    @property
    def seconds(self) -> float:
        return self.stop()

    def __enter__(self) -> "SpanClock":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


class TraceRecorder:
    """Bounded per-process span sink.

    ``record()`` returns the new span's id so the caller can thread it as
    the parent of downstream spans (the wire trailer's second field).
    ``drain()`` pops everything recorded so far — the statsrep /
    export path — so each span is exported exactly once.
    """

    def __init__(self, proc: str, max_spans: int = _MAX_SPANS):
        self.proc = proc
        self._spans: "deque[dict]" = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        # span ids: process-unique base + counter, so two stages' ids
        # cannot collide when merged at the header.  SystemRandom for the
        # same reason as new_trace_id(): a fork must not clone the base.
        self._base = (_SYS_RANDOM.getrandbits(32) << 24) ^ (os.getpid() << 8)
        self._seq = itertools.count(1)

    def next_span_id(self) -> int:
        return (self._base + next(self._seq)) & ((1 << 63) - 1)

    def record(self, name: str, trace_id: int, parent_id: int = 0,
               ts: Optional[float] = None, dur: float = 0.0,
               span_id: Optional[int] = None,
               clock: Optional[SpanClock] = None, **args) -> int:
        """Record a completed span.  Preferred timing source is a
        :class:`SpanClock` opened at span start (``clock=``); explicit
        ``ts`` (epoch-seconds start) + ``dur`` (seconds) also work.  With
        neither, ``ts`` defaults to the call time — NOT ``now - dur``,
        which would reconstruct the start by mixing the wall clock with a
        perf_counter duration and drift whenever NTP steps the clock."""
        sid = span_id if span_id is not None else self.next_span_id()
        if clock is not None:
            ts, dur = clock.ts, clock.seconds
        if ts is None:
            ts = time.time()
        span = {"name": name, "proc": self.proc,
                "trace_id": int(trace_id), "span_id": int(sid),
                "parent_id": int(parent_id),
                "ts_us": int(ts * 1e6),
                "dur_us": max(0, int(dur * 1e6))}
        if args:
            span["args"] = {k: v for k, v in args.items() if v is not None}
        with self._lock:
            self._spans.append(span)
        return sid

    def drain(self) -> List[dict]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def to_chrome_trace(spans: Iterable[dict]) -> dict:
    """Merge span dicts (from any number of TraceRecorders / statsrep
    payloads) into a Chrome trace-event JSON object.

    Layout choices for Perfetto readability: one "process" row per stage
    (``proc``), one "thread" lane per trace id within it — so a request's
    hops line up vertically and concurrent requests stack as lanes.
    """
    spans = list(spans)
    pids: Dict[str, int] = {}
    tids: Dict[int, int] = {}
    events: List[dict] = []
    for s in spans:
        proc = s.get("proc", "?")
        if proc not in pids:
            pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
        trace_id = int(s.get("trace_id", 0))
        if trace_id not in tids:
            tids[trace_id] = len(tids) + 1
        args = dict(s.get("args") or {})
        args["trace_id"] = f"{trace_id:016x}"
        if s.get("parent_id"):
            args["parent_span_id"] = f"{int(s['parent_id']):016x}"
        args["span_id"] = f"{int(s.get('span_id', 0)):016x}"
        events.append({
            "ph": "X", "name": s.get("name", "?"),
            "cat": "ring", "pid": pids[proc], "tid": tids[trace_id],
            "ts": int(s.get("ts_us", 0)), "dur": int(s.get("dur_us", 0)),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_chrome_traces(traces: Iterable[dict]) -> dict:
    """Merge already-exported Chrome trace objects (``{"traceEvents":
    [...]}``) into one.

    Each input was built by :func:`to_chrome_trace` in a *different*
    process (replica ``/trace`` exports plus the gateway's own), so their
    small-integer pids collide.  Pids are renumbered per input object;
    ``process_name`` metadata rows are deduplicated by name so the merged
    view shows one row per distinct proc, and duration events whose proc
    already has a row reuse it — a request's gateway-proxy, engine, and
    migration spans land in one file, joined by the ``trace_id`` arg the
    per-span export already carries.
    """
    name_pids: Dict[str, int] = {}
    events: List[dict] = []
    next_pid = 1
    for trace in traces:
        remap: Dict[int, int] = {}
        pending: List[dict] = []   # events seen before their meta row
        for ev in (trace or {}).get("traceEvents", []):
            pid = int(ev.get("pid", 0))
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                proc = str((ev.get("args") or {}).get("name", "?"))
                if proc in name_pids:
                    remap[pid] = name_pids[proc]
                else:
                    name_pids[proc] = remap[pid] = next_pid
                    next_pid += 1
                    events.append(dict(ev, pid=remap[pid]))
                continue
            pending.append(ev)
        for ev in pending:
            pid = int(ev.get("pid", 0))
            if pid not in remap:
                remap[pid] = next_pid
                next_pid += 1
            events.append(dict(ev, pid=remap[pid]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[dict]) -> None:
    """Export spans to ``path`` as Chrome trace JSON (open in Perfetto:
    ui.perfetto.dev → "Open trace file")."""
    import json
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans), f)
