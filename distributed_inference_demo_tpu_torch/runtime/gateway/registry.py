"""Replica registry: health-checked membership for the serving gateway.

One :class:`ReplicaRegistry` owns the gateway's view of the replica
fleet (docs/DESIGN.md §16).  Each replica is an independent engine
process speaking the ``runtime/http_server.py`` surface; the registry
probes its ``/stats`` endpoint (queue depth + kvcache occupancy ride
along free) and debounces membership the same way the anomaly detector
debounces breaches (telemetry/anomaly.py):

- **eviction**: ``sustain`` CONSECUTIVE probe (or proxy) failures evict
  a replica from routing — one dropped connection is a blip, a streak
  is an outage.  Eviction bumps ``dwt_gateway_replica_down_total`` and
  the flight recorder.
- **readmission**: a probe success readmits an evicted replica only
  after ``readmit_cooldown_s`` has elapsed since eviction — a flapping
  process must prove a quiet period, not a single lucky accept.  The
  readmission hook lets the router drop its routing-history index for
  the replica when the replica's own cache came back empty.

Failures come from two doors with ONE streak: the background prober and
``record_failure`` calls from the proxy path (a replica that hangs up
mid-handshake is evidence exactly like a failed probe).  The clock and
the prober are injectable so the debounce is testable without sockets
or sleeps.

Orthogonal to health is **draining** (docs/DESIGN.md §18): an operator
(or the migration controller) marks a replica draining and it leaves
:meth:`ReplicaRegistry.routable_replicas` — no NEW request routes to it
— without burning an eviction strike or touching its in-flight streams.
Surfaced on ``/debugz`` and the ``dwt_gateway_draining_replicas``
gauge.
"""

from __future__ import annotations

import json
import threading
import time
from http.client import HTTPConnection
from typing import Callable, Dict, List, Optional

from ...telemetry import catalog as _catalog
from ...telemetry.flightrecorder import get_flight_recorder

#: bounded failure-reason vocabulary for
#: ``dwt_gateway_replica_failures_total{reason=...}`` — free-text
#: reasons (exception strings) collapse onto these so the label set
#: cannot grow with error-message cardinality
FAILURE_REASONS = ("probe", "proxy", "mid-stream", "resume", "other")


def classify_failure_reason(reason: str) -> str:
    """Collapse a free-text failure reason onto the bounded vocabulary:
    the prober passes ``probe: ...``, the resume loop ``resume``/
    ``resume: ...``, the mid-stream seam ``mid-stream``; any other
    non-empty text is a pre-first-token proxy failure."""
    r = (reason or "").lower()
    if r.startswith("probe"):
        return "probe"
    if "mid-stream" in r:
        return "mid-stream"
    if r.startswith("resume"):
        return "resume"
    if r:
        return "proxy"
    return "other"


def http_stats_prober(timeout_s: float = 2.0):
    """Default prober: ``GET /stats`` on the replica, parsed JSON.
    Raises on any transport error or non-200 — the registry counts the
    raise, not the reason (a refused connect and a wedged accept loop
    are the same outage to a router)."""

    def probe(host: str, port: int) -> dict:
        conn = HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("GET", "/stats")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"/stats returned {resp.status}")
            return json.loads(body)
        finally:
            conn.close()

    return probe


class Replica:
    """One replica's registry row (mutated only under the registry
    lock)."""

    __slots__ = ("rid", "host", "port", "up", "draining", "fail_streak",
                 "down_at", "last_stats", "probes", "failures")

    def __init__(self, rid: str, host: str, port: int):
        self.rid = rid
        self.host = host
        self.port = int(port)
        self.up = True
        self.draining = False
        self.fail_streak = 0
        self.down_at: Optional[float] = None
        self.last_stats: dict = {}
        self.probes = 0
        self.failures = 0

    @property
    def queue_depth(self) -> int:
        return int(self.last_stats.get("queue_depth", 0))

    @property
    def pending_prefill_tokens(self) -> int:
        return int(self.last_stats.get("pending_prefill_tokens", 0))

    @property
    def spec_backlog_tokens(self) -> int:
        """Per-iteration speculative token cost of the replica's active
        rows — Σ (K_row + 1) · decode_block (docs/DESIGN.md §22); 0 on
        replicas with no speculative proposer armed."""
        return int(self.last_stats.get("spec_backlog_tokens", 0))

    @property
    def kv_tier(self) -> dict:
        """The replica's last-reported §21 tier fragment (empty dict
        when the replica runs no host tier) — occupancy for /debugz,
        demoted-prefix digest for the router's second chance."""
        kv = self.last_stats.get("kvcache") or {}
        return kv.get("tier") or {}


class ReplicaRegistry:
    """Debounced replica membership (see module docstring)."""

    def __init__(self, replicas: List[tuple], *, sustain: int = 3,
                 readmit_cooldown_s: float = 5.0,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 prober: Optional[Callable[[str, int], dict]] = None):
        """``replicas``: ``[(host, port), ...]``.  ``prober(host, port)``
        returns the replica's ``/stats`` dict or raises; ``clock`` is
        monotonic seconds.  Both default to the real thing and are
        injectable for deterministic tests."""
        if not replicas:
            raise ValueError("gateway needs at least one replica")
        if sustain < 1:
            raise ValueError("sustain must be >= 1")
        self.sustain = sustain
        self.readmit_cooldown_s = readmit_cooldown_s
        self.probe_interval_s = probe_interval_s
        self._clock = clock
        self._prober = prober or http_stats_prober(probe_timeout_s)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        for host, port in replicas:
            rid = f"{host}:{port}"
            self._replicas[rid] = Replica(rid, host, port)
        # called under no lock after a replica is readmitted — the
        # router hooks this to reconcile/flush its prefix index
        self.on_readmit: Optional[Callable[[str], None]] = None
        # called under no lock after each successful probe with
        # (rid, stats) — the router hooks this for load + kvcache
        # reconciliation
        self.on_stats: Optional[Callable[[str, dict], None]] = None
        # registry-wide failure counts by bounded reason (satellite of
        # docs/DESIGN.md §23): the /debugz twin of
        # dwt_gateway_replica_failures_total
        self.failure_reasons: Dict[str, int] = {
            k: 0 for k in FAILURE_REASONS}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        _catalog.GATEWAY_UP_REPLICAS.set(len(self._replicas))

    # -- membership views --------------------------------------------------

    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def up_replicas(self) -> List[str]:
        with self._lock:
            return [r.rid for r in self._replicas.values() if r.up]

    def routable_replicas(self) -> List[str]:
        """Replicas NEW requests may be routed to: up and not draining.
        Health (``up``) and drain intent are orthogonal — a draining
        replica still probes, still proxies its in-flight streams, and
        still accepts migration traffic; it just stops attracting new
        work."""
        with self._lock:
            return [r.rid for r in self._replicas.values()
                    if r.up and not r.draining]

    def is_up(self, rid: str) -> bool:
        with self._lock:
            r = self._replicas.get(rid)
            return bool(r and r.up)

    def is_draining(self, rid: str) -> bool:
        with self._lock:
            r = self._replicas.get(rid)
            return bool(r and r.draining)

    def set_draining(self, rid: str, flag: bool = True) -> None:
        """Mark/unmark ``rid`` as draining.  NOT a failure strike: the
        replica keeps its health state, keeps probing, and keeps
        serving in-flight requests — it only leaves
        :meth:`routable_replicas` so no NEW request lands on it."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None or r.draining == flag:
                return
            r.draining = flag
            n_draining = sum(
                1 for x in self._replicas.values() if x.draining)
        _catalog.GATEWAY_DRAINING.set(n_draining)
        get_flight_recorder().record(
            "gateway_replica_draining" if flag
            else "gateway_replica_undrained", replica=rid)

    def get(self, rid: str) -> Replica:
        with self._lock:
            return self._replicas[rid]

    def endpoint(self, rid: str) -> tuple:
        with self._lock:
            r = self._replicas[rid]
            return r.host, r.port

    def queue_depth(self, rid: str) -> int:
        with self._lock:
            return self._replicas[rid].queue_depth

    def pending_prefill_tokens(self, rid: str) -> int:
        with self._lock:
            r = self._replicas.get(rid)
            return r.pending_prefill_tokens if r is not None else 0

    def spec_backlog_tokens(self, rid: str) -> int:
        with self._lock:
            r = self._replicas.get(rid)
            return r.spec_backlog_tokens if r is not None else 0

    # -- the debounce ------------------------------------------------------

    def record_failure(self, rid: str, reason: str = "") -> None:
        """One failure strike (probe or proxy).  At ``sustain``
        consecutive strikes an up replica is evicted."""
        evicted = False
        label = classify_failure_reason(reason)
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.failures += 1
            r.fail_streak += 1
            self.failure_reasons[label] += 1
            if r.up and r.fail_streak >= self.sustain:
                r.up = False
                r.down_at = self._clock()
                evicted = True
                n_up = sum(1 for x in self._replicas.values() if x.up)
        _catalog.GATEWAY_REPLICA_FAILURES.inc(reason=label)
        if evicted:
            _catalog.GATEWAY_REPLICA_DOWN.inc()
            _catalog.GATEWAY_UP_REPLICAS.set(n_up)
            get_flight_recorder().record(
                "gateway_replica_down", replica=rid,
                reason=reason or "failure streak")

    def record_success(self, rid: str, stats: Optional[dict] = None) -> None:
        """A successful probe: clears the streak; readmits a down
        replica once the cooldown has elapsed."""
        readmitted = False
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.fail_streak = 0
            if stats is not None:
                r.last_stats = stats
            if (not r.up and r.down_at is not None
                    and self._clock() - r.down_at
                    >= self.readmit_cooldown_s):
                r.up = True
                r.down_at = None
                readmitted = True
            n_up = sum(1 for x in self._replicas.values() if x.up)
        if readmitted:
            _catalog.GATEWAY_REPLICA_UP.inc()
            _catalog.GATEWAY_UP_REPLICAS.set(n_up)
            get_flight_recorder().record("gateway_replica_up", replica=rid)
            if self.on_readmit is not None:
                self.on_readmit(rid)
        if stats is not None:
            _catalog.GATEWAY_QUEUE_DEPTH.set(
                int(stats.get("queue_depth", 0)), replica=rid)
            if self.on_stats is not None:
                self.on_stats(rid, stats)

    def retry_after_hint(self, default_s: float = 2.0,
                         floor_s: float = 1.0) -> float:
        """How long a shed client should back off: the smallest
        readmit-cooldown remainder over the DOWN replicas (floored at
        ``floor_s`` — a sub-second hint rounds to an instant hammer),
        or ``default_s`` when nothing is down (the shed was load, not
        membership, and no cooldown clock says otherwise)."""
        now = self._clock()
        with self._lock:
            remains = [
                max(0.0, self.readmit_cooldown_s - (now - r.down_at))
                for r in self._replicas.values()
                if not r.up and r.down_at is not None]
        if not remains:
            return default_s
        return max(floor_s, min(remains))

    def probe_all(self) -> None:
        """One probe round over every replica (up AND down — a down
        replica's successful probes are what readmit it)."""
        for rid in self.replica_ids():
            with self._lock:
                r = self._replicas.get(rid)
                if r is None:
                    continue
                host, port = r.host, r.port
                r.probes += 1
            try:
                stats = self._prober(host, port)
            except Exception as e:
                self.record_failure(rid, reason=f"probe: {e}")
            else:
                self.record_success(rid, stats)

    # -- background prober -------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._probe_loop,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_all()
            self._stop.wait(self.probe_interval_s)

    # -- introspection -----------------------------------------------------

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "sustain": self.sustain,
                "readmit_cooldown_s": self.readmit_cooldown_s,
                "failure_reasons": dict(self.failure_reasons),
                "replicas": {
                    r.rid: {"up": r.up, "draining": r.draining,
                            "fail_streak": r.fail_streak,
                            "probes": r.probes, "failures": r.failures,
                            "queue_depth": r.queue_depth,
                            "down_for_s": (round(self._clock() - r.down_at, 3)
                                           if r.down_at is not None else None),
                            # §21 tier occupancy (bounded: counts and
                            # bytes, never the digest list itself)
                            "kv_tier": ({k: r.kv_tier.get(k, 0)
                                         for k in ("host_blocks",
                                                   "host_resident_bytes",
                                                   "disk_blocks",
                                                   "disk_resident_bytes")}
                                        if r.kv_tier else None)}
                    for r in self._replicas.values()},
            }
