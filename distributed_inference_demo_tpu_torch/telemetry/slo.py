"""Per-request timeline ledger + per-tenant SLO/goodput accounting.

The batching scheduler (docs/DESIGN.md §10) already measures TTFT /
per-token / e2e latency as anonymous reservoirs; this module is the
*attributed* layer on top: every request carries a ``tenant`` identity
(``/generate`` body field or ``X-DWT-Tenant`` header, forwarded by the
gateway and preserved across the §18 migration export/import seam) and
closes into one **timeline record** decomposing where its milliseconds
went:

    queue_wait  — admission to first scheduler pickup
    prefill     — pickup to first emitted token (chunked prefill time)
    ttft        — admission to first token (= queue_wait + prefill)
    per_token   — steady-state decode seconds/token, pauses excluded
    migration_pause — freeze→first-relayed-token gap, live migrations
    resume_pause — replay window on a survivor after gateway failover
                   (docs/DESIGN.md §23), recorded like migration_pause
    e2e         — admission to final token

By construction ``ttft + per_token*(tokens-1) + migration_pause +
resume_pause == e2e`` for every closed record, so the decomposition
always sums — a timeline that doesn't add up is a measurement bug, not
a rounding artifact.

Each close rolls into per-tenant labeled Prometheus series
(``dwt_slo_*``): latency histograms, goodput counters (tokens served
within the configured TTFT/TPOT SLO vs total — a request's first token
is judged against ``DWT_SLO_TTFT_MS``, its decode tokens against
``DWT_SLO_TPOT_MS``; with a threshold unset/0 that phase always counts
as good), and multi-window **burn-rate** gauges: the fraction of
SLO-violating tokens over a trailing window divided by the error budget
``1 - DWT_SLO_TARGET``.  Burn rate 1.0 means the tenant is consuming
its budget exactly at the sustainable pace; the classic multiwindow
alert (short AND long window both high) is what the anomaly layer's
``slo_burn`` detector consumes via the scheduler ``stats()`` surface.

Process-default accessor mirrors the flight recorder: one ledger per
process (``get_slo_ledger()``), recent timelines queryable at
``GET /timeline`` and dumped into postmortem bundles as
``timelines.jsonl``.  Recording is a dict build + locked deque append;
memory is O(recent + windows) forever.

A copy of ``distributed_inference_demo_tpu/telemetry/slo.py``: the port
keeps its own, so a process that imports both packages holds two
independent instances.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import counter, gauge, histogram

# ---------------------------------------------------------------------------
# series (registered once at import; the catalog imports this module so
# the standard-set lint sees them)

_TTFT_BUCKETS_S = (0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 15.0, 60.0)
_TOKEN_BUCKETS_S = (0.0005, 0.001, 0.002, 0.004, 0.008, 0.016, 0.032,
                    0.064, 0.25, 1.0)

SLO_TTFT = histogram(
    "dwt_slo_ttft_seconds",
    "Per-tenant time to first token (admission to first emitted token)",
    labels=("tenant",), buckets=_TTFT_BUCKETS_S)
SLO_QUEUE_WAIT = histogram(
    "dwt_slo_queue_wait_seconds",
    "Per-tenant admission-to-scheduler-pickup wait",
    labels=("tenant",), buckets=_TTFT_BUCKETS_S)
SLO_PER_TOKEN = histogram(
    "dwt_slo_per_token_seconds",
    "Per-tenant steady-state decode seconds per token "
    "(migration pause excluded)",
    labels=("tenant",), buckets=_TOKEN_BUCKETS_S)
SLO_E2E = histogram(
    "dwt_slo_e2e_seconds",
    "Per-tenant end-to-end request latency (admission to final token)",
    labels=("tenant",), buckets=_TTFT_BUCKETS_S)
SLO_MIGRATION_PAUSE = histogram(
    "dwt_slo_migration_pause_seconds",
    "Per-tenant live-migration pause (freeze to first relayed token), "
    "observed only for migrated requests",
    labels=("tenant",), buckets=_TTFT_BUCKETS_S)
SLO_REQUESTS = counter(
    "dwt_slo_requests_total",
    "Per-tenant closed request timelines", labels=("tenant",))
SLO_FAILED_REQUESTS = counter(
    "dwt_slo_failed_requests_total",
    "Per-tenant requests closed with an error (their tokens all count "
    "against the SLO budget)", labels=("tenant",))
SLO_TOKENS = counter(
    "dwt_slo_tokens_total",
    "Per-tenant tokens emitted by closed requests", labels=("tenant",))
SLO_GOOD_TOKENS = counter(
    "dwt_slo_good_tokens_total",
    "Per-tenant tokens served within the configured TTFT/TPOT SLO "
    "(goodput numerator; equals dwt_slo_tokens_total when no SLO is set)",
    labels=("tenant",))
SLO_GOOD_TTFT_REQUESTS = counter(
    "dwt_slo_good_ttft_requests_total",
    "Per-tenant requests whose first token met the TTFT SLO",
    labels=("tenant",))
SLO_MIGRATED_REQUESTS = counter(
    "dwt_slo_migrated_requests_total",
    "Per-tenant closed requests that were live-migrated at least once",
    labels=("tenant",))
SLO_RESUME_PAUSE = histogram(
    "dwt_slo_resume_pause_seconds",
    "Per-tenant gateway-failover resume pause (replay window on the "
    "survivor: first replayed token to first visible token, docs/"
    "DESIGN.md §23), observed only for resumed requests",
    labels=("tenant",), buckets=_TTFT_BUCKETS_S)
SLO_RESUMED_REQUESTS = counter(
    "dwt_slo_resumed_requests_total",
    "Per-tenant closed requests admitted through the gateway-failover "
    "resume path (delivered prefix re-derived on a survivor replica)",
    labels=("tenant",))
SLO_BURN_RATE = gauge(
    "dwt_slo_burn_rate_ratio",
    "Per-tenant SLO burn rate over a trailing window: fraction of "
    "SLO-violating tokens divided by the error budget (1 - target); "
    "1.0 = burning exactly at the sustainable pace",
    labels=("tenant", "window"))

# ---------------------------------------------------------------------------

DEFAULT_TENANT = "default"
_TENANT_RE = re.compile(r"[^A-Za-z0-9._:@/-]")
_MAX_TENANT_LEN = 64

#: trailing windows for burn-rate gauges: (seconds, label)
BURN_WINDOWS = ((300.0, "5m"), (3600.0, "1h"))


def sanitize_tenant(raw) -> str:
    """Clamp an untrusted tenant identity (HTTP header / JSON body) to a
    safe metric label value: bounded length, conservative charset,
    never empty.  Unknown/absent identities collapse to ``default`` so
    the per-tenant series always partition the full traffic."""
    if raw is None:
        return DEFAULT_TENANT
    s = _TENANT_RE.sub("_", str(raw).strip())[:_MAX_TENANT_LEN]
    return s or DEFAULT_TENANT


def _env_ms(name: str) -> float:
    try:
        return float(os.environ.get(name, "0") or 0)
    except ValueError:
        return 0.0


class SloLedger:
    """Bounded per-process ledger of closed request timelines with
    per-tenant SLO accounting.

    ``close_request()`` is the single write path — the scheduler calls
    it when a request completes locally, and the migration relay calls
    it on the *source* replica for migrated-out requests (the source
    keeps the client connection, so its view is the user-visible one;
    the adopting replica deliberately does not double-close).
    """

    def __init__(self, *, ttft_slo_ms: Optional[float] = None,
                 tpot_slo_ms: Optional[float] = None,
                 target: Optional[float] = None,
                 max_recent: int = 256,
                 clock=time.time):
        self.ttft_slo_ms = (_env_ms("DWT_SLO_TTFT_MS")
                            if ttft_slo_ms is None else float(ttft_slo_ms))
        self.tpot_slo_ms = (_env_ms("DWT_SLO_TPOT_MS")
                            if tpot_slo_ms is None else float(tpot_slo_ms))
        if target is None:
            try:
                target = float(os.environ.get("DWT_SLO_TARGET", "0.99"))
            except ValueError:
                target = 0.99
        # clamp: target outside (0, 1) would make the error budget
        # non-positive and every burn rate infinite/negative
        self.target = min(max(float(target), 0.0), 0.9999)
        self._budget = max(1.0 - self.target, 1e-4)
        self._clock = clock
        self._lock = threading.Lock()
        self._recent: "deque[dict]" = deque(maxlen=max_recent)
        # per-tenant trailing (ts, tokens, bad_tokens) events for the
        # burn windows; pruned past the longest window on every touch
        self._events: Dict[str, "deque"] = {}
        self._totals: Dict[str, Dict[str, float]] = {}

    # -- write path --------------------------------------------------------

    def close_request(self, *, rid: str, tenant: str = DEFAULT_TENANT,
                      trace_id: int = 0, t_submit_wall: float = 0.0,
                      queue_wait_s: float = 0.0, ttft_s: float = 0.0,
                      e2e_s: float = 0.0, tokens: int = 0,
                      migration_pause_s: float = 0.0,
                      migrated: bool = False,
                      resume_pause_s: float = 0.0,
                      resumed: bool = False, replica: str = "",
                      error: Optional[str] = None) -> dict:
        """Close one request into a timeline record and roll it into the
        per-tenant series.  Returns the record (also kept in the recent
        ring for ``/timeline`` and postmortem bundles)."""
        tenant = sanitize_tenant(tenant)
        tokens = max(0, int(tokens))
        queue_wait_s = max(0.0, float(queue_wait_s))
        ttft_s = max(queue_wait_s, float(ttft_s))
        migration_pause_s = max(0.0, float(migration_pause_s))
        resume_pause_s = max(0.0, float(resume_pause_s))
        pause_s = migration_pause_s + resume_pause_s
        e2e_s = max(ttft_s + pause_s, float(e2e_s))
        decode_s = e2e_s - ttft_s
        # max(0): float dust when decode == pause exactly must not
        # produce a negative per-token latency
        per_token_s = (max(0.0, decode_s - pause_s)
                       / (tokens - 1) if tokens > 1 else 0.0)
        prefill_s = ttft_s - queue_wait_s

        ttft_ok = (error is None and tokens > 0
                   and (self.ttft_slo_ms <= 0
                        or ttft_s * 1e3 <= self.ttft_slo_ms))
        tpot_ok = (error is None
                   and (self.tpot_slo_ms <= 0
                        or per_token_s * 1e3 <= self.tpot_slo_ms))
        good = ((1 if ttft_ok else 0)
                + (tokens - 1 if tokens > 1 and tpot_ok else 0))
        bad = tokens - good

        rec = {
            "ts": self._clock(), "rid": str(rid), "tenant": tenant,
            "trace_id": f"{int(trace_id):016x}" if trace_id else "",
            "t_submit_wall": float(t_submit_wall),
            "queue_wait_s": queue_wait_s, "prefill_s": prefill_s,
            "ttft_s": ttft_s, "per_token_s": per_token_s,
            "decode_s": decode_s,
            "migration_pause_s": migration_pause_s,
            "resume_pause_s": resume_pause_s,
            "e2e_s": e2e_s, "tokens": tokens,
            "good_tokens": good, "migrated": bool(migrated),
            "resumed": bool(resumed),
            "replica": str(replica),
        }
        if error is not None:
            rec["error"] = str(error)

        SLO_REQUESTS.inc(tenant=tenant)
        if error is not None:
            SLO_FAILED_REQUESTS.inc(tenant=tenant)
        if migrated:
            SLO_MIGRATED_REQUESTS.inc(tenant=tenant)
        if tokens > 0:
            SLO_TOKENS.inc(tokens, tenant=tenant)
            if good:
                SLO_GOOD_TOKENS.inc(good, tenant=tenant)
            SLO_QUEUE_WAIT.observe(queue_wait_s, tenant=tenant)
            SLO_TTFT.observe(ttft_s, tenant=tenant)
            SLO_E2E.observe(e2e_s, tenant=tenant)
            if tokens > 1:
                SLO_PER_TOKEN.observe(per_token_s, tenant=tenant)
        if ttft_ok:
            SLO_GOOD_TTFT_REQUESTS.inc(tenant=tenant)
        if migrated:
            SLO_MIGRATION_PAUSE.observe(migration_pause_s, tenant=tenant)
        if resumed:
            SLO_RESUMED_REQUESTS.inc(tenant=tenant)
            SLO_RESUME_PAUSE.observe(resume_pause_s, tenant=tenant)

        with self._lock:
            self._recent.append(rec)
            ev = self._events.setdefault(tenant, deque())
            ev.append((rec["ts"], tokens, bad))
            tot = self._totals.setdefault(
                tenant, {"requests": 0, "tokens": 0, "good_tokens": 0,
                         "failed": 0, "migrated": 0, "resumed": 0})
            tot["requests"] += 1
            tot["tokens"] += tokens
            tot["good_tokens"] += good
            tot["failed"] += 1 if error is not None else 0
            tot["migrated"] += 1 if migrated else 0
            tot["resumed"] += 1 if resumed else 0
            burn = self._burn_locked(tenant)
        for label, rate in burn.items():
            SLO_BURN_RATE.set(rate, tenant=tenant, window=label)
        return rec

    # -- burn windows ------------------------------------------------------

    def _burn_locked(self, tenant: str) -> Dict[str, float]:
        now = self._clock()
        ev = self._events.get(tenant)
        if ev is None:
            return {label: 0.0 for _, label in BURN_WINDOWS}
        horizon = now - max(w for w, _ in BURN_WINDOWS)
        while ev and ev[0][0] < horizon:
            ev.popleft()
        out = {}
        for win_s, label in BURN_WINDOWS:
            cut = now - win_s
            total = bad = 0
            for ts, tok, b in ev:
                if ts >= cut:
                    total += tok
                    bad += b
            frac = (bad / total) if total else 0.0
            out[label] = frac / self._budget
        return out

    def burn_rates(self, tenant: str) -> Dict[str, float]:
        with self._lock:
            return self._burn_locked(sanitize_tenant(tenant))

    # -- read paths --------------------------------------------------------

    def recent(self, n: int = 64) -> List[dict]:
        """Most recent ``n`` closed timelines, oldest first."""
        with self._lock:
            items = list(self._recent)
        return items[-max(0, int(n)):]

    def summary(self) -> dict:
        """Per-tenant rollup for ``/stats``, ``/debugz``, and the
        anomaly layer: lifetime counts, goodput ratio, burn rates."""
        with self._lock:
            tenants = {}
            for tenant, tot in self._totals.items():
                toks = tot["tokens"]
                tenants[tenant] = {
                    "requests": tot["requests"],
                    "failed": tot["failed"],
                    "migrated": tot["migrated"],
                    "resumed": tot.get("resumed", 0),
                    "tokens": toks,
                    "good_tokens": tot["good_tokens"],
                    "goodput_ratio": (tot["good_tokens"] / toks
                                      if toks else 1.0),
                    "burn": self._burn_locked(tenant),
                }
        return {
            "slo": {"ttft_ms": self.ttft_slo_ms,
                    "tpot_ms": self.tpot_slo_ms,
                    "target": self.target},
            "tenants": tenants,
        }

    def refresh_series(self) -> None:
        """Re-set the burn-rate gauges from the current clock (a scrape
        between closes must see windows decay, not the last close's
        value frozen)."""
        with self._lock:
            burns = {t: self._burn_locked(t) for t in self._events}
        for tenant, by_win in burns.items():
            for label, rate in by_win.items():
                SLO_BURN_RATE.set(rate, tenant=tenant, window=label)

    def debug_state(self, tail: int = 32) -> dict:
        out = self.summary()
        out["recent"] = self.recent(tail)
        return out


# ---------------------------------------------------------------------------
# process-default ledger (flight-recorder pattern)

_DEFAULT: Optional[SloLedger] = None
_DEFAULT_LOCK = threading.Lock()


def get_slo_ledger() -> SloLedger:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = SloLedger()
    return _DEFAULT


def set_slo_ledger(ledger: Optional[SloLedger]) -> None:
    """Install (or with ``None``, reset) the process-default ledger —
    tests use this to control thresholds and clocks."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = ledger


def update_slo_series() -> None:
    """Scrape-time bridge (called from ``catalog.scrape``): refresh the
    burn-rate gauges so windows decay between request closes."""
    if _DEFAULT is not None:
        _DEFAULT.refresh_series()


def debug_state(tail: int = 32) -> dict:
    return get_slo_ledger().debug_state(tail)


def timelines_jsonl(tail: int = 256) -> List[str]:
    """Recent timelines as JSONL lines (postmortem ``timelines.jsonl``)."""
    import json
    out = []
    for rec in get_slo_ledger().recent(tail):
        try:
            out.append(json.dumps(rec, default=str))
        except (TypeError, ValueError):
            continue
    return out


def isfinite(v) -> bool:
    """Shared ``is this metric sample usable`` predicate: real number,
    not NaN/inf — the anomaly layer uses it so a NaN reservoir (empty
    stats window) can neither fire nor mask a breach."""
    return isinstance(v, (int, float)) and math.isfinite(v)
