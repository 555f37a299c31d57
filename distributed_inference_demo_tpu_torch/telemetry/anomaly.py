"""Online anomaly detection over the existing stats surfaces.

The raw signals are pollable (``StageStats`` snapshots, the batching
scheduler's counters, the ``dwt_*`` series); this module watches them
*continuously* and names the moment something leaves its envelope:

- **straggler_hop** — one pipeline stage's compute p95 sits far above
  the ring median (a slow host / thermal-throttled chip / dying link);
- **slo_ttft / slo_tpot** — the batching engine's time-to-first-token or
  per-output-token p95 breaches a configured SLO;
- **slo_burn** — a tenant's error-budget burn rate (from the SLO
  ledger, ``telemetry/slo.py``) exceeds ``DWT_ANOMALY_BURN_RATE`` on
  every window at once (fast 5m AND slow 1h — multiwindow alerting);
- **queue_saturation** — admitted-but-unslotted requests pile up past a
  threshold (the system is falling behind offered load);
- **accept_collapse** — the speculative accept rate collapses (the draft
  stopped predicting the target; every round is wasted work);
- **recompile_storm** — a tracked jitted program compiled past its
  documented variant budget (``stats()["compile"]`` fragment from
  ``telemetry/profiling.py``; e.g. ``_mixed_step``'s two-variant
  invariant) — a silent recompile latency cliff becomes a named event;
- **pipeline_stall** — work is in flight but the step counter has not
  advanced for longer than the watchdog window (the explicit
  TransportTimeout path in ``runtime/distributed.py`` covers the ring;
  this covers the single-process slot scheduler).

Detection is intentionally boring: fixed thresholds from env knobs, a
``sustain`` count so one noisy sample can't fire, and a per-kind
``cooldown`` so a persistent condition produces ONE postmortem bundle,
not a bundle storm.  Every threshold is overridable per deployment
(``DWT_ANOMALY_*`` / ``DWT_SLO_*``, docs/DESIGN.md §8); every detector
takes its clock from the constructor so tests drive scenarios with a
fake clock deterministically.

:class:`AnomalyMonitor` couples a detector to the flight recorder, the
``dwt_anomaly_*`` series, and the postmortem writer — the piece the
serving loops actually call.

A copy of ``distributed_inference_demo_tpu/telemetry/anomaly.py``: the
port keeps its own, so a process that imports both packages holds two
independent instances.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ._env import env_float as _env_float, env_int as _env_int


@dataclass(frozen=True)
class Thresholds:
    """Detector knobs; ``from_env`` reads the ``DWT_*`` overrides once at
    construction so a long-lived detector is immune to env churn."""

    straggler_factor: float = 3.0     # stage p95 vs ring median multiple
    straggler_min_ms: float = 1.0     # ignore sub-ms absolute noise
    ttft_slo_ms: float = 0.0          # 0 = SLO disabled
    tpot_slo_ms: float = 0.0          # 0 = SLO disabled
    queue_depth: int = 64             # waiting requests = saturation
    accept_floor: float = 0.1         # speculative acceptance collapse
    accept_min_drafted: int = 256     # ... after this many drafted tokens
    stall_s: float = 30.0             # watchdog: no progress with work
    burn_rate: float = 0.0            # 0 = SLO burn detector disabled
    recompile_slack: int = 0          # extra compiles tolerated past a
    # program's variant budget before recompile_storm (-1 disables)
    sustain: int = 3                  # consecutive breaches before firing
    cooldown_s: float = 300.0         # per-kind re-fire suppression

    @staticmethod
    def from_env() -> "Thresholds":
        return Thresholds(
            straggler_factor=_env_float("DWT_ANOMALY_STRAGGLER_FACTOR",
                                        3.0),
            straggler_min_ms=_env_float("DWT_ANOMALY_STRAGGLER_MIN_MS",
                                        1.0),
            ttft_slo_ms=_env_float("DWT_SLO_TTFT_MS", 0.0),
            tpot_slo_ms=_env_float("DWT_SLO_TPOT_MS", 0.0),
            queue_depth=_env_int("DWT_ANOMALY_QUEUE_DEPTH", 64),
            accept_floor=_env_float("DWT_ANOMALY_ACCEPT_FLOOR", 0.1),
            accept_min_drafted=_env_int(
                "DWT_ANOMALY_ACCEPT_MIN_DRAFTED", 256),
            stall_s=_env_float("DWT_ANOMALY_STALL_S", 30.0),
            burn_rate=_env_float("DWT_ANOMALY_BURN_RATE", 0.0),
            recompile_slack=_env_int("DWT_ANOMALY_RECOMPILE_SLACK", 0),
            sustain=_env_int("DWT_ANOMALY_SUSTAIN", 3),
            cooldown_s=_env_float("DWT_ANOMALY_COOLDOWN_S", 300.0),
        )


@dataclass
class Anomaly:
    kind: str
    severity: str                     # "warn" | "critical"
    ts: float
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "severity": self.severity,
                "ts": round(self.ts, 6), "detail": self.detail}


class AnomalyDetector:
    """Sliding-window detectors over stats dicts.

    ``observe(stats)`` accepts either shape the repo produces — a
    pipeline snapshot ``{"stages": [...]}`` (``HeaderBackend.stats``) or
    a batching-engine ``stats()`` dict — and returns the anomalies that
    *fired this observation* (sustain + cooldown already applied).
    """

    def __init__(self, thresholds: Optional[Thresholds] = None,
                 clock=time.time):
        self.thresholds = thresholds or Thresholds.from_env()
        self._clock = clock
        self._streak: Dict[str, int] = {}
        self._last_fire: Dict[str, float] = {}
        self._recent: "deque[Anomaly]" = deque(maxlen=64)
        # stall watchdog state: (last steps value, ts it last changed)
        self._steps_seen: Optional[int] = None
        self._steps_ts: float = 0.0

    # -- breach bookkeeping ------------------------------------------------

    def _breach(self, kind: str, severity: str, detail: dict,
                key: Optional[str] = None) -> Optional[Anomaly]:
        """One breached observation; fires after ``sustain`` consecutive
        breaches, then goes quiet for ``cooldown_s``.  ``key`` names the
        SUSTAIN identity when one kind has several independent sources
        (per-stage straggler streaks must not alias into one counter —
        two stages' single noisy samples would add up to a firing);
        cooldown stays per ``kind`` so simultaneous sources still
        produce one bundle, not one per source."""
        t = self.thresholds
        key = key or kind
        streak = self._streak.get(key, 0) + 1
        self._streak[key] = streak
        if streak < t.sustain:
            return None
        now = self._clock()
        if now - self._last_fire.get(kind, -1e18) < t.cooldown_s:
            return None
        self._last_fire[kind] = now
        a = Anomaly(kind=kind, severity=severity, ts=now, detail=detail)
        self._recent.append(a)
        return a

    def _clear(self, key: str) -> None:
        self._streak.pop(key, None)

    # -- detectors ---------------------------------------------------------

    def observe(self, stats: dict) -> List[Anomaly]:
        if not isinstance(stats, dict):
            return []
        stages = stats.get("stages")
        if isinstance(stages, list):
            return self.observe_stages(stages)
        return self.observe_batching(stats)

    def observe_stages(self, snapshots: List[dict]) -> List[Anomaly]:
        """Straggler detection over per-stage snapshots (one poll of
        ``collect_stats``): a stage whose compute p95 exceeds
        ``straggler_factor`` x the median of the OTHER stages is the slow
        hop.  Self-excluded baseline on purpose: with the ring median
        over ALL stages, a 2-stage ring's straggler IS the median and
        could never fire (xs[n//2] picks the larger of two)."""
        t = self.thresholds
        out: List[Anomaly] = []
        p95s = []
        for s in snapshots:
            v = s.get("compute_p95_ms")
            if isinstance(v, (int, float)):
                p95s.append((v, s))
        if len(p95s) < 2:
            # an observation GAP (timed-out poll, fresh stats) restarts
            # every straggler streak: sustain means consecutive, and a
            # stale streak surviving the gap could fire off one later
            # noisy sample (same rule as the SLO loop's missing-metric
            # clear in observe_batching)
            for key in [k for k in self._streak
                        if k.startswith("straggler_hop:")]:
                self._clear(key)
            return out
        vals = [v for v, _ in p95s]
        breached_keys = set()
        for i, (v, s) in enumerate(p95s):
            others = sorted(vals[:i] + vals[i + 1:])
            baseline = others[(len(others) - 1) // 2]   # lower median
            if (v > t.straggler_min_ms
                    and baseline > 0
                    and v > t.straggler_factor * baseline):
                # per-stage sustain identity (see _breach)
                key = f"straggler_hop:{s.get('device_id', '')}" \
                      f":{s.get('role', '')}"
                breached_keys.add(key)
                a = self._breach(
                    "straggler_hop", "warn",
                    {"role": s.get("role"),
                     "device": s.get("device_id", ""),
                     "compute_p95_ms": v,
                     "ring_median_ms": round(baseline, 3),
                     "factor": round(v / baseline, 2)}, key=key)
                if a:
                    out.append(a)
        for key in [k for k in self._streak
                    if k.startswith("straggler_hop:")
                    and k not in breached_keys]:
            self._clear(key)            # recovered stages restart at 0
        return out

    def observe_batching(self, stats: dict) -> List[Anomaly]:
        t = self.thresholds
        out: List[Anomaly] = []
        lat = stats.get("latency") or {}

        # a missing/ineligible metric clears its streak too: "sustain"
        # means CONSECUTIVE breaches, so a stats-reset gap (the value
        # vanishes, e.g. POST /stats/reset clearing the reservoirs) must
        # not let two old breaches + one later noisy sample fire
        for kind, slo, key in (("slo_ttft", t.ttft_slo_ms, "ttft_p95_ms"),
                               ("slo_tpot", t.tpot_slo_ms,
                                "per_token_p95_ms")):
            v = lat.get(key)
            if slo <= 0:
                continue
            if isinstance(v, (int, float)) and v > slo:
                a = self._breach(kind, "critical",
                                 {key: v, "slo_ms": slo})
                if a:
                    out.append(a)
            else:
                self._clear(kind)

        # multiwindow burn-rate: a tenant is burning error budget only
        # when EVERY window (fast 5m AND slow 1h) sits over the
        # threshold — the classic guard against paging on a short blip
        # (5m alone) or on a long-recovered incident (1h alone).  Keyed
        # per tenant so one noisy tenant can't mask another's streak.
        burning = set()
        slo_block = stats.get("slo")
        if t.burn_rate > 0 and isinstance(slo_block, dict):
            from .slo import isfinite
            tenants = slo_block.get("tenants")
            for tenant, ts_ in (tenants or {}).items():
                burn = ts_.get("burn") if isinstance(ts_, dict) else None
                if not isinstance(burn, dict) or not burn:
                    continue
                vals = list(burn.values())
                if not all(isfinite(v) for v in vals):
                    # NaN/inf: unusable sample — it can't fire, and the
                    # streak restarts (sustain means CONSECUTIVE, the
                    # same gap rule as the SLO p95 loop above)
                    continue
                key = f"slo_burn:{tenant}"
                if all(v > t.burn_rate for v in vals):
                    burning.add(key)
                    a = self._breach(
                        "slo_burn", "critical",
                        {"tenant": tenant, "burn": burn,
                         "threshold": t.burn_rate}, key=key)
                    if a:
                        out.append(a)
        for key in [k for k in self._streak
                    if k.startswith("slo_burn:") and k not in burning]:
            self._clear(key)

        # recompile storm: a tracked program's compile count exceeds
        # its documented variant budget (telemetry/profiling.py feeds
        # the stats()["compile"] fragment; e.g. _mixed_step may compile
        # exactly two variants, docs/DESIGN.md §19).  Keyed per program
        # so one storming program can't mask another's streak; only
        # budgeted programs are eligible (budget None = unbounded by
        # design, e.g. per-chunk-length prefill variants).
        storming = set()
        compile_block = stats.get("compile")
        if t.recompile_slack >= 0 and isinstance(compile_block, dict):
            for prog, e in compile_block.items():
                if not isinstance(e, dict):
                    continue
                budget = e.get("variant_budget")
                compiles = e.get("compiles")
                if not isinstance(budget, int) or \
                        not isinstance(compiles, (int, float)):
                    continue
                key = f"recompile:{prog}"
                if compiles > budget + t.recompile_slack:
                    storming.add(key)
                    a = self._breach(
                        "recompile_storm", "critical",
                        {"program": prog, "compiles": int(compiles),
                         "variant_budget": budget,
                         "slack": t.recompile_slack,
                         "compile_seconds":
                             e.get("compile_seconds", 0.0)}, key=key)
                    if a:
                        out.append(a)
        for key in [k for k in self._streak
                    if k.startswith("recompile:") and k not in storming]:
            self._clear(key)

        depth = stats.get("queue_depth")
        if isinstance(depth, int) and depth >= t.queue_depth:
            a = self._breach(
                "queue_saturation", "warn",
                {"queue_depth": depth, "threshold": t.queue_depth,
                 "active_slots": stats.get("active_slots"),
                 "slots": stats.get("slots")})
            if a:
                out.append(a)
        else:
            self._clear("queue_saturation")

        sp = stats.get("speculative") or {}
        rate = sp.get("acceptance_rate")
        drafted = sp.get("rounds", 0) * sp.get("num_draft", 0)
        if (rate is not None and drafted >= t.accept_min_drafted
                and rate < t.accept_floor):
            a = self._breach(
                "accept_collapse", "warn",
                {"acceptance_rate": rate, "floor": t.accept_floor,
                 "drafted": drafted})
            if a:
                out.append(a)
        else:
            self._clear("accept_collapse")

        a = self._watchdog(stats)
        if a:
            out.append(a)
        return out

    def _watchdog(self, stats: dict) -> Optional[Anomaly]:
        """Stalled-pipeline watchdog: work in flight but the step counter
        frozen for longer than ``stall_s``.  Sustain does not apply (the
        window IS the debounce); cooldown still does."""
        t = self.thresholds
        steps = stats.get("steps")
        if not isinstance(steps, int):
            return None
        now = self._clock()
        if self._steps_seen is None or steps != self._steps_seen:
            self._steps_seen, self._steps_ts = steps, now
            return None
        busy = (stats.get("active_slots") or 0) + (
            stats.get("queue_depth") or 0)
        if busy == 0:
            # idle is not stalling: keep the window anchored at NOW so
            # an idle-then-resume cycle doesn't instantly fire a stale
            # 10-minute "stall" on the first busy observation
            self._steps_ts = now
            return None
        stalled_for = now - self._steps_ts
        if stalled_for > t.stall_s:
            if now - self._last_fire.get("pipeline_stall",
                                         -1e18) < t.cooldown_s:
                return None
            self._last_fire["pipeline_stall"] = now
            a = Anomaly("pipeline_stall", "critical", now,
                        {"stalled_for_s": round(stalled_for, 3),
                         "steps": steps, "busy": busy})
            self._recent.append(a)
            return a
        return None

    # -- introspection (``/debugz``) ---------------------------------------

    def recent(self) -> List[dict]:
        return [a.to_dict() for a in self._recent]

    def state(self) -> dict:
        from dataclasses import asdict
        return {"thresholds": asdict(self.thresholds),
                "streaks": dict(self._streak),
                "last_fire": {k: round(v, 3)
                              for k, v in self._last_fire.items()},
                "recent": self.recent()}


class AnomalyMonitor:
    """Detector + consequences: feed a stats dict in, and every anomaly
    that fires is recorded into the flight ring, counted on the
    ``dwt_anomaly_*`` series, and (when a postmortem writer is
    configured) dumped as a bundle.  ``observe`` is throttled to
    ``min_interval_s`` so a tight scheduler loop can call it every
    iteration for free."""

    def __init__(self, detector: Optional[AnomalyDetector] = None,
                 min_interval_s: float = 1.0, clock=time.time,
                 config: Optional[dict] = None):
        self.detector = detector or AnomalyDetector(clock=clock)
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._last_obs = -1e18
        self._config = config
        self._lock = threading.Lock()
        # bounded to the writer's prune depth: a long-serving monitor
        # must not grow this forever nor advertise pruned paths
        self.bundles: "deque[str]" = deque(maxlen=16)

    def observe(self, stats) -> List[Anomaly]:
        now = self._clock()
        with self._lock:
            if now - self._last_obs < self.min_interval_s:
                return []
            self._last_obs = now
        if callable(stats):
            # lazily built: don't pay a stats() snapshot on throttled calls
            try:
                stats = stats()
            except Exception:
                return []
        anomalies = self.detector.observe(stats)
        for a in anomalies:
            self._react(a)
        return anomalies

    def _react(self, a: Anomaly) -> None:
        from . import postmortem
        from .catalog import ANOMALY_EVENTS, ANOMALY_LAST
        from .flightrecorder import get_flight_recorder
        ANOMALY_EVENTS.inc(kind=a.kind)
        ANOMALY_LAST.set(a.ts, kind=a.kind)
        get_flight_recorder().record("anomaly", anomaly=a.kind,
                                     severity=a.severity, **a.detail)
        path = postmortem.trigger(a.kind, detail=a.to_dict(),
                                  config=self._config)
        if path:
            self.bundles.append(path)

    def state(self) -> dict:
        """``/debugz`` payload fragment.  Bundles are filtered to the
        paths still on disk — the writer prunes old ones, and a
        mid-incident operator following a reported path must find it."""
        import os
        return dict(self.detector.state(),
                    bundles=[p for p in self.bundles
                             if os.path.isdir(p)])
