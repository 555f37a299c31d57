"""Deterministic fault injection: seeded fault plans + a transport wrapper.

Chaos-engineering substrate for the elastic pipeline (docs/DESIGN.md
§12).  The recovery path — CRC drop, send retry, step-timeout, elastic
reshard, drain/resume — is only trustworthy if it is *continuously
executed* under injected faults (the Chaos Monkey / Jepsen lesson), so
this module makes the messy failures real deployments see reproducible:

- :class:`FaultPlan` — a seeded RNG plus an ordered list of declarative
  :class:`FaultRule`\\ s (``drop``, ``delay``, ``duplicate``, ``reorder``,
  ``corrupt``, ``partition``, ``crash_after``), each scoped by peer,
  tag prefix, message count, and probability.  Same seed + same rules +
  same message sequence ⇒ byte-identical injected-fault event sequence
  (:attr:`FaultPlan.events`; asserted by ``tests/test_chaos.py``), so a
  failing soak run is replayable from its postmortem bundle by seed
  alone.
- :class:`FaultyTransport` — implements the full ``BaseTransport``
  surface and slots between any header/worker and the real
  ``LoopbackTransport``/``ZmqTransport`` unchanged.  Faults are injected
  on the SEND side (every ring edge has a sending wrapper, so every edge
  is coverable); ``crash_after`` fires on sends *and* receives so a
  mostly-receiving stage can die mid-reshard too.

Plans are built from a JSON spec (``DWT_FAULT_PLAN`` env var or
``--fault-plan`` on serve/worker), OFF by default, and **rejected unless
--chaos is set** — fault injection in a production process must be a
double-keyed decision.  Every injected fault is counted
(``dwt_fault_injected_faults_total{kind=...}``) and flight-recorded
(``fault_injected`` events), so a chaos run's postmortem bundle names
its own cause (``tools/postmortem.py`` surfaces them).

Spec shape::

    {"seed": 1234, "name": "soak-1", "rules": [
        {"kind": "delay", "peer": "s1", "tag_prefix": "h:",
         "prob": 0.2, "delay_ms": 15},
        {"kind": "corrupt", "peer": "s2", "after": 3, "max_count": 1},
        {"kind": "crash_after", "peer": null, "n_msgs": 40}]}
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .transport import BaseTransport, TransportError

log = logging.getLogger(__name__)

FAULT_KINDS = ("drop", "delay", "duplicate", "reorder", "corrupt",
               "partition", "crash_after")


class FaultConfigError(ValueError):
    """Malformed fault-plan spec, or a plan supplied without --chaos."""


class InjectedCrash(RuntimeError):
    """A ``crash_after`` rule fired: the wrapped process must die NOW.

    Deliberately NOT a TransportError — the elastic worker swallows
    TransportError on forward sends (a dead next hop is survivable); an
    injected crash must propagate out of the serve loop exactly like a
    real unhandled exception so the crash handler / supervisor sees it.
    """


@dataclass
class FaultRule:
    """One declarative fault.  ``peer``/``tag_prefix`` scope which
    messages match (None = any); ``after`` skips the first N matching
    messages; ``max_count`` bounds how many times the rule fires;
    ``prob`` gates each firing through the plan's seeded RNG."""

    kind: str
    peer: Optional[str] = None
    tag_prefix: Optional[str] = None
    prob: float = 1.0
    after: int = 0
    max_count: Optional[int] = None
    delay_ms: float = 0.0             # delay only
    n_msgs: Optional[int] = None      # crash_after only
    # runtime counters (not part of the spec)
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise FaultConfigError(
                f"unknown fault kind {self.kind!r} "
                f"(known: {list(FAULT_KINDS)})")
        if self.kind == "crash_after" and self.n_msgs is None:
            raise FaultConfigError("crash_after rule needs n_msgs")
        if not 0.0 <= self.prob <= 1.0:
            raise FaultConfigError(f"prob must be in [0,1], got {self.prob}")

    def to_spec(self) -> dict:
        out: dict = {"kind": self.kind}
        for key in ("peer", "tag_prefix", "max_count", "n_msgs"):
            v = getattr(self, key)
            if v is not None:
                out[key] = v
        if self.prob != 1.0:
            out["prob"] = self.prob
        if self.after:
            out["after"] = self.after
        if self.delay_ms:
            out["delay_ms"] = self.delay_ms
        return out

    def matches(self, peer: str, tag: str) -> bool:
        if self.peer is not None and peer != self.peer:
            return False
        if self.tag_prefix is not None and not tag.startswith(
                self.tag_prefix):
            return False
        return True


class FaultPlan:
    """Seeded, ordered fault rules + the injected-event record.

    Thread-safe: one plan may back every edge of a pipeline (header +
    workers share it in the loopback chaos tests).  Determinism holds
    per message *sequence* — identical send/recv sequences replay
    identical decisions because the RNG is consumed in message order
    under the lock."""

    def __init__(self, seed: int = 0,
                 rules: Sequence[FaultRule] = (), name: str = ""):
        self.seed = int(seed)
        self.name = name
        self.rules: List[FaultRule] = list(rules)
        self.rng = random.Random(self.seed)
        self.events: List[dict] = []     # every injected fault, in order
        self._seq = 0                    # messages consulted
        self._msgs = 0                   # messages seen by crash counters
        self._lock = threading.Lock()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlan":
        if not isinstance(spec, dict):
            raise FaultConfigError(
                f"fault plan must be a JSON object, got {type(spec).__name__}")
        known = {"kind", "peer", "tag_prefix", "prob", "after", "max_count",
                 "delay_ms", "n_msgs"}
        rules = []
        for i, r in enumerate(spec.get("rules") or []):
            extra = set(r) - known
            if extra:
                raise FaultConfigError(
                    f"rule {i}: unknown fields {sorted(extra)}")
            rules.append(FaultRule(**r))
        return cls(seed=spec.get("seed", 0), rules=rules,
                   name=spec.get("name", ""))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        try:
            spec = json.loads(text)
        except json.JSONDecodeError as e:
            raise FaultConfigError(f"fault plan is not valid JSON: {e}")
        return cls.from_spec(spec)

    def to_spec(self) -> dict:
        return {"seed": self.seed, "name": self.name,
                "rules": [r.to_spec() for r in self.rules]}

    # -- decisions ---------------------------------------------------------

    def _record(self, kind: str, **fields) -> dict:
        ev = dict(seq=self._seq, kind=kind, **fields)
        self.events.append(ev)
        try:
            from ..telemetry import catalog
            catalog.FAULT_INJECTED.inc(kind=kind)
        except Exception:    # pragma: no cover - defensive
            pass
        try:
            from ..telemetry.flightrecorder import get_flight_recorder
            # the flight event's own kind is "fault_injected"; the rule
            # kind rides as fault_kind (record(kind, **fields) would see
            # ev's "kind" as a duplicate argument otherwise)
            get_flight_recorder().record(
                "fault_injected", fault_kind=kind,
                **{k: v for k, v in ev.items() if k != "kind"})
        except Exception:    # pragma: no cover - defensive
            pass
        return ev

    def on_send(self, device_id: str, peer: str, tag: str,
                nbytes: int) -> List[dict]:
        """Decide the faults for one outbound message.  Returns the fired
        actions in rule order; also advances the crash counter (a send is
        a message)."""
        with self._lock:
            self._seq += 1
            self._msgs += 1
            fired: List[dict] = []
            for rule in self.rules:
                if rule.kind == "crash_after":
                    if (rule.matches(peer, tag)
                            and self._msgs > rule.n_msgs
                            and (rule.max_count is None
                                 or rule.fired < rule.max_count)):
                        rule.fired += 1
                        fired.append(self._record(
                            "crash_after", device=device_id, peer=peer,
                            tag=tag, n_msgs=rule.n_msgs))
                    continue
                if not rule.matches(peer, tag):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if (rule.max_count is not None
                        and rule.fired >= rule.max_count):
                    continue
                if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                ev = {"device": device_id, "peer": peer, "tag": tag,
                      "nbytes": nbytes}
                if rule.kind == "delay":
                    ev["delay_ms"] = rule.delay_ms
                elif rule.kind == "corrupt":
                    # deterministic byte flip: position + mask from the
                    # plan RNG (mask never 0 — the flip must change bits)
                    ev["pos"] = self.rng.randrange(max(1, nbytes))
                    ev["mask"] = self.rng.randrange(1, 256)
                fired.append(self._record(rule.kind, **ev))
            return fired

    def on_recv(self, device_id: str) -> Optional[dict]:
        """Advance the crash counter for one received message; returns a
        crash event if a matching ``crash_after`` rule fires (receive
        rules are unscoped by peer/tag — the receiver often can't know
        the sender before decoding)."""
        with self._lock:
            self._msgs += 1
            for rule in self.rules:
                if (rule.kind == "crash_after" and rule.peer is None
                        and rule.tag_prefix is None
                        and self._msgs > rule.n_msgs
                        and (rule.max_count is None
                             or rule.fired < rule.max_count)):
                    rule.fired += 1
                    return self._record("crash_after", device=device_id,
                                        peer=None, tag=None,
                                        n_msgs=rule.n_msgs)
            return None


class FaultyTransport(BaseTransport):
    """Fault-injecting wrapper with the full ``BaseTransport`` API.

    Wraps the SEND side of one endpoint; receive calls delegate to the
    inner transport's queues (the wrapper registered nothing of its own,
    so the inner endpoint keeps receiving).  ``close`` closes the inner
    transport."""

    def __init__(self, inner: BaseTransport, plan: FaultPlan):
        # deliberately NOT calling super().__init__: recv state lives in
        # the inner transport (its pump threads deliver into *its* inbox)
        self.inner = inner
        self.plan = plan
        self.device_id = inner.device_id
        self.address = getattr(inner, "address", f"faulty:{self.device_id}")
        self._held: List[Tuple[str, str, bytes]] = []   # reorder buffer
        self._held_lock = threading.Lock()
        self._partitioned: set = set()
        self._crashed = False

    # -- fault application -------------------------------------------------

    def _crash(self, ev: dict) -> None:
        """First crash event wins; the bundle names the injected fault so
        the chaos run's postmortem states its own cause."""
        if not self._crashed:
            self._crashed = True
            try:
                from ..telemetry import postmortem
                postmortem.trigger(
                    "injected_fault_crash",
                    detail={"fault": ev, "plan_seed": self.plan.seed,
                            "plan_name": self.plan.name,
                            "plan": self.plan.to_spec(),  # replayable
                            "device": self.device_id})    # by bundle alone
            except Exception:    # pragma: no cover - defensive
                pass
        raise InjectedCrash(
            f"{self.device_id}: injected crash_after fault (plan seed "
            f"{self.plan.seed}, event seq {ev.get('seq')})")

    def _deliver_later(self, peer_id: str, tag: str, payload: bytes,
                       delay_ms: float) -> None:
        def fire():
            try:
                self.inner.send(peer_id, tag, payload)
            except TransportError:
                pass     # the delayed world may have moved on; that's chaos
        t = threading.Timer(delay_ms / 1000.0, fire)
        t.daemon = True
        t.start()

    def send(self, peer_id: str, tag: str, payload: bytes) -> None:
        if self._crashed:
            raise InjectedCrash(f"{self.device_id}: already crashed")
        actions = self.plan.on_send(self.device_id, peer_id, tag,
                                    len(payload))
        if peer_id in self._partitioned:
            # an active partition swallows everything to that peer
            with self.plan._lock:
                self.plan._record("partition_drop", device=self.device_id,
                                  peer=peer_id, tag=tag)
            return
        duplicate = False
        delay_ms = None
        reorder = False
        for ev in actions:
            kind = ev["kind"]
            if kind == "crash_after":
                self._crash(ev)
            elif kind == "partition":
                self._partitioned.add(peer_id)
                return                   # this message is the first casualty
            elif kind == "drop":
                return
            elif kind == "corrupt":
                buf = bytearray(payload)
                if buf:
                    buf[ev["pos"]] ^= ev["mask"]
                payload = bytes(buf)
            elif kind == "delay":
                delay_ms = ev["delay_ms"]
            elif kind == "duplicate":
                duplicate = True
            elif kind == "reorder":
                reorder = True
        if reorder:
            with self._held_lock:
                self._held.append((peer_id, tag, payload))
            return
        sends = [(peer_id, tag, payload)]
        if duplicate:
            sends.append((peer_id, tag, payload))
        if delay_ms is not None:
            for p, t, b in sends:
                self._deliver_later(p, t, b, delay_ms)
        else:
            for p, t, b in sends:
                self.inner.send(p, t, b)
        # a held (reordered) message goes out AFTER the message that
        # overtook it — the two swap places on the wire
        with self._held_lock:
            held, self._held = self._held, []
        for p, t, b in held:
            try:
                self.inner.send(p, t, b)
            except TransportError:
                pass

    # -- plumbing ----------------------------------------------------------

    def connect(self, peer_id: str, address: str) -> None:
        self.inner.connect(peer_id, address)

    def recv_any(self, timeout: Optional[float] = None):
        got = self.inner.recv_any(timeout=timeout)
        ev = self.plan.on_recv(self.device_id)
        if ev is not None:
            self._crash(ev)
        return got

    def recv(self, tag: str, timeout: Optional[float] = None) -> bytes:
        got = self.inner.recv(tag, timeout=timeout)
        ev = self.plan.on_recv(self.device_id)
        if ev is not None:
            self._crash(ev)
        return got

    def _deliver(self, tag: str, payload: bytes) -> None:
        self.inner._deliver(tag, payload)

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# CLI/env plumbing (serve + worker)
# ---------------------------------------------------------------------------

ENV_FAULT_PLAN = "DWT_FAULT_PLAN"


def load_fault_plan(flag_value: Optional[str],
                    chaos: bool) -> Optional[FaultPlan]:
    """Resolve ``--fault-plan`` (a JSON file path or inline JSON) or the
    ``DWT_FAULT_PLAN`` env var into a plan.  None when neither is set —
    fault injection is strictly opt-in.  A plan WITHOUT ``--chaos`` is a
    hard :class:`FaultConfigError`: production serving must not silently
    run with injected faults because an env var leaked into the
    environment."""
    value = flag_value or os.environ.get(ENV_FAULT_PLAN, "")
    if not value:
        return None
    if not chaos:
        raise FaultConfigError(
            "a fault plan is configured (--fault-plan or "
            f"{ENV_FAULT_PLAN}) but --chaos is not set; refusing to "
            "inject faults into a production process")
    if os.path.exists(value):
        try:
            with open(value, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            raise FaultConfigError(f"cannot read fault plan {value!r}: {e}")
    else:
        text = value
    plan = FaultPlan.from_json(text)
    log.warning("CHAOS MODE: fault plan active (seed=%d, %d rules%s)",
                plan.seed, len(plan.rules),
                f", name={plan.name!r}" if plan.name else "")
    return plan


def maybe_wrap(transport: BaseTransport,
               plan: Optional[FaultPlan]) -> BaseTransport:
    """Wrap ``transport`` when a plan is active; identity otherwise."""
    return transport if plan is None else FaultyTransport(transport, plan)
