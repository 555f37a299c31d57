"""Gateway metrics federation: one fleet-wide ``/metrics`` page.

Each replica already serves its own Prometheus text exposition
(``runtime/http_server.py`` → ``telemetry/catalog.scrape``).  The
gateway is the one process that knows the whole fleet, so it federates:
:class:`FleetScraper` pulls every registered replica's ``/metrics``
over the same host:port channel the registry's health prober uses,
re-labels every sample with ``replica="host:port"``, and merges the
sections with the gateway's own registry into a single page served at
``GET /metrics/fleet``.

The operational contract (docs/DESIGN.md §7):

- **debounced**: replica fetches are rate-limited to ``min_interval_s``
  per replica — a dashboard refreshing ``/metrics/fleet`` at 10 Hz must
  not turn the gateway into a load generator against its own fleet.
- **bounded staleness**: a failed fetch serves the replica's last good
  text for up to ``max_stale_s`` (counted on
  ``dwt_gateway_fleet_failed_scrapes_total``); beyond that the section
  degrades to an explanatory comment — silently-frozen counters from a
  dead replica are worse than a visible hole.
- **age is a metric**: ``dwt_gateway_fleet_scrape_age_seconds`` says
  how stale each replica's section is, so the staleness itself is
  alertable.
- **family-merged output**: sections are parsed into metric families
  and merged so each ``# HELP``/``# TYPE`` header appears once and all
  of a family's samples (gateway's own, un-relabeled, plus every
  replica's) stay contiguous — strict exposition parsers accept the
  result.

The fetcher is injectable (same pattern as the registry's ``prober``)
so federation is testable without sockets.
"""

from __future__ import annotations

import threading
import time
from http.client import HTTPConnection
from typing import Callable, Dict, List, Optional, Tuple

from ...telemetry import catalog as _catalog


def http_metrics_fetcher(timeout_s: float = 2.0):
    """Default fetcher: ``GET /metrics`` on the replica, decoded text.
    Raises on transport errors or non-200 (the scraper counts the
    raise, not the reason — same rule as ``http_stats_prober``)."""

    def fetch(host: str, port: int) -> str:
        conn = HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"/metrics returned {resp.status}")
            return body.decode("utf-8", "replace")
        finally:
            conn.close()

    return fetch


# -- exposition text surgery -----------------------------------------------

def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def relabel_sample(line: str, rid: str) -> str:
    """Inject ``replica="rid"`` into one sample line.

    ``name{a="b"} v`` gains a leading label; ``name v`` gains a label
    set.  The injected label goes FIRST so it cannot land inside an
    existing label's (escaped-quote-bearing) value — everything after
    the first ``{`` is untouched."""
    tag = f'replica="{_escape_label(rid)}"'
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        rest = line[brace + 1:]
        sep = "" if rest.startswith("}") else ","
        return f"{line[:brace]}{{{tag}{sep}{rest}"
    if space == -1:
        return line          # malformed; pass through untouched
    return f"{line[:space]}{{{tag}}}{line[space:]}"


def parse_families(text: str) -> "List[Tuple[str, dict]]":
    """Parse one exposition page into ordered ``(family_name, fam)``
    pairs, ``fam = {"help": line|None, "type": line|None,
    "samples": [line, ...]}``.

    Family attribution follows the renderer's grouping: samples after a
    ``# HELP``/``# TYPE`` header belong to that family until the next
    header (histogram ``_bucket``/``_sum``/``_count`` children resolve
    to their base family for free).  A headerless sample keys on its
    own metric name — good enough to merge foreign exporters."""
    fams: Dict[str, dict] = {}
    order: List[str] = []
    current: Optional[str] = None

    def fam(name: str) -> dict:
        if name not in fams:
            fams[name] = {"help": None, "type": None, "samples": []}
            order.append(name)
        return fams[name]

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                continue
            name = parts[2]
            f = fam(name)
            key = "help" if parts[1] == "HELP" else "type"
            if f[key] is None:
                f[key] = line
            current = name
        elif line.startswith("#"):
            continue                      # other comments don't merge
        else:
            if current is not None:
                name = current
            else:
                end = min(x for x in (line.find("{"), line.find(" "))
                          if x != -1) if ("{" in line or " " in line) \
                    else len(line)
                name = line[:end]
            fam(name)["samples"].append(line)
    return [(n, fams[n]) for n in order]


def merge_exposition(sections: "List[Tuple[Optional[str], str]]") -> str:
    """Merge ``(replica_id_or_None, exposition_text)`` sections into one
    page.  ``None`` marks the gateway's own section (samples pass
    through un-relabeled); every other section's samples gain
    ``replica="rid"``.  Headers dedup first-wins; families keep the
    order of first appearance; each family's samples stay contiguous."""
    merged: Dict[str, dict] = {}
    order: List[str] = []
    for rid, text in sections:
        for name, f in parse_families(text):
            if name not in merged:
                merged[name] = {"help": None, "type": None, "samples": []}
                order.append(name)
            m = merged[name]
            m["help"] = m["help"] or f["help"]
            m["type"] = m["type"] or f["type"]
            if rid is None:
                m["samples"].extend(f["samples"])
            else:
                m["samples"].extend(relabel_sample(s, rid)
                                    for s in f["samples"])
    out: List[str] = []
    for name in order:
        m = merged[name]
        if m["help"]:
            out.append(m["help"])
        if m["type"]:
            out.append(m["type"])
        out.extend(m["samples"])
    return "\n".join(out) + ("\n" if out else "")


# -- the scraper -----------------------------------------------------------

class _Cached:
    __slots__ = ("text", "checked_at", "fetched_at")

    def __init__(self) -> None:
        self.text: Optional[str] = None    # last GOOD exposition text
        self.checked_at = -1e18            # last fetch ATTEMPT (debounce)
        self.fetched_at = -1e18            # last fetch SUCCESS (staleness)


class FleetScraper:
    """Debounced, staleness-bounded per-replica ``/metrics`` cache (see
    module docstring).  One instance lives on the gateway server and is
    hit from its request-handler threads — all cache state is under one
    lock, but fetches happen OUTSIDE it so one slow replica cannot
    serialize the others' cache hits."""

    def __init__(self, registry, *, min_interval_s: float = 1.0,
                 max_stale_s: float = 30.0, timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 fetcher: Optional[Callable[[str, int], str]] = None):
        self.registry = registry
        self.min_interval_s = min_interval_s
        self.max_stale_s = max_stale_s
        self._clock = clock
        self._fetch = fetcher or http_metrics_fetcher(timeout_s)
        self._lock = threading.Lock()
        self._cache: Dict[str, _Cached] = {}

    def scrape_fleet(self, own_text) -> str:
        """One federated page: the gateway's ``own_text`` plus every
        registered replica's section (fresh, debounce-cached, stale, or
        a hole comment).  ``own_text`` may be a callable rendering the
        gateway's registry — it runs AFTER the replica pulls so the
        fleet scrape/failure counters this very render just moved are
        already visible in the gateway section."""
        replica_sections: List[Tuple[Optional[str], str]] = []
        holes: List[str] = []
        for rid in self.registry.replica_ids():
            text = self._replica_text(rid)
            if text is None:
                holes.append(f"# replica {rid}: no scrape within "
                             f"{self.max_stale_s:g}s (section dropped)")
            else:
                replica_sections.append((rid, text))
        own = own_text() if callable(own_text) else own_text
        page = merge_exposition([(None, own)] + replica_sections)
        if holes:
            page += "\n".join(holes) + "\n"
        return page

    def _replica_text(self, rid: str) -> Optional[str]:
        now = self._clock()
        with self._lock:
            c = self._cache.setdefault(rid, _Cached())
            fresh = now - c.checked_at < self.min_interval_s
            if not fresh:
                c.checked_at = now       # claim the slot: concurrent
                # handler threads inside the debounce window reuse the
                # cache instead of dogpiling the replica
        if not fresh:
            try:
                host, port = self.registry.endpoint(rid)
                text = self._fetch(host, port)
            except Exception:
                _catalog.GATEWAY_FLEET_SCRAPE_FAILURES.inc(replica=rid)
            else:
                _catalog.GATEWAY_FLEET_SCRAPES.inc(replica=rid)
                with self._lock:
                    c.text, c.fetched_at = text, self._clock()
        with self._lock:
            if c.text is None:
                return None              # never scraped: no age to report
            age = max(0.0, now - c.fetched_at)
            _catalog.GATEWAY_FLEET_SCRAPE_AGE.set(round(age, 3),
                                                  replica=rid)
            return c.text if age <= self.max_stale_s else None

    def debug_state(self) -> dict:
        now = self._clock()
        with self._lock:
            return {rid: {"age_s": (round(now - c.fetched_at, 3)
                                    if c.text is not None else None),
                          "cached": c.text is not None}
                    for rid, c in self._cache.items()}
