"""The gateway HTTP process: cache-aware proxy over N engine replicas.

A standalone :class:`GatewayHTTPServer` (docs/DESIGN.md §16) speaking
the same surface as ``runtime/http_server.py`` — ``/health``,
``/stats``, ``/metrics``, ``/debugz``, ``/trace`` — plus the one route
that matters: ``/generate``, proxied to the replica the
:class:`~.router.PrefixAwareRouter` picks.  Being the fleet's front
door, it also serves the fleet-wide observability surfaces
(docs/DESIGN.md §7):

- ``GET /metrics/fleet`` — every replica's ``/metrics`` re-labeled
  with ``replica="host:port"`` and merged with the gateway's own
  registry (:class:`~.federation.FleetScraper`: debounced, bounded
  staleness);
- ``GET /trace/fleet`` — every replica's ``/trace`` export stitched
  with the gateway's proxy spans into ONE Chrome trace; a request's
  gateway ``route``/``proxy`` spans, its engine spans, and any
  migration spans share the ``X-DWT-Trace-Id`` the gateway minted, so
  Perfetto shows the whole cross-process story on one lane.

Proxy contract (the hard-won parts):

- **one-shot body read, streamed response**: the request body is read
  once and replayed verbatim on retry; the replica's response streams
  through line-by-line (replicas emit chunked JSONL), so the gateway
  adds one line of latency, not one response of buffering.
- **retry before first token only**: a replica that dies (connect
  refused, socket reset, anything but a clean HTTP status) before the
  gateway has forwarded ANY body byte is struck in the registry and
  the request is replayed on the next candidate — bounded by
  ``retry_limit``.  The instant one byte has been forwarded the
  gateway never REPLAYS: the client has seen output, and a verbatim
  replay could duplicate it.
- **resume after first token**: a mid-stream death (severed chunked
  stream, transport error, or the replica's own ``{"error": ...}``
  line) is instead RESUMED on a survivor (docs/DESIGN.md §23): the
  gateway journals every *complete* delivered JSONL line, re-routes
  through the prefix-aware router, and re-POSTs the original body
  plus ``{"resume": {"delivered_tokens": [...], "rng_step_offset":
  N}}`` so the survivor replays the delivered prefix silently and
  streams the suffix bit-identically — bounded by ``resume_limit``
  (0 disables).  Only when resume is exhausted (or the request shape
  is ineligible: multi-row, logprobs, stop, image, resume disabled)
  does the client get the ``{"error": ...}`` JSONL line + clean
  termination (the exact contract engines use for their own
  mid-stream failures) — the documented post-resume fallback, never
  a hang.  A torn trailing fragment (line without ``\n``) is never
  forwarded: the client and the journal both end at the last
  complete line.
- **federated admission**: a replica's own ``503/429 + Retry-After``
  (runtime/overload.py) propagates to the client verbatim — the
  replica already said precisely what the client should do.  Every
  candidate down → the gateway's own
  :class:`~..overload.GatewayOverloaded` 503.
- **tracing**: every proxied request carries ``X-DWT-Trace-Id``; the
  replica echoes it and logs it to its flight recorder
  (runtime/http_server.py), and the gateway records ``route`` +
  ``proxy`` spans under the same id — one trace id covers
  gateway→replica, exported at ``GET /trace`` (and stitched with the
  replicas' engine/migration spans at ``GET /trace/fleet``).
- **tenant identity**: a ``tenant`` body field or ``X-DWT-Tenant``
  header rides the proxy hop as ``X-DWT-Tenant`` so the replica's SLO
  ledger (telemetry/slo.py) attributes the request's goodput to the
  right tenant.
"""

from __future__ import annotations

import json
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ...telemetry import catalog as _catalog
from ...telemetry import metrics as _m
from ...telemetry import profiling as _profiling
from ...telemetry.flightrecorder import get_flight_recorder
from ...telemetry.tracing import (SpanClock, TraceRecorder,
                                  merge_chrome_traces, new_trace_id,
                                  to_chrome_trace)
from ..overload import GatewayOverloaded, SchedulerOverloaded
from .federation import FleetScraper

_HOP_HEADERS = {"transfer-encoding", "connection", "keep-alive",
                "content-length"}


class _ReplicaDied(RuntimeError):
    """The replica failed without producing a clean HTTP response (or
    its stream broke before the first body byte was forwarded)."""


class GatewayHTTPServer:
    """Threaded HTTP gateway over a registry + router pair."""

    def __init__(self, registry, router, host: str = "127.0.0.1",
                 port: int = 0, *, retry_limit: int = 1,
                 resume_limit: int = 1,
                 proxy_timeout_s: Optional[float] = None,
                 fleet_scrape_interval_s: float = 1.0,
                 fleet_max_stale_s: float = 30.0,
                 metrics_fetcher=None, sketch_fetcher=None):
        """``retry_limit``: additional replicas tried after the routed
        one dies before first token.  ``resume_limit``: mid-stream
        failover attempts after the first token (each re-routes the
        journaled request to a survivor with a ``resume`` payload;
        0 disables and restores the error-line-only contract).
        ``proxy_timeout_s``: per-socket
        timeout on replica connections (None = no deadline; streams
        with long decode gaps need None or a generous value).
        ``fleet_scrape_interval_s`` / ``fleet_max_stale_s`` /
        ``metrics_fetcher``: the ``/metrics/fleet`` federation knobs
        (see :class:`~.federation.FleetScraper`).  ``sketch_fetcher``:
        injectable ``(rid, host, port) -> dict`` for the federated
        ``GET /sketch`` (tests run it socket-free; None = HTTP)."""
        self.registry = registry
        self.router = router
        self.retry_limit = max(0, int(retry_limit))
        self.resume_limit = max(0, int(resume_limit))
        self.proxy_timeout_s = proxy_timeout_s
        self._sketch_fetcher = sketch_fetcher
        self.tracer = TraceRecorder("gateway")
        self.fleet = FleetScraper(
            registry, min_interval_s=fleet_scrape_interval_s,
            max_stale_s=fleet_max_stale_s, fetcher=metrics_fetcher)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            # bounded route labels, same rule as the replica server
            _ROUTES = frozenset((
                "/health", "/stats", "/metrics", "/metrics/fleet",
                "/trace", "/trace/fleet", "/debugz", "/sketch",
                "/generate", "/drain"))

            def _json(self, code: int, obj: dict,
                      headers: Optional[dict] = None) -> None:
                route = self.path.split("?")[0]
                if route not in self._ROUTES:
                    route = "other"
                _catalog.HTTP_REQUESTS.inc(route=route, code=str(code))
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _shed(self, e: SchedulerOverloaded) -> None:
                _catalog.GATEWAY_SHED.inc()
                get_flight_recorder().record("gateway_shed",
                                             reason=str(e)[:256])
                self._json(getattr(e, "http_code", 503),
                           {"error": str(e)},
                           headers={"Retry-After":
                                    str(max(1, int(e.retry_after_s)))})

            def _text(self, code: int, text: str) -> None:
                route = self.path.split("?")[0]
                if route not in self._ROUTES:
                    route = "other"
                _catalog.HTTP_REQUESTS.inc(route=route, code=str(code))
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/metrics":
                    try:
                        self._text(200, _catalog.scrape())
                    except Exception as e:
                        self._text(500, f"# scrape error: {e}\n")
                elif path == "/metrics/fleet":
                    try:
                        self._text(200, outer.fleet.scrape_fleet(
                            _catalog.scrape))
                    except Exception as e:
                        self._text(500, f"# fleet scrape error: {e}\n")
                elif path == "/trace/fleet":
                    try:
                        self._json(200, outer._fleet_trace())
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                elif path == "/sketch":
                    # federated workload sketch (§20): merged across up
                    # replicas, served as CANONICAL bytes (re-dumping
                    # through _json would break byte-determinism)
                    try:
                        body = _profiling.render_sketch(
                            outer._fleet_sketch()).encode("utf-8")
                        _catalog.HTTP_REQUESTS.inc(route="/sketch",
                                                   code="200")
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                elif path == "/health":
                    ups = outer.registry.up_replicas()
                    routable = outer.registry.routable_replicas()
                    self._json(200, {
                        "status": "ok" if routable else "degraded",
                        "role": "gateway",
                        "replicas_up": len(ups),
                        "replicas_routable": len(routable),
                        "replicas": outer.registry.replica_ids(),
                    })
                elif path == "/stats":
                    self._json(200, outer.stats())
                elif path == "/trace":
                    self._json(200, to_chrome_trace(outer.tracer.drain()))
                elif path == "/debugz":
                    try:
                        self._json(200, outer._debugz())
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/generate", "/drain"):
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n) or b"{}"
                    req = json.loads(raw)
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": str(e)})
                    return
                if self.path == "/drain":
                    self._json(*outer._handle_drain(req))
                    return
                try:
                    outer._proxy_generate(self, raw, req)
                except SchedulerOverloaded as e:
                    self._shed(e)
                except Exception as e:
                    self._json(500, {"error": str(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # -- the proxy ---------------------------------------------------------

    @staticmethod
    def _routing_tokens(req: dict):
        """The token key the router matches on: the first prompt row.
        Text prompts have no gateway-side tokens (no tokenizer here) —
        they ride the hash fallback keyed on the text bytes."""
        ids = req.get("prompt_ids")
        if ids is None:
            prompt = req.get("prompt")
            if isinstance(prompt, str) and prompt:
                # stable per-byte pseudo-tokens: equal texts share hash
                # and prefix keys without a tokenizer
                return [b for b in prompt.encode("utf-8")[:256]]
            return None
        try:
            row = ids[0] if ids and isinstance(ids[0], list) else ids
            return [int(t) for t in row]
        except (TypeError, ValueError):
            return None

    @staticmethod
    def _make_journal(req: dict, tokens, tenant) -> Optional[dict]:
        """Arm a resume journal iff the request shape supports
        bit-identical resumption: a streaming single-row request with
        no logprobs/stop/image sidecars (those change the line schema
        or the replica-side replay contract).  Ineligible shapes keep
        today's error-line-only mid-stream semantics."""
        if not req.get("stream"):
            return None
        if req.get("logprobs") or req.get("stop") or \
                req.get("image") is not None:
            return None
        ids = req.get("prompt_ids")
        if isinstance(ids, list) and ids and isinstance(ids[0], list) \
                and len(ids) > 1:
            return None     # multi-row batch: one journal can't split it
        return {"body": dict(req), "tokens": [],
                "routing_tokens": tokens, "tenant": tenant,
                "dead": set(), "eligible": True}

    def _proxy_generate(self, handler, raw: bytes, req: dict) -> None:
        tokens = self._routing_tokens(req)
        trace_id = new_trace_id()
        tenant = req.get("tenant") or handler.headers.get("X-DWT-Tenant")
        tenant = str(tenant) if tenant else None
        journal = (self._make_journal(req, tokens, tenant)
                   if self.resume_limit > 0 else None)
        get_flight_recorder().record(
            "gateway_admit", trace_id=f"{trace_id:016x}",
            tenant=tenant or "default")
        route_clock = SpanClock()
        decision = self.router.route(tokens)    # raises GatewayOverloaded
        get_flight_recorder().record(
            "gateway_route", replica=decision.rid,
            policy=decision.policy, match_tokens=decision.match_tokens,
            trace_id=f"{trace_id:016x}")
        route_span = self.tracer.record(
            "gateway.route", trace_id, clock=route_clock,
            replica=decision.rid, policy=decision.policy,
            match_tokens=decision.match_tokens)

        candidates = [decision.rid] + decision.candidates[:self.retry_limit]
        ttft_clock = SpanClock()
        last_err: Optional[Exception] = None
        for attempt, rid in enumerate(candidates):
            if attempt > 0:
                if not self.registry.is_up(rid):
                    continue
                _catalog.GATEWAY_RETRIED.inc()
                get_flight_recorder().record(
                    "gateway_retry", replica=rid, attempt=attempt,
                    trace_id=f"{trace_id:016x}")
            self.router.acquire(rid)
            proxy_clock = SpanClock()
            try:
                done = self._proxy_once(handler, rid, raw, trace_id,
                                        ttft_clock, decision, attempt,
                                        tenant=tenant, journal=journal)
            except _ReplicaDied as e:
                last_err = e
                self.registry.record_failure(rid, reason=str(e))
                continue
            finally:
                self.router.release(rid)
                self.tracer.record(
                    "gateway.proxy", trace_id, parent_id=route_span,
                    clock=proxy_clock, replica=rid, attempt=attempt)
            if done and tokens and decision.policy in (
                    "prefix", "host_tier", "hash"):
                # the replica now holds this prompt's blocks: teach the
                # index so the NEXT request sharing the prefix sticks
                # (a host_tier route lands here too — the promote puts
                # the prefix back in the replica's DEVICE tree, so the
                # next hit is an ordinary prefix route)
                self.router.record(rid, tokens)
            return
        raise GatewayOverloaded(
            "request failed on every candidate replica before first "
            f"token (tried {len(candidates)}; last error: {last_err})",
            retry_after_s=self.registry.retry_after_hint())

    @staticmethod
    def _journal_line(journal: dict, line: bytes) -> bool:
        """Fold one complete forwarded JSONL line into the resume
        journal.  Returns False when the line is the replica's own
        ``{"error": ...}`` report — the caller treats that as a
        mid-stream death (resume seam #3) instead of forwarding it.
        A line the journal cannot account for (unparseable, batched
        multi-token) permanently disarms resume for this request."""
        try:
            obj = json.loads(line)
        except Exception:
            journal["eligible"] = False
            return True
        if not isinstance(obj, dict):
            journal["eligible"] = False
            return True
        if "error" in obj:
            return False
        toks = obj.get("tokens")
        if isinstance(toks, list):
            if len(toks) == 1:
                try:
                    journal["tokens"].append(int(toks[0]))
                except (TypeError, ValueError):
                    journal["eligible"] = False
            elif len(toks) > 1:
                journal["eligible"] = False
        return True

    def _forward_stream(self, resp, chunkfn, journal, rid: str):
        """Forward JSONL lines from ``resp`` through ``chunkfn`` until
        the stream ends.  Returns ``(status, detail)``: ``"done"``
        (clean terminating chunk), ``"client_gone"`` (OUR client
        closed — nothing left to do), or ``"died"`` (severed stream,
        transport error, torn trailing fragment, or — when a journal
        is armed and eligible — the replica's own error line, which
        is intercepted so a resume can replace it)."""
        while True:
            try:
                line = resp.readline()
            except Exception as e:
                return "died", f"stream error: {e}"
            if not line:
                # readline() reports a SEVERED chunked stream as a
                # clean EOF: http.client's peek swallows the
                # IncompleteRead AND closes the response, so read()
                # cannot re-raise either.  The one surviving signal is
                # chunk_left — a clean termination walks through the
                # 0-chunk and leaves it None; a replica that died
                # without it leaves 0 (or the unread remainder)
                if resp.chunk_left is not None:
                    return "died", ("chunked stream severed before "
                                    "the terminating chunk")
                return "done", None
            if not line.endswith(b"\n"):
                # torn fragment: never forward a partial JSONL line —
                # the client and the journal both end at the last
                # COMPLETE line (resume's correctness precondition)
                return "died", "stream severed mid-line"
            if journal is not None and journal["eligible"] and \
                    not self._journal_line(journal, line):
                return "died", f"replica {rid} reported mid-stream error"
            try:
                chunkfn(line)
            except OSError:
                return "client_gone", None

    def _proxy_once(self, handler, rid: str, raw: bytes, trace_id: int,
                    ttft_clock: SpanClock, decision, attempt: int,
                    tenant: Optional[str] = None,
                    journal: Optional[dict] = None) -> bool:
        """Proxy one attempt to ``rid``.  Returns True on a 2xx the
        client fully received; raises :class:`_ReplicaDied` when safe
        to retry (no body byte forwarded); propagates replica HTTP
        errors (including 503/429 shedding) as final answers.  A
        mid-stream death with ``journal`` armed hands off to
        :meth:`_resume_stream` before falling back to the error
        line."""
        host, port = self.registry.endpoint(rid)
        conn = HTTPConnection(host, port, timeout=self.proxy_timeout_s)
        try:
            headers = {
                "Content-Type": "application/json",
                "X-DWT-Trace-Id": f"{trace_id:016x}",
            }
            if tenant:
                # tenant rides the hop so the replica's SLO ledger
                # books this request under the right tenant even when
                # the body carried it as a header-only hint
                headers["X-DWT-Tenant"] = tenant[:64]
            try:
                conn.request("POST", "/generate", body=raw,
                             headers=headers)
                resp = conn.getresponse()
            except Exception as e:
                raise _ReplicaDied(f"{rid}: {e}") from e

            if resp.status in (503, 429):
                # federated admission: the replica's shed is the
                # answer — propagate its Retry-After verbatim
                _catalog.GATEWAY_SHED.inc()
                get_flight_recorder().record(
                    "gateway_shed", reason=f"replica {rid} shed "
                    f"({resp.status})", trace_id=f"{trace_id:016x}")
                body = resp.read()
                retry_after = resp.getheader("Retry-After") or "1"
                handler._json(resp.status,
                              _safe_json(body),
                              headers={"Retry-After": retry_after})
                return False
            if resp.status != 200:
                handler._json(resp.status, _safe_json(resp.read()))
                return False

            self.registry.record_success(rid)
            chunked = (resp.getheader("Transfer-Encoding", "")
                       .lower() == "chunked")
            if not chunked:
                body = resp.read()
                _catalog.GATEWAY_PROXY_TTFT_SECONDS.observe(
                    ttft_clock.seconds)
                _catalog.HTTP_REQUESTS.inc(route="/generate", code="200")
                handler.send_response(200)
                ct = resp.getheader("Content-Type", "application/json")
                handler.send_header("Content-Type", ct)
                handler.send_header("Content-Length", str(len(body)))
                handler.send_header("X-DWT-Replica", rid)
                handler.end_headers()
                handler.wfile.write(body)
                return True

            # streaming: forward JSONL lines as our own chunked body.
            # Pull the FIRST line before committing to 200 (a replica
            # that dies pre-first-token must stay retryable).
            try:
                first = resp.readline()
            except Exception as e:
                raise _ReplicaDied(f"{rid}: stream died before first "
                                   f"token: {e}") from e
            if not first:
                raise _ReplicaDied(f"{rid}: empty stream before first "
                                   "token")
            if not first.endswith(b"\n"):
                # torn before the first complete line: nothing has
                # been forwarded, so this stays an ordinary retry
                raise _ReplicaDied(f"{rid}: stream severed mid-line "
                                   "before first token")
            if journal is not None and not self._journal_line(journal,
                                                              first):
                # the replica's FIRST line is already an error report:
                # zero tokens delivered, nothing to resume — forward
                # it verbatim like any other line
                journal["eligible"] = False
            _catalog.GATEWAY_PROXY_TTFT_SECONDS.observe(ttft_clock.seconds)
            _catalog.HTTP_REQUESTS.inc(route="/generate", code="200")
            handler.send_response(200)
            handler.send_header("Content-Type", "application/jsonl")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.send_header("X-DWT-Replica", rid)
            handler.end_headers()

            def chunk(data: bytes) -> None:
                handler.wfile.write(f"{len(data):x}\r\n".encode())
                handler.wfile.write(data + b"\r\n")

            try:
                chunk(first)
            except OSError:
                return True      # our client went away; nothing to do
            status, detail = self._forward_stream(resp, chunk, journal,
                                                  rid)
            if status == "died":
                # replica died MID-stream, after first token: never
                # replayed verbatim (the client saw output).  Resume
                # on a survivor when the journal allows it
                # (docs/DESIGN.md §23); the error line is the
                # post-resume fallback
                self.registry.record_failure(rid, reason="mid-stream")
                resumed = False
                if journal is not None and journal["eligible"] and \
                        journal["tokens"]:
                    journal["dead"].add(rid)
                    resumed = self._resume_stream(chunk, journal,
                                                  trace_id)
                    if not resumed:
                        _catalog.GATEWAY_RESUME_EXHAUSTED.inc()
                if not resumed:
                    try:
                        chunk((json.dumps(
                            {"error": f"replica {rid} died mid-stream: "
                                      f"{detail}"}) + "\n").encode())
                    except OSError:
                        return True
            elif status == "client_gone":
                return True
            try:
                chunk(b"")
                handler.wfile.flush()
            except OSError:
                pass
            return True
        finally:
            conn.close()

    # -- mid-stream failover (docs/DESIGN.md §23) --------------------------

    def _resume_stream(self, chunkfn, journal: dict,
                       trace_id: int) -> bool:
        """Bounded mid-stream failover: re-route the journaled request
        and re-POST it with a ``resume`` payload so a survivor replays
        the delivered prefix silently and streams the suffix
        bit-identically.  Returns True when a survivor finished the
        stream (the client saw delivered prefix + resumed suffix, no
        repeats, gaps, or torn lines); False when attempts are
        exhausted and the caller falls back to the error line."""
        flight = get_flight_recorder()
        for attempt in range(1, self.resume_limit + 1):
            if not (journal["eligible"] and journal["tokens"]):
                return False
            _catalog.GATEWAY_RESUME_ATTEMPTS.inc()
            ttf_clock = SpanClock()
            try:
                decision = self.router.route(journal["routing_tokens"])
            except Exception:
                return False    # nothing routable: fall back now
            cands = [r for r in [decision.rid] + decision.candidates
                     if r not in journal["dead"]
                     and self.registry.is_up(r)]
            if not cands:
                return False
            rid = cands[0]
            flight.record(
                "gateway_resume", replica=rid, attempt=attempt,
                delivered=len(journal["tokens"]),
                trace_id=f"{trace_id:016x}")
            body = dict(journal["body"])
            body["resume"] = {
                "delivered_tokens": [int(t) for t in journal["tokens"]],
                "rng_step_offset": len(journal["tokens"]),
            }
            raw = json.dumps(body).encode("utf-8")
            self.router.acquire(rid)
            span_clock = SpanClock()
            try:
                ok = self._resume_once(rid, raw, chunkfn, journal,
                                       trace_id, ttf_clock)
            finally:
                self.router.release(rid)
                self.tracer.record(
                    "gateway.resume", trace_id, clock=span_clock,
                    replica=rid, attempt=attempt)
            if ok:
                _catalog.GATEWAY_RESUME_SUCCEEDED.inc()
                if journal["routing_tokens"]:
                    # the survivor now holds prompt + stream blocks
                    self.router.record(rid, journal["routing_tokens"])
                flight.record("gateway_resume_done", replica=rid,
                              trace_id=f"{trace_id:016x}")
                return True
            journal["dead"].add(rid)
            self.registry.record_failure(
                rid, reason=f"resume attempt {attempt} failed")
        return False

    def _resume_once(self, rid: str, raw: bytes, chunkfn,
                     journal: dict, trace_id: int,
                     ttf_clock: SpanClock) -> bool:
        """One resume attempt against ``rid``.  The client's 200 +
        chunked framing is already committed, so every failure mode
        here returns False (try the next survivor / fall back) rather
        than raising — nothing may reach the client except complete
        resumed JSONL lines."""
        host, port = self.registry.endpoint(rid)
        conn = HTTPConnection(host, port, timeout=self.proxy_timeout_s)
        try:
            headers = {
                "Content-Type": "application/json",
                "X-DWT-Trace-Id": f"{trace_id:016x}",
            }
            if journal["tenant"]:
                headers["X-DWT-Tenant"] = journal["tenant"][:64]
            try:
                conn.request("POST", "/generate", body=raw,
                             headers=headers)
                resp = conn.getresponse()
            except Exception:
                return False
            if resp.status != 200:
                resp.read()
                return False
            if (resp.getheader("Transfer-Encoding", "")
                    .lower() != "chunked"):
                return False    # resume is a streaming-only contract
            self.registry.record_success(rid)
            try:
                first = resp.readline()
            except Exception:
                return False
            if not first or not first.endswith(b"\n"):
                return False
            _catalog.GATEWAY_RESUME_TTF_SECONDS.observe(ttf_clock.seconds)
            if not self._journal_line(journal, first):
                return False    # survivor's replay failed loudly
            try:
                chunkfn(first)
            except OSError:
                return True     # our client went away; nothing to do
            status, _detail = self._forward_stream(resp, chunkfn,
                                                   journal, rid)
            return status in ("done", "client_gone")
        finally:
            conn.close()

    # -- drain control -----------------------------------------------------

    def _handle_drain(self, req: dict) -> tuple:
        """``POST /drain {"replica": rid, "draining": bool}``: flip the
        registry's drain flag.  Routing changes take effect on the next
        :meth:`~.router.PrefixAwareRouter.route` call; in-flight
        proxies are untouched.  Moving the replica's requests off is
        the migration controller's job, not the gateway's."""
        rid = req.get("replica")
        if not isinstance(rid, str) or rid not in self.registry.replica_ids():
            return 400, {"error": f"unknown replica {rid!r}",
                         "replicas": self.registry.replica_ids()}
        flag = bool(req.get("draining", True))
        get_flight_recorder().record("gateway_drain", replica=rid,
                                     draining=flag)
        self.registry.set_draining(rid, flag)
        return 200, {"replica": rid, "draining": flag,
                     "routable": self.registry.routable_replicas()}

    # -- fleet observability -----------------------------------------------

    def _fleet_trace(self) -> dict:
        """``GET /trace/fleet``: drain the gateway's own spans, drain
        every up replica's ``/trace`` export, and stitch them into one
        Chrome trace (``merge_chrome_traces`` renumbers pids so each
        process keeps its own track).  A replica that fails to export
        just misses from this stitch — its spans survive locally until
        its next ``/trace`` drain, so nothing is lost, only deferred."""
        traces = [to_chrome_trace(self.tracer.drain())]
        for rid in self.registry.up_replicas():
            host, port = self.registry.endpoint(rid)
            conn = HTTPConnection(host, port,
                                  timeout=self.proxy_timeout_s or 5.0)
            try:
                conn.request("GET", "/trace")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    continue
                t = json.loads(body)
                if isinstance(t, dict):
                    traces.append(t)
            except Exception:
                continue
            finally:
                conn.close()
        return merge_chrome_traces(traces)

    def _fleet_sketch(self) -> dict:
        """``GET /sketch``: every up replica's workload-sketch artifact,
        merged deterministically (``profiling.merge_sketches`` sorts by
        replica id and sums fixed-edge histograms bin-wise).  A replica
        that fails to serve — or serves a foreign schema version — is
        listed in ``dropped_replicas`` instead of poisoning the merge."""
        sections = []
        for rid in self.registry.up_replicas():
            try:
                host, port = self.registry.endpoint(rid)
                if self._sketch_fetcher is not None:
                    obj = self._sketch_fetcher(rid, host, port)
                else:
                    conn = HTTPConnection(
                        host, port, timeout=self.proxy_timeout_s or 5.0)
                    try:
                        conn.request("GET", "/sketch")
                        resp = conn.getresponse()
                        body = resp.read()
                        if resp.status != 200:
                            continue
                        obj = json.loads(body)
                    finally:
                        conn.close()
            except Exception:
                continue
            if isinstance(obj, dict):
                sections.append((rid, obj))
        return _profiling.merge_sketches(sections)

    def _fleet_slo(self) -> dict:
        """Per-replica SLO summaries, as last reported over the health
        probe (engine ``stats()`` includes its SLO ledger summary, and
        the prober stores the whole stats dict)."""
        out = {}
        for rid in self.registry.replica_ids():
            try:
                slo = self.registry.get(rid).last_stats.get("slo")
            except KeyError:
                continue
            if isinstance(slo, dict):
                out[rid] = slo
        return out

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        ups = self.registry.up_replicas()
        return {
            "role": "gateway",
            "replicas_up": len(ups),
            "replicas": self.registry.debug_state()["replicas"],
            "routing": self.router.routing_table(),
        }

    def _debugz(self) -> dict:
        from ...telemetry import flightrecorder, postmortem
        return {
            "flight": flightrecorder.debug_state(),
            "registry": self.registry.debug_state(),
            "routing": self.router.routing_table(),
            "postmortem": postmortem.debug_state(),
            "fleet_slo": self._fleet_slo(),
            "federation": self.fleet.debug_state(),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.registry.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.registry.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.registry.stop()

    def shutdown(self) -> None:
        self.registry.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None


def _safe_json(body: bytes) -> dict:
    try:
        out = json.loads(body)
        return out if isinstance(out, dict) else {"error": str(out)}
    except Exception:
        return {"error": body.decode("utf-8", "replace")[:512]}


# re-exported for callers that only import the server module
__all__ = ["GatewayHTTPServer", "GatewayOverloaded"]
