"""HTTP inference endpoint over an engine backend.

Counterpart of ``distributed_inference_demo_tpu/runtime/http_server.py``'s
``InferenceHTTPServer``, with the same routes, JSON shapes and
validation answers.  The backend is an ``InferenceEngine``, a
``ContinuousBatchingEngine``, a ``SpeculativeBackend`` (whose
``/stats`` is the ``speculative`` fragment), or the pipeline header's
:class:`HeaderBackend` / ``DynamicBatchingHeaderBackend`` (whose
``/stats`` polls every stage); the server holds no lock around it, so
concurrent requests reach the batching engine together and batch
there.

- ``GET  /health``    model, backend, device, capacity
- ``GET  /stats``     the backend's ``stats()``, else ``{"stages": []}``
- ``GET  /metrics``   Prometheus text exposition of the ``dwt_*`` series
  (``telemetry/catalog.scrape`` over the backend)
- ``GET  /trace``     Chrome trace-event JSON of the spans recorded since
  the last call (the batching engine's ``export_trace``)
- ``GET  /timeline``  recent per-request timeline records + the
  per-tenant SLO summary (``?n=`` bounds the tail)
- ``GET  /debugz``    flight-recorder tail, the backend's debug state,
  postmortem bundles written
- ``GET  /sketch``    the workload sketch's canonical bytes
- ``POST /stats/reset`` zero the backend's counters
- ``POST /generate``  ``{"prompt_ids": [[...]]`` or ``"prompt": "text"``
  (with a tokenizer attached), ``"max_new_tokens": N, "seed": s,
  "logprobs": bool, "stream": bool, "stop": str | [str], "tenant": t}``
  -> ``{"tokens": [[...]]}`` (+ ``"logprobs"``, + ``"text"`` with a
  tokenizer); ``"stream": true`` answers chunked JSONL, one ``{"step":
  i, "tokens": [...]}`` line per decoded step (+ per-step
  ``"logprobs"``, + ``"text"`` deltas through ``StreamDetokenizer``).
  ``stop`` cuts each row's text at the earliest stop string
  (:class:`StopMatcher`, :class:`_StopSession`) and answers
  ``stop_reason`` per row; a streamed stop closes the engine's
  generator, so the batching engine frees the row's slot and pages.  A
  batching engine whose admission queue is full answers ``503`` with
  ``Retry-After`` (``SchedulerOverloaded``).  The tenant comes from the
  body or the ``X-DWT-Tenant`` header, a trace id from
  ``X-DWT-Trace-Id``; both ride the batching engine's requests.
- ``POST /classify``  ``{"prompt_ids" | "prompt", "label_token_ids"}``
  -> ``{"labels": [...]}``

  A streamed request may carry ``resume`` (``{"delivered_tokens": [...],
  "rng_step_offset": N}``, gateway failover): a backend with the
  batching engine's resume path replays the delivered prefix silently
  and streams the rest, numbering steps from ``len(delivered_tokens)``.

  A blocking request may carry ``image`` (nested floats [H][W][C] or
  [b][H][W][C]) for a backend whose ``generate`` takes one
  (``runtime/multimodal.MultimodalBackend``); an image with ``stream``,
  or sent to any other backend, answers 501.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..telemetry import catalog as _metrics
from .overload import SchedulerOverloaded

def _round_lps(row) -> list:
    """JSON-friendly logprob row (6 decimals ~ float32 noise floor)."""
    return [round(float(x), 6) for x in row]


def _device_name(backend) -> str:
    dev = getattr(backend, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return "cpu"


class StopMatcher:
    """Incremental stop-sequence matching over streamed text — one owner
    for the blocking and streaming ``stop`` paths.

    ``feed(piece) -> (emittable, matched)``: ``emittable`` is the text
    that can be released to the client NOW — everything before the
    longest trailing run that is still a prefix of some stop string
    (streaming must never emit characters it would have to retract when
    the stop completes a step later).  When a stop completes,
    ``matched`` is True, ``pos`` is the cut position (start of the
    earliest match across all stop strings), and ``emittable`` carries
    exactly the remaining pre-stop text.

    The cut is CHUNKING-INDEPENDENT: feeding per-token pieces and
    feeding the whole text yield the same ``pos`` (the position the
    whole-string ``min(text.find(s))`` reference produces).  The subtle
    case is a short stop completing while an EARLIER-starting longer
    stop is still a live prefix of the buffer tail (stop=["abc", "b"],
    fed "a" then "b": "b" completes at 1, but "ab" may still become
    "abc" cutting at 0) — the verdict is DEFERRED, bounded by the
    longest stop length, until the earlier candidate completes (it wins)
    or dies (the completed match stands).  ``finish()`` resolves a
    still-pending verdict at stream end: no more text can arrive, so the
    completed match stands."""

    def __init__(self, stop):
        self.stop = list(stop)
        # empty stop set = valid pass-through matcher (never matches)
        self._maxlen = max((len(s) for s in self.stop), default=0)
        # only the UNEMITTED tail is buffered: emitted text was released
        # precisely because the holdback proved no future stop can start
        # inside it, so matching stays O(piece + longest_stop) per feed
        # and memory stays bounded regardless of generation length.
        self._buf = ""
        self._base = 0                  # absolute offset of _buf[0]
        self.pos: Optional[int] = None  # absolute cut position

    def feed(self, piece: str):
        if self.pos is not None:
            return "", True
        self._buf += piece
        return self._scan(final=False)

    def _live_start_before(self, comp: int) -> Optional[int]:
        """Earliest start j < comp of a LONGER stop still a live prefix
        running through the buffer end — the position a later-completing
        match could still cut at, making the verdict at ``comp``
        undecidable this feed.  Only starts within ``maxlen`` of the
        buffer end can qualify (a live prefix must outrun the buffer)."""
        buf = self._buf
        for j in range(max(0, len(buf) - self._maxlen + 1), comp):
            tail = buf[j:]
            if any(len(s) > len(tail) and s.startswith(tail)
                   for s in self.stop):
                return j
        return None

    def _scan(self, final: bool):
        buf = self._buf
        hits = [buf.find(s) for s in self.stop if s in buf]
        if hits:
            comp = min(hits)
            live = None if final else self._live_start_before(comp)
            if live is None:
                self.pos = self._base + comp
                out = buf[:comp]
                self._base += comp
                self._buf = ""
                return out, True
            # verdict deferred: emit only up to the live earlier
            # candidate's start; the pending completed match stays in
            # the buffer and is re-found (or beaten) next feed
            out = buf[:live]
            self._base += live
            self._buf = buf[live:]
            return out, False
        hold = max((k for s in self.stop for k in range(1, len(s))
                    if buf.endswith(s[:k])), default=0)
        safe_end = len(buf) - hold
        if safe_end > 0:
            out = buf[:safe_end]
            self._base += safe_end
            self._buf = buf[safe_end:]
            return out, False
        return "", False

    def finish(self):
        """End of stream: resolve any deferred verdict (a pending
        completed match now stands — no more text can complete the
        earlier candidate) and release held-back text otherwise.
        Returns ``(emittable, matched)`` like ``feed``."""
        if self.pos is not None:
            return "", True
        out, matched = self._scan(final=True)
        if not matched:
            out += self._buf
            self._base += len(self._buf)
            self._buf = ""
        return out, matched

    def flush(self) -> str:
        """Back-compat wrapper: ``finish()``'s text alone.  Callers that
        can still act on a late match should use ``finish`` and check
        ``matched`` (a deferred verdict may resolve to a cut here)."""
        return self.finish()[0]


class _StopSession:
    """The per-row decode/match/cut core shared by the BLOCKING and
    STREAMING stop paths (one owner — the eos-flush and token-truncation
    rules must not fork).  ``consume(item)`` processes one step's [b]
    tokens and returns per-row emittable text; ``finish()`` flushes rows
    that ran to length.  Results: ``toks`` (truncated, ragged),
    ``texts``, ``reason`` ("stop" | "eos" | "length"), ``done``.

    With ``logprobs=True``, ``consume`` takes the backend's
    ``(tokens, logprobs)`` pairs and ``lps`` carries per-row logprob
    rows truncated EXACTLY where ``toks`` truncates — one cut position,
    two parallel lists, so a stop can never leave a logprob for a token
    the client never saw (or vice versa)."""

    def __init__(self, tokenizer, stop, b: int, eos,
                 logprobs: bool = False):
        from ..tokenizer import StreamDetokenizer
        self.eos = eos
        self.detoks = [StreamDetokenizer(tokenizer) for _ in range(b)]
        self.matchers = [StopMatcher(stop) for _ in range(b)]
        self.texts = [""] * b
        self.toks = [[] for _ in range(b)]
        self.lens = [[] for _ in range(b)]   # cum text len per token
        self.lps = [[] for _ in range(b)] if logprobs else None
        self.done = [False] * b
        self.reason = ["length"] * b
        self.b = b

    def _cut(self, r: int) -> None:
        """Apply a completed match: truncate text at the cut and keep
        every token needed to produce it (up to the first whose
        cumulative visible text reaches the cut) — logprob rows cut at
        the same token index."""
        import bisect
        m = self.matchers[r].pos
        keep = bisect.bisect_left(self.lens[r], m) + 1
        self.toks[r] = self.toks[r][:min(keep, len(self.toks[r]))]
        if self.lps is not None:
            self.lps[r] = self.lps[r][:len(self.toks[r])]
        self.texts[r] = self.texts[r][:m]
        self.done[r], self.reason[r] = True, "stop"

    def _push(self, r: int, raw: str) -> None:
        self.texts[r] += raw
        if self.lens[r]:
            self.lens[r][-1] = len(self.texts[r])

    def consume(self, item) -> list:
        if self.lps is not None:
            toks_item, lps_item = item
            lp_arr = np.asarray(lps_item).reshape(-1).tolist()
        else:
            toks_item, lp_arr = item, None
        arr = np.asarray(toks_item).reshape(-1).tolist()
        pieces = [""] * self.b
        for r in range(self.b):
            if self.done[r]:
                continue
            self.toks[r].append(int(arr[r]))
            if lp_arr is not None:
                self.lps[r].append(float(lp_arr[r]))
            raw = self.detoks[r].push(arr[r])
            self.texts[r] += raw
            self.lens[r].append(len(self.texts[r]))
            pieces[r], matched = self.matchers[r].feed(raw)
            if matched:
                self._cut(r)
            elif self.eos is not None and int(arr[r]) == self.eos:
                # natural termination beats budget (a row past its eos
                # only pads — engine _mask_eos); the detokenizer may
                # still hold back chars from EARLIER tokens: flush them
                # through the matcher so they are neither lost nor
                # allowed to complete a stop unnoticed
                tail = self.detoks[r].flush()
                self._push(r, tail)
                extra, matched = self.matchers[r].feed(tail)
                pieces[r] += extra
                if not matched:
                    # the row is over: resolve any deferred verdict (a
                    # pending completed stop now stands) before calling
                    # it an eos finish
                    extra2, matched = self.matchers[r].finish()
                    pieces[r] += extra2
                if matched:
                    self._cut(r)
                else:
                    self.done[r], self.reason[r] = True, "eos"
        return pieces

    def finish(self) -> list:
        """Flush detok + matcher holdback for rows that ran to length
        (a stop may still complete inside the flushed tail)."""
        pieces = [""] * self.b
        for r in range(self.b):
            if self.done[r]:
                continue
            tail = self.detoks[r].flush()
            self._push(r, tail)
            piece, matched = self.matchers[r].feed(tail)
            if not matched:
                extra, matched = self.matchers[r].finish()
                piece += extra
            pieces[r] = piece
            if matched:
                self._cut(r)
        return pieces


def _accepts_kwarg(fn, name: str) -> bool:
    """Duck-typed capability check: does ``fn`` accept ``name=``?  True
    for an explicit parameter OR a **kwargs catch-all (wrapper backends
    that forward to an engine)."""
    import inspect
    params = inspect.signature(fn).parameters
    return (name in params
            or any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()))


class HeaderBackend:
    """Adapts a PipelineHeader/ElasticHeader to the engine surface used by
    the HTTP handler (generate + generate_stream)."""

    def __init__(self, header, max_seq: int, num_stages: int = 2):
        from ..telemetry.anomaly import AnomalyMonitor
        self.header = header
        self.max_seq = max_seq
        self.num_stages = num_stages
        self._lock = threading.Lock()   # one pipeline run at a time
        # straggler watch over the polled stage snapshots: every /stats
        # or /metrics collection feeds the detector, so a scheduled
        # Prometheus scrape is what drives straggler-hop detection in
        # production (no extra polling thread)
        self.anomaly = AnomalyMonitor(config={
            "backend": type(self).__name__, "num_stages": num_stages,
            "max_seq": max_seq})

    @property
    def device(self):
        """The header stage's device (``GET /health``)."""
        return self.header.rt.device

    def stats(self) -> dict:
        """Header snapshot + polled downstream stage snapshots."""
        with self._lock:
            stages = self.header.collect_stats(self.num_stages)
        self.anomaly.observe({"stages": stages})
        return {"stages": stages}

    def export_trace(self) -> dict:
        """Chrome trace JSON of all spans recorded since the last export
        (header + every downstream stage, via the statsreq path)."""
        with self._lock:
            return self.header.collect_trace(self.num_stages)

    def scrape_stats(self) -> dict:
        """Like :meth:`stats` but BOUNDED end to end — a Prometheus
        scrape runs on a schedule and must not stall behind an in-flight
        generation (the request lock is held for a whole run) or a dead
        stage (the stats poll waits ~10s per missing reply).  When the
        pipeline is busy, return no stages: the scrape renders the
        last-bridged series instead of going DOWN exactly while the
        system is under the load telemetry exists to observe."""
        if not self._lock.acquire(timeout=2.0):
            return {"stages": []}
        try:
            stages = self.header.collect_stats(self.num_stages,
                                               timeout=2.0)
        finally:
            self._lock.release()
        self.anomaly.observe({"stages": stages})
        return {"stages": stages}

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 seed: int = 0):
        import time

        from .engine import GenerationResult
        ids = np.asarray(prompt_ids)
        t0 = time.perf_counter()
        with self._lock:
            toks = self.header.generate(ids, max_new_tokens)
        return GenerationResult(tokens=toks, prompt_len=ids.shape[1],
                                num_new=toks.shape[1],
                                seconds=time.perf_counter() - t0)

    def generate_stream(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        seed: int = 0):
        """TRUE streaming over the pipeline: the header's run loop fires
        ``on_token`` per ring step on a worker thread; tokens are yielded
        the moment each one returns from the tail (the reference streams
        partial decodes to its UI the same way, DataRepository)."""
        import queue as queue_mod

        q: "queue_mod.Queue" = queue_mod.Queue()
        SENTINEL = object()

        def run():
            try:
                with self._lock:
                    self.header.generate_many(
                        [np.asarray(prompt_ids)], max_new_tokens,
                        on_token=lambda i, step, toks: q.put(toks))
            except BaseException as e:     # surface in the consumer
                q.put(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join(timeout=10)

    def classify(self, prompt_ids: np.ndarray, label_token_ids):
        with self._lock:
            [pred] = self.header.classify_many(
                [np.asarray(prompt_ids)], label_token_ids)
        return pred

    def reset_stats(self):
        with self._lock:
            self.header.reset_stats()

    def debug_state(self) -> dict:
        """Backend fragment of ``GET /debugz``: the ring steps still
        awaiting their reply (racy read of header-owned state — a
        diagnostic peek, not an invariant) + straggler-detector state."""
        sent = getattr(self.header, "_sent_at", {})
        return {"num_stages": self.num_stages,
                "in_flight": [[r, s] for r, s in sorted(sent.keys())],
                "anomaly": self.anomaly.state()}


class InferenceHTTPServer:
    """Threaded HTTP server over an engine-like backend."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, model_name: str = "",
                 default_max_new: int = 128,
                 request_timeout: Optional[float] = None):
        """``tokenizer``: a ``tokenizer.Tokenizer`` for text prompts, the
        ``"text"`` fields and stop strings (None: ids only).
        ``request_timeout``: per-request deadline for blocking
        ``/generate``, passed as ``timeout=`` to backends that accept it
        (the batching engine cancels the request, freeing its slot) and
        answered 504.  None/0 = no deadline."""
        self.backend = backend
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_new = default_max_new
        self.request_timeout = request_timeout or None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            # known routes only: the route label must stay bounded
            _ROUTES = frozenset((
                "/health", "/stats", "/stats/reset", "/metrics", "/trace",
                "/timeline", "/debugz", "/sketch", "/generate",
                "/classify"))

            def _json(self, code: int, obj: dict,
                      headers: Optional[dict] = None) -> None:
                # counted before the body goes out: a client that reacts
                # to this response with a /metrics scrape sees its own
                # request (the scrape itself bypasses _json)
                route = self.path.split("?")[0]
                if route not in self._ROUTES:
                    route = "other"
                _metrics.HTTP_REQUESTS.inc(route=route, code=str(code))
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                tid = getattr(self, "_trace_id", None)
                if tid:
                    self.send_header("X-DWT-Trace-Id", tid)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _obs_kwargs(self, fn) -> dict:
                """tenant/trace_id kwargs for backends that take them
                (the batching engine)."""
                out = {}
                tenant = getattr(self, "_tenant", None)
                if tenant and _accepts_kwarg(fn, "tenant"):
                    out["tenant"] = str(tenant)
                tid = getattr(self, "_trace_id", None)
                if tid and _accepts_kwarg(fn, "trace_id"):
                    try:
                        out["trace_id"] = int(str(tid), 16)
                    except ValueError:
                        pass
                return out

            def _shed(self, e: SchedulerOverloaded) -> None:
                """503 (or the exception's own code) + Retry-After: the
                admission queue is past its configured depth."""
                self._json(getattr(e, "http_code", 503), {"error": str(e)},
                           headers={"Retry-After":
                                    str(max(1, int(e.retry_after_s)))})

            def _internal_error(self, e: Exception) -> None:
                # the server keeps serving: log the traceback, answer 500
                traceback.print_exc()
                self._json(500, {"error": str(e)})

            def _raw(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _metrics_scrape(self) -> None:
                """Prometheus text exposition over the port's registry +
                this backend's bridged series."""
                try:
                    text = _metrics.scrape(outer.backend)
                    code = 200
                except Exception as e:   # the scrape must never crash
                    text = f"# scrape error: {e}\n"
                    code = 500
                self._raw(code, text.encode("utf-8"),
                          "text/plain; version=0.0.4; charset=utf-8")

            def do_GET(self):
                route = self.path.split("?")[0]
                if route == "/metrics":
                    self._metrics_scrape()
                elif self.path == "/trace":
                    # spans recorded since the last /trace call
                    if hasattr(outer.backend, "export_trace"):
                        try:
                            self._json(200, outer.backend.export_trace())
                        except Exception as e:
                            self._json(500, {"error": str(e)})
                    else:
                        self._json(501, {"error": "backend has no trace "
                                                  "export"})
                elif self.path == "/health":
                    self._json(200, {
                        "status": "ok",
                        "model": outer.model_name,
                        "backend": type(outer.backend).__name__,
                        "device": _device_name(outer.backend),
                        "max_seq": getattr(outer.backend, "max_seq", None),
                    })
                elif self.path == "/stats":
                    if hasattr(outer.backend, "stats"):
                        self._json(200, outer.backend.stats())
                    else:
                        self._json(200, {"stages": []})
                elif route == "/timeline":
                    from urllib.parse import parse_qs, urlparse
                    from ..telemetry import slo as _slo
                    try:
                        qs = parse_qs(urlparse(self.path).query)
                        n = max(1, min(1024, int(qs.get("n", ["64"])[0])))
                    except ValueError:
                        n = 64
                    try:
                        self._json(200, _slo.debug_state(tail=n))
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                elif route == "/debugz":
                    try:
                        self._json(200, outer._debugz())
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                elif route == "/sketch":
                    # the recorder's canonical bytes verbatim (a re-dump
                    # would break the byte-identity contract)
                    from ..telemetry import profiling as _profiling
                    try:
                        body = _profiling.get_sketch().to_json() \
                            .encode("utf-8")
                        _metrics.HTTP_REQUESTS.inc(route="/sketch",
                                                   code="200")
                        self._raw(200, body, "application/json")
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/stats/reset":
                    if hasattr(outer.backend, "reset_stats"):
                        outer.backend.reset_stats()
                        self._json(200, {"reset": True})
                    else:
                        self._json(501, {"error": "backend has no "
                                                  "reset_stats"})
                elif self.path == "/classify":
                    self._classify()
                elif self.path == "/generate":
                    self._generate()
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _generate(self):
                # a proxied request carries the gateway's trace id: echo
                # it on every response and land it in the flight recorder
                tid = self.headers.get("X-DWT-Trace-Id")
                if tid:
                    self._trace_id = tid[:64]
                    from ..telemetry.flightrecorder import \
                        get_flight_recorder
                    get_flight_recorder().record(
                        "http_generate_proxied", trace_id=self._trace_id)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    ids = outer._prompt_ids(req)
                    max_new = int(req.get("max_new_tokens",
                                          outer.default_max_new))
                    seed = int(req.get("seed", 0))
                    image = req.get("image")
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": str(e)})
                    return
                # tenant identity: the body field wins over the
                # gateway-forwarded header
                self._tenant = (req.get("tenant")
                                or self.headers.get("X-DWT-Tenant"))
                if image is not None:
                    # honor-or-reject: only a multimodal backend takes an
                    # image, and an image prefix does not stream
                    if req.get("stream"):
                        self._json(501, {"error": "image input does not "
                                                  "support stream"})
                        return
                    if not _accepts_kwarg(outer.backend.generate, "image"):
                        self._json(501, {"error": "backend does not "
                                                  "support image input"})
                        return
                resume = req.get("resume")
                if resume is not None:
                    # mid-stream failover resumption: the gateway
                    # re-POSTs the journaled request with the delivered
                    # prefix.  Honor-or-reject: only a backend with the
                    # submit_resumed path takes it
                    err_code, err = None, None
                    if not req.get("stream"):
                        err_code, err = 400, "resume requires stream"
                    elif (image is not None or req.get("stop") is not None
                          or req.get("logprobs")):
                        err_code, err = 501, ("resume does not support "
                                              "image, stop, or logprobs")
                    elif not _accepts_kwarg(outer.backend.generate_stream,
                                            "resume"):
                        err_code, err = 501, ("backend does not support "
                                              "resume")
                    elif not isinstance(resume, dict):
                        err_code, err = 400, "resume must be an object"
                    if err is None:
                        delivered = resume.get("delivered_tokens")
                        if (not isinstance(delivered, (list, tuple))
                                or not delivered
                                or not all(isinstance(t, int)
                                           for t in delivered)):
                            err_code, err = 400, (
                                "resume.delivered_tokens must be a "
                                "non-empty list of token ids")
                        elif int(resume.get("rng_step_offset",
                                            len(delivered))) \
                                != len(delivered):
                            # one draw schedule per delivered token: an
                            # offset that disagrees cannot be exact
                            err_code, err = 400, (
                                "resume.rng_step_offset must equal "
                                "len(delivered_tokens)")
                    if err is not None:
                        self._json(err_code, {"error": err})
                        return
                stop = req.get("stop")
                if stop is not None:
                    if isinstance(stop, str):
                        stop = [stop]
                    if (not isinstance(stop, list) or not stop
                            or not all(isinstance(s, str) and s
                                       for s in stop)):
                        self._json(400, {
                            "error": "stop must be a non-empty string "
                                     "or list of non-empty strings"})
                        return
                    # honor-or-reject: stop strings need server-side text
                    unsupported = [w for w, on in [
                        ("a server-side tokenizer (none attached)",
                         outer.tokenizer is None),
                        ("image", image is not None)] if on]
                    if unsupported:
                        self._json(501, {
                            "error": "stop does not support "
                                     + ", ".join(unsupported)})
                        return
                    want_lp = bool(req.get("logprobs"))
                    if want_lp and not _accepts_kwarg(
                            outer.backend.generate_stream, "logprobs"):
                        # both stop paths consume the stream surface
                        self._json(501, {
                            "error": "backend does not support "
                                     "logprobs with stop"})
                        return
                    if req.get("stream"):
                        self._stream_stop(ids, max_new, seed, stop,
                                          logprobs=want_lp)
                        return
                    try:
                        self._generate_stop(ids, max_new, seed, stop,
                                            logprobs=want_lp)
                    except SchedulerOverloaded as e:
                        self._shed(e)
                    except TimeoutError as e:
                        self._json(504, {"error": str(e) or
                                         "request deadline exceeded"})
                    except ValueError as e:
                        self._json(400, {"error": str(e)})
                    except Exception as e:
                        self._internal_error(e)
                    return
                logprobs = bool(req.get("logprobs"))
                # honor-or-reject: a backend without logprobs (the
                # speculative engines) answers 501, never drops them
                if req.get("stream"):
                    if logprobs and not _accepts_kwarg(
                            outer.backend.generate_stream, "logprobs"):
                        self._json(501, {
                            "error": "backend does not support "
                                     "logprobs with stream"})
                        return
                    self._stream(ids, max_new, seed, logprobs,
                                 resume=resume)
                    return
                if logprobs and not _accepts_kwarg(outer.backend.generate,
                                                   "logprobs"):
                    self._json(501, {"error": "backend does not support "
                                              "logprobs"})
                    return
                try:
                    kwargs = {"logprobs": True} if logprobs else {}
                    if image is not None:
                        kwargs["image"] = image
                    if (outer.request_timeout
                            and _accepts_kwarg(outer.backend.generate,
                                               "timeout")):
                        kwargs["timeout"] = outer.request_timeout
                    kwargs.update(self._obs_kwargs(outer.backend.generate))
                    t_req = time.perf_counter()
                    res = outer.backend.generate(ids, max_new, seed=seed,
                                                 **kwargs)
                    _metrics.HTTP_REQUEST_SECONDS.observe(
                        time.perf_counter() - t_req, route="/generate")
                    _metrics.HTTP_GENERATED_TOKENS.inc(int(res.tokens.size))
                    out = {"tokens": res.tokens.tolist()}
                    if getattr(res, "logprobs", None) is not None:
                        out["logprobs"] = [_round_lps(row)
                                           for row in res.logprobs]
                    if outer.tokenizer is not None:
                        out["text"] = [outer.tokenizer.decode(row)
                                       for row in res.tokens.tolist()]
                    self._json(200, out)
                except SchedulerOverloaded as e:
                    self._shed(e)
                except TimeoutError as e:   # the request was cancelled
                    self._json(504, {"error": str(e) or
                                     "request deadline exceeded"})
                except ValueError as e:     # capacity etc.
                    self._json(400, {"error": str(e)})
                except Exception as e:
                    self._internal_error(e)

            def _classify(self):
                if not hasattr(outer.backend, "classify"):
                    self._json(501, {"error": "backend has no classify"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    ids = outer._prompt_ids(req)
                    label_ids = req["label_token_ids"]
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    pred = outer.backend.classify(ids, label_ids)
                    self._json(200, {"labels": np.asarray(pred).tolist()})
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                except Exception as e:
                    self._internal_error(e)

            def _generate_stop(self, ids, max_new, seed, stop,
                               logprobs=False):
                """Blocking generation with stop strings: each row ends at
                the earliest occurrence of any stop string (excluded
                from the output), and the batch stops consuming once
                every row finished, closing the engine's generator.
                Rows are ragged; ``stop_reason`` per row is "stop",
                "eos" (the eos token included) or "length".  With
                ``logprobs`` each row's logprobs are cut at the same
                token index as its tokens (:class:`_StopSession`)."""
                kwargs = {"logprobs": True} if logprobs else {}
                if (outer.request_timeout
                        and _accepts_kwarg(outer.backend.generate_stream,
                                           "timeout")):
                    kwargs["timeout"] = outer.request_timeout
                kwargs.update(
                    self._obs_kwargs(outer.backend.generate_stream))
                gen = outer.backend.generate_stream(ids, max_new,
                                                    seed=seed, **kwargs)
                ses = _StopSession(outer.tokenizer, stop, len(ids),
                                   getattr(outer.backend, "eos_id", None),
                                   logprobs=logprobs)
                try:
                    for item in gen:
                        ses.consume(item)
                        if all(ses.done):
                            break
                finally:
                    gen.close()
                ses.finish()
                out = {"tokens": ses.toks, "text": ses.texts,
                       "stop_reason": ses.reason}
                if logprobs:
                    out["logprobs"] = [_round_lps(row) for row in ses.lps]
                self._json(200, out)

            def _stream_stop(self, ids, max_new, seed, stop,
                             logprobs=False):
                """Streamed generation with stop strings: chunked JSONL
                whose lines carry per-row text deltas only (characters
                that might begin a stop string are held back until they
                provably are not part of one), then a final line with the
                cut token rows, ``stop_reason`` per row (+ logprob rows
                cut at the same token index)."""
                kwargs = {"logprobs": True} if logprobs else {}
                kwargs.update(
                    self._obs_kwargs(outer.backend.generate_stream))
                gen = outer.backend.generate_stream(ids, max_new,
                                                    seed=seed, **kwargs)

                def lines(items, gen):
                    ses = _StopSession(
                        outer.tokenizer, stop, len(ids),
                        getattr(outer.backend, "eos_id", None),
                        logprobs=logprobs)
                    step = 0
                    for item in items:
                        pieces = ses.consume(item)
                        if any(pieces):
                            yield {"step": step, "text": pieces}
                        step += 1
                        if all(ses.done):
                            gen.close()
                            break
                    tail = ses.finish()
                    if any(tail):
                        yield {"step": step, "text": tail}
                    final = {"done": True, "tokens": ses.toks,
                             "stop_reason": ses.reason}
                    if logprobs:
                        final["logprobs"] = [_round_lps(row)
                                             for row in ses.lps]
                    yield final

                self._stream_lines(gen, lines)

            def _stream_lines(self, gen, lines_fn):
                """The chunked-JSONL framing shared by the plain and stop
                streams: the first backend item is pulled before the 200
                goes out (a validation error is still a clean 400/500),
                then ``lines_fn(items, gen)``'s dict lines go out; a
                failure mid-stream becomes an ``{"error"}`` line, and the
                terminating chunk always goes out.  The engine's
                generator is closed at the end, whatever ended the
                stream (a client gone included)."""
                first = None
                try:
                    first = next(gen)
                except StopIteration:
                    pass
                except SchedulerOverloaded as e:
                    self._shed(e)       # still before headers: clean 503
                    return
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:
                    self._internal_error(e)
                    return
                items = itertools.chain([] if first is None else [first],
                                        gen)
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                tid = getattr(self, "_trace_id", None)
                if tid:
                    self.send_header("X-DWT-Trace-Id", tid)
                self.end_headers()

                def chunk(data: bytes) -> None:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")

                try:
                    for line in lines_fn(items, gen):
                        chunk((json.dumps(line) + "\n").encode("utf-8"))
                except OSError:
                    return      # client went away; the socket is dead
                except Exception as e:
                    traceback.print_exc()
                    try:
                        chunk((json.dumps({"error": str(e)}) + "\n")
                              .encode("utf-8"))
                    except OSError:
                        return
                finally:
                    gen.close()
                try:
                    chunk(b"")      # terminating chunk
                    self.wfile.flush()
                except OSError:
                    pass

            def _stream(self, ids, max_new, seed, logprobs=False,
                        resume=None):
                kwargs = {"logprobs": True} if logprobs else {}
                if resume is not None:
                    kwargs["resume"] = resume
                kwargs.update(
                    self._obs_kwargs(outer.backend.generate_stream))
                gen = outer.backend.generate_stream(ids, max_new, seed=seed,
                                                    **kwargs)
                # a resumed stream continues the dead replica's step
                # numbering (the delivered prefix ends at step k-1)
                step0 = len(resume["delivered_tokens"]) if resume else 0

                def lines(items, gen):
                    # per-row printable text deltas (StreamDetokenizer:
                    # one owner of the boundary and holdback rules)
                    from ..tokenizer import StreamDetokenizer
                    detoks: dict = {}

                    def row_text(r, tok):
                        if r not in detoks:
                            detoks[r] = StreamDetokenizer(outer.tokenizer)
                        return detoks[r].push(tok)

                    n_steps = 0
                    for i, item in enumerate(items):
                        toks, lps = item if logprobs else (item, None)
                        line = {"step": step0 + i,
                                "tokens": np.asarray(toks).tolist()}
                        if lps is not None:
                            line["logprobs"] = _round_lps(np.asarray(lps))
                        if outer.tokenizer is not None:
                            line["text"] = [
                                row_text(r, t) for r, t in
                                enumerate(np.asarray(toks).tolist())]
                        yield line
                        n_steps = i + 1
                    if outer.tokenizer is not None and detoks:
                        # flush text held back by the U+FFFD guard: a
                        # stream ending on a split token must not drop
                        # its final characters
                        rem = [detoks[r].flush() if r in detoks else ""
                               for r in range(max(detoks) + 1)]
                        if any(rem):
                            yield {"step": step0 + n_steps, "tokens": [],
                                   "text": rem}

                self._stream_lines(gen, lines)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def _debugz(self) -> dict:
        """``GET /debugz``: flight-recorder tail, the backend's debug
        state (when it has one), and the postmortem bundles written so
        far.  Read-only and bounded."""
        from ..telemetry import flightrecorder, postmortem
        out = {"flight": flightrecorder.debug_state()}
        debug_state = getattr(self.backend, "debug_state", None)
        if callable(debug_state):
            out["backend"] = debug_state()
        out["postmortem"] = postmortem.debug_state()
        return out

    def _prompt_ids(self, req: dict) -> np.ndarray:
        if "prompt_ids" in req:
            ids = np.asarray(req["prompt_ids"], dtype=np.int32)
            if ids.ndim == 1:
                ids = ids[None, :]
            if ids.ndim != 2 or ids.size == 0:
                raise ValueError("prompt_ids must be a non-empty 1D/2D list")
            return ids
        if "prompt" in req:
            if self.tokenizer is None:
                raise ValueError(
                    "text prompt given but no tokenizer is attached; "
                    "send prompt_ids or start the server with --tokenizer")
            ids = self.tokenizer.encode(str(req["prompt"]))
            return np.asarray([ids], dtype=np.int32)
        raise ValueError("request needs 'prompt_ids' or 'prompt'")

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
