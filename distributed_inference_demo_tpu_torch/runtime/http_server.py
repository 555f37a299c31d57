"""HTTP inference endpoint over an engine backend.

Counterpart of ``distributed_inference_demo_tpu/runtime/http_server.py``'s
``InferenceHTTPServer``, with the same JSON shapes.  The backend is an
``InferenceEngine`` or a ``ContinuousBatchingEngine``; the server holds no
lock around it, so concurrent requests reach the batching engine together
and batch there.

- ``GET  /health``   model, backend, device, capacity
- ``GET  /stats``    the backend's ``stats()``, else ``{"stages": []}``
- ``POST /generate`` ``{"prompt_ids": [[...]], "max_new_tokens": N,
  "seed": s, "logprobs": bool, "stream": bool}`` -> ``{"tokens": [[...]]}``
  (+ ``"logprobs"``); ``"stream": true`` answers chunked JSONL, one
  ``{"step": i, "tokens": [...]}`` line per decoded step
  (+ per-step ``"logprobs"``).  A batching engine whose admission queue
  is full answers ``503`` with ``Retry-After`` (``SchedulerOverloaded``)
- ``POST /classify`` ``{"prompt_ids", "label_token_ids"}`` ->
  ``{"labels": [...]}``

Stop strings (they need a tokenizer), text prompts, ``resume``, images,
``/metrics``, ``/trace``, ``/timeline``, ``/debugz`` and ``/sketch`` answer
501 "not yet ported".
"""

from __future__ import annotations

import itertools
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .overload import SchedulerOverloaded

NOT_PORTED_ROUTES = ("/metrics", "/trace", "/timeline", "/debugz", "/sketch")
NOT_PORTED_FIELDS = ("stop", "resume", "image", "prompt")


def _round_lps(row) -> list:
    """JSON-friendly logprob row (6 decimals ~ float32 noise floor)."""
    return [round(float(x), 6) for x in row]


def _device_name(backend) -> str:
    dev = getattr(backend, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return "cpu"


class InferenceHTTPServer:
    """Threaded HTTP server over an engine-like backend."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 model_name: str = "", default_max_new: int = 128):
        self.backend = backend
        self.model_name = model_name
        self.default_max_new = default_max_new
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _json(self, code: int, obj: dict,
                      headers: Optional[dict] = None) -> None:
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _shed(self, e: SchedulerOverloaded) -> None:
                """503 (or the exception's own code) + Retry-After: the
                admission queue is past its configured depth."""
                self._json(e.http_code, {"error": str(e)},
                           headers={"Retry-After":
                                    str(max(1, int(e.retry_after_s)))})

            def _internal_error(self, e: Exception) -> None:
                # the server keeps serving: log the traceback, answer 500
                traceback.print_exc()
                self._json(500, {"error": str(e)})

            def _not_ported(self, what: str) -> None:
                self._json(501, {"error": f"{what}: not yet ported"})

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                route = self.path.split("?")[0]
                if route == "/health":
                    self._json(200, {
                        "status": "ok",
                        "model": outer.model_name,
                        "backend": type(outer.backend).__name__,
                        "device": _device_name(outer.backend),
                        "max_seq": getattr(outer.backend, "max_seq", None),
                    })
                elif route == "/stats":
                    if hasattr(outer.backend, "stats"):
                        self._json(200, outer.backend.stats())
                    else:
                        self._json(200, {"stages": []})
                elif route in NOT_PORTED_ROUTES:
                    self._not_ported(route)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/classify":
                    self._classify()
                elif self.path == "/generate":
                    self._generate()
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _generate(self):
                try:
                    req = self._body()
                    for field in NOT_PORTED_FIELDS:
                        if req.get(field) is not None:
                            self._not_ported(f"'{field}'")
                            return
                    ids = outer._prompt_ids(req)
                    max_new = int(req.get("max_new_tokens",
                                          outer.default_max_new))
                    seed = int(req.get("seed", 0))
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": str(e)})
                    return
                logprobs = bool(req.get("logprobs"))
                if req.get("stream"):
                    self._stream(ids, max_new, seed, logprobs)
                    return
                try:
                    res = outer.backend.generate(ids, max_new, seed=seed,
                                                 logprobs=logprobs)
                    out = {"tokens": res.tokens.tolist()}
                    if getattr(res, "logprobs", None) is not None:
                        out["logprobs"] = [_round_lps(row)
                                           for row in res.logprobs]
                    self._json(200, out)
                except SchedulerOverloaded as e:
                    self._shed(e)
                except ValueError as e:     # capacity etc.
                    self._json(400, {"error": str(e)})
                except Exception as e:
                    self._internal_error(e)

            def _classify(self):
                if not hasattr(outer.backend, "classify"):
                    self._json(501, {"error": "backend has no classify"})
                    return
                try:
                    req = self._body()
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

            def _stream(self, ids, max_new, seed, logprobs):
                """Chunked JSONL.  The first backend item is pulled before
                the 200 goes out, so a validation error is still a clean
                400/500; a failure mid-stream becomes an ``{"error"}``
                line and the terminating chunk always goes out."""
                first = None
                try:
                    gen = outer.backend.generate_stream(
                        ids, max_new, seed=seed, logprobs=logprobs)
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
                self.end_headers()

                def chunk(data: bytes) -> None:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")

                try:
                    for i, item in enumerate(items):
                        toks, lps = item if logprobs else (item, None)
                        line = {"step": i,
                                "tokens": np.asarray(toks).tolist()}
                        if lps is not None:
                            line["logprobs"] = _round_lps(np.asarray(lps))
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
                try:
                    chunk(b"")      # terminating chunk
                    self.wfile.flush()
                except OSError:
                    pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def _prompt_ids(self, req: dict) -> np.ndarray:
        if "prompt_ids" not in req:
            raise ValueError("request needs 'prompt_ids'")
        ids = np.asarray(req["prompt_ids"], dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        if ids.ndim != 2 or ids.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1D/2D list")
        return ids

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
