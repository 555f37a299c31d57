"""Overload shedding: the exception contract between scheduler and HTTP.

A copy of the JAX package's module.  Deliberately tiny and
dependency-free: ``runtime/batching.py`` raises it and
``runtime/http_server.py`` catches it and maps it to ``503 +
Retry-After``, without either importing the other.  Graceful degradation is
the point — a saturated admission queue answers *quickly and honestly*
instead of queueing unboundedly until every client has timed out anyway
(docs/DESIGN.md §12, §16).
"""

from __future__ import annotations


class SchedulerOverloaded(RuntimeError):
    """The admission queue is past its configured depth: the request was
    REJECTED, not queued.  ``retry_after_s`` is the server's hint for the
    HTTP ``Retry-After`` header; ``http_code`` picks the status the HTTP
    layer renders — 503 (service saturated; the batching scheduler's
    convention) or 429 (this client should back off; the sp backend's
    one-request-at-a-time queue)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 http_code: int = 503):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.http_code = http_code


class GatewayOverloaded(SchedulerOverloaded):
    """The gateway's federated-admission rejection (docs/DESIGN.md §16):
    no admitted replica can take this request — every replica is evicted
    from routing, or every candidate answered its own 503/429.  A
    subclass so the HTTP layer's one ``_shed`` path renders it; the
    distinct type lets tests (and operators reading tracebacks) tell a
    gateway-level shed from a replica's own admission rejection."""
