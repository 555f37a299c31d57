"""Prefix-aware replicated serving gateway (docs/DESIGN.md §16).

A standalone process (``cli.py gateway``) spreading ``/generate``
traffic across N independent engine replicas, each a full
``runtime/http_server.py`` stack.  Three pieces:

- :class:`ReplicaRegistry` — health-checked membership with
  sustain+cooldown debounce (``registry.py``);
- :class:`PrefixAwareRouter` — cache-aware routing from the gateway's
  own routing history, rendezvous-hash-with-bounded-load fallback
  (``router.py``);
- :class:`GatewayHTTPServer` — the HTTP process and streaming proxy
  with retry-before-first-token (``server.py``).

The gateway holds no engine and no jax: it imports only the telemetry
layer and ``runtime/overload.py``, so it runs anywhere a socket does.

A copy of ``distributed_inference_demo_tpu/runtime/gateway/`` over the
port's own telemetry singletons; it speaks the same wire contract (the
replicas' ``/stats`` fragments, the resume payload), so either package's
gateway fronts either package's replicas.
"""

from .registry import Replica, ReplicaRegistry, http_stats_prober
from .router import PrefixAwareRouter, RouteDecision
from .server import GatewayHTTPServer

__all__ = [
    "Replica",
    "ReplicaRegistry",
    "http_stats_prober",
    "PrefixAwareRouter",
    "RouteDecision",
    "GatewayHTTPServer",
]
