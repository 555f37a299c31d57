"""Inter-stage data-plane transports: ZMQ sockets + in-process loopback.

Replaces the reference's per-edge DEALER/ROUTER socket mesh with its
pull-based "Request Data" handshake and deterministic port arithmetic
(``Communication.java:712-744, 937-961``).  Design differences:

- **One inbound ROUTER per worker** instead of a socket set per concurrency
  slot; concurrent in-flight samples are demultiplexed by message *tag*
  (``kind:request_id:step``), not by socket identity.
- **Push with bounded queues** instead of request/reply pull: ZMQ high-water
  marks give the same backpressure property as the reference's handshake
  without paying an extra round-trip per tensor per hop.
- **Loopback transport** with the identical API for in-process multi-stage
  tests (SURVEY.md §4 calls out the reference's total lack of fake
  transports).
- **Bounded send retry** with exponential backoff + jitter and
  reconnect-on-hard-error (docs/DESIGN.md §12).  Safe end to end: ring
  receivers dedup by (rid, step), so a retried frame that duplicates is
  dropped above, never run into a KV cache twice.

Payloads are opaque bytes — tensor framing is wire.py's job; fault
injection wraps this layer (comm/faults.py) rather than living in it.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from typing import Dict, Optional, Tuple

from ..telemetry._env import env_float, env_int

log = logging.getLogger(__name__)

zmq = None          # imported by ZmqTransport only: the card machine lacks it


def _load_zmq():
    global zmq
    if zmq is None:
        import zmq as _zmq
        zmq = _zmq
    return zmq

DEFAULT_HWM = 64          # messages buffered per edge before backpressure

# send-retry knobs (docs/DESIGN.md §12 table).  Defaults keep the worst
# case bounded: 2 retries x (SNDTIMEO + backoff) on a dead peer, then the
# caller's TransportTimeout -> elastic reshard path takes over.
DEFAULT_SEND_RETRIES = env_int("DWT_TRANSPORT_SEND_RETRIES", 2)
DEFAULT_RETRY_BACKOFF_S = env_float("DWT_TRANSPORT_RETRY_BACKOFF_S", 0.05)


class TransportError(RuntimeError):
    pass


class TransportTimeout(TransportError):
    """recv deadline expired (replaces the reference's indefinite blocking
    ``recv(0)`` hangs, defect #7)."""


def _transport_metrics():
    """The dwt_transport_* counters, resolved lazily (telemetry.catalog
    pulls monitor probes at scrape time; the transport must stay cheap to
    import) and never fatally — a metrics regression must not take down
    the data plane."""
    try:
        from ..telemetry import catalog
        return catalog
    except Exception:       # pragma: no cover - defensive
        return None


def record_corrupt_frame(device_id: str, tag: str, nbytes: int,
                         err: Exception) -> None:
    """ONE owner for the corrupt-frame drop bookkeeping (worker + header
    + elastic receive paths): count ``dwt_transport_corrupt_frames_total``
    and flight-record the drop so a postmortem bundle shows which frame
    died.  The caller then DROPS the frame — the step-timeout/reshard
    path recovers; a wrong token never does."""
    cat = _transport_metrics()
    if cat is not None:
        try:
            cat.TRANSPORT_CORRUPT_FRAMES.inc()
        except Exception:   # pragma: no cover - defensive
            pass
    try:
        from ..telemetry.flightrecorder import get_flight_recorder
        get_flight_recorder().record(
            "corrupt_frame", stage=device_id, tag=tag, nbytes=nbytes,
            error=str(err))
    except Exception:       # pragma: no cover - defensive
        pass
    log.warning("%s: dropping corrupt frame tag=%r (%d bytes): %s",
                device_id, tag, nbytes, err)


class BaseTransport:
    """Tagged message transport between named peers.

    ``recv(tag)`` returns the payload for that tag, stashing any other
    messages that arrive meanwhile; ``recv_any()`` returns the next message
    of any tag — the worker-loop entry point.
    """

    def __init__(self, device_id: str):
        self.device_id = device_id
        self._inbox: "queue.Queue[Tuple[str, bytes]]" = queue.Queue()
        self._stash: Dict[str, list] = {}
        self._stash_lock = threading.Lock()

    # -- to be provided by implementations ---------------------------------

    def connect(self, peer_id: str, address: str) -> None:
        raise NotImplementedError

    def send(self, peer_id: str, tag: str, payload: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # -- shared receive logic ----------------------------------------------

    def _deliver(self, tag: str, payload: bytes) -> None:
        self._inbox.put((tag, payload))

    def recv_any(self, timeout: Optional[float] = None
                 ) -> Tuple[str, bytes]:
        """Next message of any tag (stashed messages first)."""
        with self._stash_lock:
            for tag, items in self._stash.items():
                if items:
                    payload = items.pop(0)
                    if not items:
                        del self._stash[tag]
                    return tag, payload
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout(
                f"{self.device_id}: no message within {timeout}s") from None

    def recv(self, tag: str, timeout: Optional[float] = None) -> bytes:
        """Payload for ``tag``; other arrivals are stashed, not dropped."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._stash_lock:
            items = self._stash.get(tag)
            if items:
                payload = items.pop(0)
                if not items:
                    del self._stash[tag]
                return payload
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                got_tag, payload = self._inbox.get(timeout=remaining)
            except queue.Empty:
                raise TransportTimeout(
                    f"{self.device_id}: no {tag!r} within {timeout}s"
                ) from None
            if got_tag == tag:
                return payload
            with self._stash_lock:
                self._stash.setdefault(got_tag, []).append(payload)


class ZmqTransport(BaseTransport):
    """Socket transport: inbound ROUTER (bound), one outbound DEALER per
    peer (connected lazily via ``connect``)."""

    def __init__(self, device_id: str, bind_host: str = "127.0.0.1",
                 port: int = 0, hwm: int = DEFAULT_HWM,
                 send_timeout: float = 60.0,
                 ctx: Optional[zmq.Context] = None,
                 send_retries: Optional[int] = None,
                 retry_backoff: Optional[float] = None):
        """``send_retries``/``retry_backoff``: bounded send retry with
        exponential backoff + jitter (None = the DWT_TRANSPORT_* env
        knobs, then the defaults).  A retry re-sends the SAME payload; a
        duplicate at the receiver is dropped by the (rid, step) dedup in
        the ring loops, so retrying is safe end to end."""
        super().__init__(device_id)
        _load_zmq()
        self._ctx = ctx or zmq.Context.instance()
        self._hwm = hwm
        self._send_timeout_ms = int(send_timeout * 1000)
        self._send_retries = (DEFAULT_SEND_RETRIES if send_retries is None
                              else max(0, int(send_retries)))
        # per-ATTEMPT bound: send_timeout divides across the attempts so
        # retrying never stretches the total block past ~send_timeout —
        # the elastic header's step_timeout math (and its failure-signal
        # polling) assumes a send returns in bounded time
        self._attempt_timeout_ms = max(
            1, self._send_timeout_ms // (self._send_retries + 1))
        self._retry_backoff = (DEFAULT_RETRY_BACKOFF_S
                               if retry_backoff is None
                               else max(0.0, float(retry_backoff)))
        self._jitter = random.Random()   # non-crypto; spreads herd retries
        self._addrs: Dict[str, str] = {}
        self._in = self._ctx.socket(zmq.ROUTER)
        self._in.setsockopt(zmq.LINGER, 0)
        self._in.setsockopt(zmq.RCVHWM, hwm)
        # a reconnecting peer re-dials with the SAME identity; without
        # handover the ROUTER keeps routing to the half-dead old
        # connection until its teardown completes and silently drops the
        # new one's frames — the fresh connection must win immediately
        self._in.setsockopt(zmq.ROUTER_HANDOVER, 1)
        if port == 0:
            self.port = self._in.bind_to_random_port(f"tcp://{bind_host}")
        else:
            self._in.bind(f"tcp://{bind_host}:{port}")
            self.port = port
        self.address = f"{bind_host}:{self.port}"
        self._out: Dict[str, zmq.Socket] = {}
        self._out_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"transport-{device_id}")
        self._thread.start()

    def _pump(self) -> None:
        poller = zmq.Poller()
        poller.register(self._in, zmq.POLLIN)
        while not self._stop.is_set():
            if not dict(poller.poll(timeout=100)):
                continue
            frames = self._in.recv_multipart()
            # [sender identity, tag, payload]
            if len(frames) != 3:
                continue
            self._deliver(frames[1].decode(), frames[2])

    def _new_out_socket(self, address: str) -> zmq.Socket:
        sock = self._ctx.socket(zmq.DEALER)
        sock.setsockopt(zmq.IDENTITY, self.device_id.encode())
        sock.setsockopt(zmq.LINGER, 0)
        sock.setsockopt(zmq.SNDHWM, self._hwm)
        # A dead peer fills the HWM queue; a bounded send turns that
        # into TransportTimeout instead of an indefinite hang (the
        # send-side counterpart of reference defect #7).
        sock.setsockopt(zmq.SNDTIMEO, self._attempt_timeout_ms)
        sock.connect(f"tcp://{address}")
        return sock

    def connect(self, peer_id: str, address: str) -> None:
        with self._out_lock:
            if peer_id in self._out:
                return
            self._out[peer_id] = self._new_out_socket(address)
            self._addrs[peer_id] = address

    def _reconnect(self, peer_id: str) -> None:
        """Drop the peer's DEALER socket and dial a fresh one (ZMQ hides
        TCP reconnects for transient breaks; this handles the cases it
        can't — a socket broken by a hard error).  Caller holds no lock."""
        with self._out_lock:
            addr = self._addrs.get(peer_id)
            if addr is None:
                return
            old = self._out.pop(peer_id, None)
            if old is not None:
                try:
                    old.close(linger=0)
                except zmq.ZMQError:
                    pass
            try:
                self._out[peer_id] = self._new_out_socket(addr)
            except zmq.ZMQError as e:    # keep the peer absent; the next
                log.warning("%s: reconnect to %r failed: %s",  # retry or
                            self.device_id, peer_id, e)  # send() reports
                return
        cat = _transport_metrics()
        if cat is not None:
            try:
                cat.TRANSPORT_RECONNECTS.inc()
            except Exception:   # pragma: no cover - defensive
                pass

    def send(self, peer_id: str, tag: str, payload: bytes) -> None:
        """Send with bounded retry: exponential backoff + jitter between
        attempts, and a reconnect after a hard socket error.  An
        unconnected peer fails immediately (config error, not flakiness);
        exhausted retries raise the LAST error — TransportTimeout for a
        blocked HWM (dead/slow peer), TransportError otherwise."""
        cat = _transport_metrics()
        delay = self._retry_backoff
        last_exc: Optional[TransportError] = None
        for attempt in range(self._send_retries + 1):
            if attempt:
                if cat is not None:
                    try:
                        cat.TRANSPORT_SEND_RETRIES.inc()
                    except Exception:   # pragma: no cover - defensive
                        pass
                time.sleep(delay + self._jitter.uniform(0, delay))
                delay *= 2
            # one lock hold for lookup + send: a concurrent close() cannot
            # invalidate the socket between the two
            with self._out_lock:
                sock = self._out.get(peer_id)
                if sock is None:
                    if attempt == 0:
                        raise TransportError(
                            f"{self.device_id}: peer {peer_id!r} not "
                            "connected")
                    # socket lost mid-retry (failed reconnect): fall
                    # through and retry the reconnect below
                    last_exc = last_exc or TransportError(
                        f"{self.device_id}: peer {peer_id!r} vanished")
                    err = "reconnect"
                else:
                    try:
                        sock.send_multipart([tag.encode(), payload])
                        return
                    except zmq.Again:
                        last_exc = TransportTimeout(
                            f"{self.device_id}: send to {peer_id!r} "
                            f"blocked > {self._attempt_timeout_ms} ms "
                            f"x {attempt + 1} attempts (peer dead?)")
                        err = "hwm"      # queue full: the socket is fine,
                    except zmq.ZMQError as e:     # reconnecting would drop
                        last_exc = TransportError(  # the queued messages
                            f"{self.device_id}: send to {peer_id!r} "
                            f"failed: {e}")
                        err = "socket"
            if err in ("socket", "reconnect"):
                self._reconnect(peer_id)
        raise last_exc from None

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        with self._out_lock:
            for sock in self._out.values():
                sock.close(linger=0)
            self._out.clear()
            self._addrs.clear()   # a racing _reconnect finds no address
        self._in.close(linger=0)


class LoopbackNetwork:
    """Shared in-process fabric for LoopbackTransport endpoints."""

    def __init__(self):
        self._endpoints: Dict[str, "LoopbackTransport"] = {}
        self._lock = threading.Lock()

    def register(self, t: "LoopbackTransport") -> None:
        with self._lock:
            self._endpoints[t.device_id] = t

    def deliver(self, peer_id: str, tag: str, payload: bytes) -> None:
        with self._lock:
            target = self._endpoints.get(peer_id)
        if target is None:
            raise TransportError(f"unknown loopback peer {peer_id!r}")
        target._deliver(tag, payload)


class LoopbackTransport(BaseTransport):
    """In-process fake with the ZmqTransport API (tests, single-host runs)."""

    def __init__(self, device_id: str, network: LoopbackNetwork):
        super().__init__(device_id)
        self._net = network
        self.address = f"loopback:{device_id}"
        network.register(self)

    def connect(self, peer_id: str, address: str) -> None:
        pass  # loopback needs no connection setup

    def send(self, peer_id: str, tag: str, payload: bytes) -> None:
        self._net.deliver(peer_id, tag, payload)

    def close(self) -> None:
        pass
