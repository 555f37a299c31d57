"""Elastic pipeline: re-planning, live shard migration, and token-preserving
drain/resume.

Counterpart of ``distributed_inference_demo_tpu/runtime/elastic.py``:

- **Live migration** (the reference's ``ModifySession``): every elastic
  node holds the full parameter tree; ``reassign`` gives every page of
  the old layer range back, drops that range's pool and builds the new
  range's (``models.base.slice_stage`` views, a new pool and paged seam).
- **Re-planning**: on a device failure the header re-splits the layer
  ranges over the surviving chain (``split_layer_ranges``) and pushes
  ``reshard`` control messages over the data-plane transport.  Scale-up
  works identically: hand the header a longer chain.
- **Drain/resume**: the header owns every request's prompt and tokens so
  far, so after a reshard it re-prefills ``prompt ++ generated`` on the
  new pipeline and decoding continues at the same step counter.  The
  tail's sampling stream is per (rid, step), so a greedy continuation is
  the unbroken run's tokens.
- **Failure detection** is a hook: :meth:`ElasticHeader.signal_failure`
  (the heartbeat that would call it lives in the control plane, which is
  not ported); the header's receive loop polls, reshards, and resumes.

Control tags (data tags are runtime/distributed.py's, with a **reshard
epoch** appended, ``h:{rid}:{step}:{epoch}``, so traffic from a slow
pre-reshard worker is dropped instead of being run against a fresh
table):

- ``reshard:{header_id}``       header → worker, JSON plan {spec, next_id,
  epoch} (or {park, epoch})
- ``rack:{device_id}:{epoch}``  worker → header, reshard applied; a
  delayed ack from reshard N never satisfies reshard N+1's wait
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..comm import wire
from ..comm.transport import (BaseTransport, TransportError,
                              TransportTimeout, record_corrupt_frame)
from ..models.base import (ModelConfig, StageParams, StageSpec, slice_stage,
                           split_layer_ranges)
from ..ops.sampling import SamplingParams
from .distributed import (DEFAULT_STEP_TIMEOUT, PipelineHeader,
                          PipelineWorker, StageRuntime, _h_tag, _host,
                          _Request)

log = logging.getLogger(__name__)


class ElasticStageRuntime(StageRuntime):
    """A StageRuntime that can migrate to a different layer range live.

    Holds the full parameter tree; the active stage's params are slice
    views.  ``reassign`` is the reference's ``ModifySession``: every page
    of the old range goes back to its pool, the pool is dropped, and the
    new range gets its own pool and paged seam.  The stage's launch
    counts carry across.  Under a tp ``mesh`` the old range's weights
    and pool are freed on every rank first, and the new range's slices
    are distributed (``StageRuntime._build``)."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec,
                 full_params: StageParams, max_seq: int,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, kv_cache_dtype=None, kv_layout=None,
                 kv_dtype=None, attn_backend: str = "auto", device=None,
                 mesh=None):
        self.full_params = full_params
        super().__init__(cfg, spec, slice_stage(full_params, cfg, spec),
                         max_seq, sampling, seed,
                         kv_cache_dtype=kv_cache_dtype, kv_layout=kv_layout,
                         kv_dtype=kv_dtype, attn_backend=attn_backend,
                         device=device, mesh=mesh)

    def reassign(self, spec: StageSpec) -> None:
        self.reset_caches()
        if (spec.layer_start, spec.layer_end, spec.stage_id,
                spec.num_stages) == (self.spec.layer_start,
                                     self.spec.layer_end, self.spec.stage_id,
                                     self.spec.num_stages):
            return          # topology unchanged: the pages are back
        self._build(spec, slice_stage(self.full_params, self.cfg, spec))


def _spec_payload(spec: StageSpec) -> dict:
    return {"stage_id": spec.stage_id, "num_stages": spec.num_stages,
            "layer_start": spec.layer_start, "layer_end": spec.layer_end}


def _spec_from(p: dict) -> StageSpec:
    return StageSpec(p["stage_id"], p["num_stages"], p["layer_start"],
                     p["layer_end"])


class ElasticWorker(PipelineWorker):
    """PipelineWorker that applies ``reshard`` control messages in-loop and
    speaks epoch-tagged data tags (stale pre-reshard traffic is dropped)."""

    epoch: int = 0

    def _make_h_tag(self, rid: int, step: int) -> str:
        return f"{_h_tag(rid, step)}:{self.epoch}"

    def _make_tok_tag(self, rid: int, step: int) -> str:
        return f"tok:{rid}:{step}:{self.epoch}"

    def handle_message(self, tag: str, payload: bytes) -> bool:
        kind, _, rest = tag.partition(":")
        if kind == "reshard":
            plan = json.loads(payload.decode("utf-8"))
            if plan.get("park"):
                # dropped from the chain but alive: free every cache and
                # stand by as a spare for a future scale-up.
                self.rt.reset_caches()
                self._next_step.clear()
                self.epoch = plan["epoch"]
                self.next_id = None
                self.transport.send(
                    rest, f"rack:{self.transport.device_id}:{self.epoch}",
                    b"")
                log.info("worker %s: parked (epoch %d)",
                         self.transport.device_id, self.epoch)
                return True
            self.rt.reassign(_spec_from(plan["spec"]))
            self._next_step.clear()   # fresh caches: relaunched requests
            self.next_id = plan["next_id"]   # restart at any step
            self.epoch = plan["epoch"]
            self.transport.send(
                rest, f"rack:{self.transport.device_id}:{self.epoch}", b"")
            log.info("worker %s: resharded (epoch %d) to layers [%d,%d) "
                     "of %d stages", self.transport.device_id, self.epoch,
                     self.rt.spec.layer_start, self.rt.spec.layer_end,
                     self.rt.spec.num_stages)
            return True
        if kind == "h":
            fields = rest.split(":")
            if len(fields) > 2 and int(fields[2]) != self.epoch:
                log.info("worker %s: dropping stale epoch-%s chunk %s",
                         self.transport.device_id, fields[2], tag)
                return True
        return super().handle_message(tag, payload)

    def _run_and_forward(self, rid: int, step: int, payload: bytes) -> None:
        try:
            super()._run_and_forward(rid, step, payload)
        except TransportError:
            # next hop died mid-flight; the header's reshard will fix the
            # routing and restart the request — just keep serving.
            log.warning("worker %s: send to %r failed (peer down?)",
                        self.transport.device_id, self.next_id)


class ElasticHeader(PipelineHeader):
    """PipelineHeader that re-plans, migrates, and resumes on failure.

    ``chain`` is the pipeline order of device ids, header first.  Call
    :meth:`signal_failure` (thread-safe — wire it to
    ``DevicePoolManager.on_failure``), :meth:`reshard` directly for
    planned scale-up/down between runs, or :meth:`request_reshard`
    during one.
    """

    def __init__(self, runtime: ElasticStageRuntime, transport: BaseTransport,
                 chain: Sequence[str], eos_id: Optional[int] = None,
                 step_timeout: float = DEFAULT_STEP_TIMEOUT,
                 poll_interval: float = 0.5,
                 layer_costs: Optional[Sequence[float]] = None,
                 stall_reshard_timeout: Optional[float] = None):
        """``stall_reshard_timeout``: in-place recovery — when no token
        has arrived for this long but no failure was signaled (a frame
        lost to corruption/drop, not a dead worker), the header reshards
        over the SAME chain: epoch bump, caches cleared, every in-flight
        request re-prefilled from its collected tokens.  The lost frame
        is effectively retransmitted and greedy output is unchanged
        (drain/resume exactness).  Default ``step_timeout / 4``; 0/None
        disables (then a lost frame rides the full step_timeout to the
        stall postmortem)."""
        if list(chain)[0] != transport.device_id:
            raise ValueError("chain must start with the header's device id")
        if len(chain) < 2:
            raise ValueError("elastic pipeline needs at least 2 devices")
        super().__init__(runtime, transport, next_id=list(chain)[1],
                         eos_id=eos_id, step_timeout=step_timeout)
        self.chain: List[str] = list(chain)
        self.poll_interval = poll_interval
        self.layer_costs = list(layer_costs) if layer_costs else None
        self.stall_reshard_timeout = (
            step_timeout / 4 if stall_reshard_timeout is None
            else (stall_reshard_timeout or None))
        self.epoch = 0
        self._failed: List[str] = []
        self._failed_lock = threading.Lock()
        self._planned: Optional[List[str]] = None

    def _make_h_tag(self, rid: int, step: int) -> str:
        return f"{_h_tag(rid, step)}:{self.epoch}"

    # -- failure intake ----------------------------------------------------

    def signal_failure(self, device_id: str) -> None:
        """Thread-safe: mark a device dead; the run loop reshards at its
        next poll.  Hook for ``DevicePoolManager.on_failure``."""
        self.flight.record("device_failure", device=device_id,
                           stage=self.transport.device_id)
        with self._failed_lock:
            if device_id not in self._failed:
                self._failed.append(device_id)

    def _take_failures(self) -> List[str]:
        with self._failed_lock:
            failed, self._failed = self._failed, []
            return [d for d in failed if d in self.chain]

    def request_reshard(self, chain: Sequence[str]) -> None:
        """Thread-safe planned scale-down or scale-up under load (port
        addition): the run loop reshards over ``chain`` at its next poll,
        in-flight requests drained and resumed, live workers dropped from
        the chain parked.  Outside a run, call :meth:`reshard`."""
        with self._failed_lock:
            self._planned = list(chain)

    def _take_planned(self) -> Optional[List[str]]:
        with self._failed_lock:
            planned, self._planned = self._planned, None
            return planned

    # -- re-planning + migration ------------------------------------------

    def reshard(self, chain: Sequence[str],
                in_flight: Optional[Dict[int, "_Request"]] = None,
                dead: Sequence[str] = ()) -> None:
        """Re-split layers over ``chain``, push the plan, resume requests.

        ``chain`` must start with the header and contain only live workers
        (longer than before for scale-up, shorter after failures or planned
        scale-down).  ``dead`` lists devices known unreachable — live
        workers dropped from the chain but not in ``dead`` are **parked**:
        told to free their caches and stand by as spares.
        """
        chain = list(chain)
        if chain[0] != self.transport.device_id:
            raise ValueError("chain must start with the header")
        if len(chain) < 2:
            raise RuntimeError(
                "pipeline no longer has enough devices (need >= 2)")
        costs = self.layer_costs
        specs = split_layer_ranges(self.rt.cfg.num_layers, len(chain), costs)
        self.epoch += 1
        log.info("reshard (epoch %d): %s -> ranges %s", self.epoch, chain,
                 [(s.layer_start, s.layer_end) for s in specs])
        self.flight.record("reshard", epoch=self.epoch, chain=list(chain),
                           dead=list(dead))

        # push plans to workers (everyone but us), then collect acks;
        # stray data messages racing the reshard are dropped (their caches
        # are invalid anyway — requests restart below).
        parked = [d for d in self.chain[1:]
                  if d not in chain and d not in dead]
        expected_acks = set(chain[1:]) | set(parked)
        for i, dev in enumerate(chain[1:], start=1):
            nxt = chain[i + 1] if i + 1 < len(chain) else None
            plan = {"spec": _spec_payload(specs[i]), "next_id": nxt,
                    "epoch": self.epoch}
            self.transport.send(
                dev, f"reshard:{self.transport.device_id}",
                json.dumps(plan).encode("utf-8"))
        for dev in parked:      # live but out of the chain: free + stand by
            plan = {"park": True, "epoch": self.epoch}
            self.transport.send(
                dev, f"reshard:{self.transport.device_id}",
                json.dumps(plan).encode("utf-8"))
        deadline = time.monotonic() + self.step_timeout
        while expected_acks:
            # a worker that dies MID-RESHARD must not cost the full ack
            # deadline: a failure signal for a pending acker aborts this
            # reshard now (the signal stays queued — the run loop's next
            # poll reshards again without the dead device)
            with self._failed_lock:
                dead_waiters = sorted(d for d in self._failed
                                      if d in expected_acks)
            if dead_waiters:
                raise TransportTimeout(
                    f"reshard (epoch {self.epoch}) aborted: "
                    f"{dead_waiters} failed mid-reshard")
            left = deadline - time.monotonic()
            if left <= 0:
                raise TransportTimeout(
                    f"reshard acks missing from {sorted(expected_acks)}")
            try:
                # sliced waits so the dead-waiter check above runs even
                # while nothing arrives
                tag, _ = self.transport.recv_any(timeout=min(left, 0.5))
            except TransportTimeout:
                continue  # deadline check above raises the informative error
            kind, _, rest = tag.partition(":")
            if kind == "rack":
                # rpartition: device ids may themselves contain ':'
                dev, _, ep = rest.rpartition(":")
                # epoch-checked: a delayed ack from a previous reshard must
                # not satisfy this one's ack-wait.
                if dev and ep.isdigit() and int(ep) == self.epoch:
                    expected_acks.discard(dev)
            # anything else is pre-reshard traffic: drop.

        self.rt.reassign(specs[0])
        self.chain = chain
        self.next_id = chain[1]

        # drain/resume: restart every in-flight request from its collected
        # tokens (reload_sampleId semantics, done per-token not per-sample).
        if in_flight:
            for req in in_flight.values():
                self._relaunch(req)

    def _relaunch(self, req: _Request) -> None:
        """Re-prefill prompt ++ generated-so-far; decoding continues at the
        same step index (the tail's (rid, step) stream is unchanged)."""
        ids = req.prompt.astype(np.int32)
        if req.tokens:
            gen = np.stack(req.tokens, axis=1).astype(np.int32)
            ids = np.concatenate([ids, gen], axis=1)
        hidden = _host(self.stats, self.rt.run_chunk(req.rid, ids))
        self.transport.send(
            self.next_id, self._make_h_tag(req.rid, req.step),
            wire.serialize_tensors_traced([hidden], req.trace_id or None))

    # -- the elastic run loop ----------------------------------------------

    def generate_many(self, prompts: Sequence[np.ndarray],
                      max_new_tokens: int,
                      pool_size: int = 1,
                      on_token=None) -> List[np.ndarray]:
        pending = self._make_requests(prompts, max_new_tokens)
        rid_to_index = {req.rid: i for i, req in enumerate(pending)}
        queue = list(pending)
        in_flight: Dict[int, _Request] = {}
        # last_progress: real token progress only (bounds the final
        # give-up); last_recovery additionally resets on every recovery
        # attempt (paces the in-place stall reshards)
        last_progress = last_recovery = time.monotonic()
        # cumulative: _take_failures consumes each signal, but a reshard
        # aborted by a cascading failure leaves the earlier dead device
        # in self.chain — the retry must still exclude it
        dead_seen: set = set()

        while queue or in_flight:
            failed = self._take_failures()
            if failed:
                dead_seen.update(failed)
                alive = [d for d in self.chain if d not in dead_seen]
                try:
                    self.reshard(alive, in_flight,
                                 dead=[d for d in self.chain
                                       if d in dead_seen])
                    last_progress = last_recovery = time.monotonic()
                except TransportTimeout:
                    # a SECOND device died mid-reshard (the ack-wait
                    # aborted early on its failure signal, or its acks
                    # never came): its signal is queued, so the next
                    # poll reshards again without it — a cascading
                    # failure must not kill a run that survivors could
                    # finish.  The no-progress watchdog stays the
                    # backstop if reshards keep failing.
                    log.warning("header: reshard after %s failed "
                                "(another device down mid-reshard?); "
                                "retrying on the next failure signal",
                                failed)
                    last_recovery = time.monotonic()

            planned = self._take_planned()
            if planned is not None:
                self.reshard([d for d in planned if d not in dead_seen],
                             in_flight)
                last_progress = last_recovery = time.monotonic()

            while queue and len(in_flight) < pool_size:
                req = queue.pop(0)
                in_flight[req.rid] = req
                try:
                    self._launch(req)
                except TransportError:
                    # first hop unreachable: hold the request in flight;
                    # the failure signal will reshard and relaunch it.
                    log.warning("header: launch of rid=%d failed "
                                "(next hop down?)", req.rid)

            try:
                tag, payload = self.transport.recv_any(
                    timeout=self.poll_interval)
            except TransportTimeout:
                now = time.monotonic()
                if now - last_progress > self.step_timeout:
                    # reshard couldn't save this run: black-box it like
                    # the static header's step timeout
                    self._stall_postmortem("generate")
                    raise TransportTimeout(
                        f"no progress for {self.step_timeout}s and no "
                        "failure signal; pipeline stalled")
                if (self.stall_reshard_timeout and in_flight
                        and now - last_recovery
                        > self.stall_reshard_timeout):
                    # a frame was lost (dropped/corrupt) but nobody died:
                    # reshard IN PLACE — epoch bump + drain/resume acts
                    # as the retransmit
                    self.flight.record(
                        "stall_reshard", stage=self.transport.device_id,
                        idle_s=round(now - last_progress, 3),
                        epoch=self.epoch)
                    log.warning(
                        "header: no progress for %.1fs with no failure "
                        "signal; resharding in place (epoch %d -> %d)",
                        now - last_progress, self.epoch, self.epoch + 1)
                    try:
                        # over the live chain: a device from an earlier
                        # ABORTED failure-reshard must stay excluded
                        self.reshard([d for d in self.chain
                                      if d not in dead_seen], in_flight,
                                     dead=[d for d in self.chain
                                           if d in dead_seen])
                    except TransportTimeout:
                        # a worker IS dead (acks missing / aborted by a
                        # failure signal): the signal-driven reshard at
                        # the top of the loop finishes the job
                        log.warning("header: in-place reshard failed; "
                                    "awaiting failure signal")
                    last_recovery = time.monotonic()
                continue

            kind, _, rest = tag.partition(":")
            if kind != "tok":
                continue       # stray acks / stale traffic
            fields = rest.split(":")
            rid, step = int(fields[0]), int(fields[1])
            if len(fields) > 2 and int(fields[2]) != self.epoch:
                continue       # pre-reshard token from a stale worker
            req = in_flight.get(rid)
            if req is None or step != req.step:
                continue       # duplicate or out-of-order token
            self.flight.record("tok_recv",
                               stage=self.transport.device_id,
                               rid=rid, step=step)
            try:
                [toks] = wire.split_trace_context(
                    wire.deserialize_tensors(payload))[0]
            except wire.WireIntegrityError as e:
                # dropped, counted, flight-recorded; the request's step
                # stays pending and the no-progress watchdog (or a
                # failure signal) reshards — never a garbage token
                record_corrupt_frame(self.transport.device_id, tag,
                                     len(payload), e)
                continue
            if on_token is not None:
                on_token(rid_to_index[rid], step, toks)
            try:
                self._advance(req, toks)
            except TransportError:
                # token is recorded; the follow-up send failed — the
                # failure signal will reshard and relaunch from tokens.
                log.warning("header: advance send for rid=%d failed "
                            "(next hop down?)", rid)
            last_progress = last_recovery = time.monotonic()
            if req.done:
                del in_flight[rid]

        return [np.stack(r.tokens, axis=1) for r in pending]
