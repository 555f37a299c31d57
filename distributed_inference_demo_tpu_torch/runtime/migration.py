"""Live KV migration between decode replicas (docs/DESIGN.md §18).

Disaggregation (``runtime/disagg.py``) moves a request exactly once, at
admission time: the prefill worker streams ``pg:`` page frames and the
decode worker joins the request before its first token.  This module moves a request
that is ALREADY DECODING — the rebalance/drain/defragment primitive: a
hot replica sheds mid-flight work to a light one, a draining replica
empties itself without waiting out its longest request, and the freed
source pages return to the pool in one release (defragmenting it).

Two-phase protocol over the §12 transport, reusing the §15 page codec
(CRC, (rid, attempt, seq) dedup, go-back-n retransmit) unchanged:

- **Phase 1 — bulk checkpoint.**  The source snapshots the row between
  two steps (``ContinuousBatchingEngine.export_request``: used KV pages
  verbatim, emitted tokens/logprobs, the sampler rng key, length/budget
  counters, kv_dtype tag) and streams the pages as ``pg:`` frames plus
  an ``rs:`` state frame, while the row KEEPS DECODING.  The target
  stages everything on the HOST (zero pool pages held — crash cleanup
  is structural, the §15 property) and acks.
- **Phase 2 — atomic handoff.**  On the ack the source re-exports with
  ``detach=True`` — the freeze point: the row decoded up to some step
  T' and never steps again — and ships only the DELTA blocks (the
  partial tail block re-ships) plus an ``rsd:`` frame carrying the
  final state.  The target adopts the checkpoint
  (``import_request`` → the §11 ``adopt_blocks_into_pages`` +
  ``store_shared`` join: prompt blocks tree-owned, generated blocks
  request-private, decode-side h2d stays 0) and resumes AT T' exactly.
  The relayed stream dedups by the existing ``(rid, step)`` rule — at
  most the one in-flight step replays, and no step can be skipped: the
  target's first token is step T', the source's last was T' - 1.

The client-visible stream never breaks: the source keeps the original
``Request`` object (stream open, ``done`` unset) and feeds it from the
target's ``tok:`` frames; ``fin:`` carries the authoritative token list
(late/dropped relay frames reconcile there).  If phase 2 cannot be
acked, the source re-imports its own detached checkpoint locally — the
request continues where it froze and the target's staging is aborted
(``pgx:``).  If the SOURCE dies after phase 1, the target can
``promote_staged``: resume from the bulk checkpoint at step T — steps
the source emitted in (T, T'] replay and dedup downstream; none skip.

Frame tags (extends the §15 table; rids must not contain ``:``):

    pg:{rid}:{attempt}:{n}  source → target   page payload (§15 codec)
    rs:{rid}:{attempt}      source → target   phase-1 state manifest
    pga:{rid}:{attempt}     target → source   phase-1 ack (status, expected)
    rsd:{rid}:{attempt}     source → target   phase-2 handoff (delta manifest
                                              + final state)
    rsa:{rid}:{attempt}     target → source   phase-2 ack (status, expected)
    pgx:{rid}               source → target   abort a staged migration
    mcx:{rid}               source → target   cancel a handed-off request
    tok:{rid}:{i}           target → source   one relayed token
    fin:{rid}               target → source   final tokens / error

:class:`MigrationController` is the policy layer: driven by the gateway
registry's load view it picks hot-source → light-target rebalances and
drives a ``draining`` replica empty (ROADMAP's scale-down primitive).
The mechanism (``mover``) is injected — in-process deployments call the
replicas' :meth:`MigrationWorker.migrate_out` directly.

Counterpart of ``distributed_inference_demo_tpu/runtime/migration.py``,
frame for frame, over the port's checkpoints: host page payloads are
CPU tensors (``disagg`` puts them on the wire), and the sampler state a
checkpoint carries is the engine's ``torch.Generator`` state, shipped
as its bytes where the reference ships its rng key words.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comm import wire
from ..comm.transport import (TransportError, TransportTimeout,
                              record_corrupt_frame)
from ..telemetry import profiling as _profiling
from ..telemetry._env import env_float, env_int
from ..telemetry.flightrecorder import get_flight_recorder
from ..telemetry.tracing import SpanClock, TraceRecorder, new_trace_id
from .disagg import (_meta_frame, _page_frame, _parse_meta_frame,
                     MigrationError, PageStager)

log = logging.getLogger(__name__)

# live-migration knobs (docs/DESIGN.md §18 table)
DEFAULT_ACK_TIMEOUT_S = env_float("DWT_MIGRATION_ACK_TIMEOUT_S", 2.0)
DEFAULT_RETRIES = env_int("DWT_MIGRATION_RETRIES", 5)
DEFAULT_PAGE_FRAME_BLOCKS = env_int("DWT_MIGRATION_FRAME_BLOCKS", 4)


def _migration_metrics():
    """The dwt_migration_* series, resolved lazily and never fatally (a
    metrics regression must not take down the data plane) — the
    transport's pattern."""
    try:
        from ..telemetry import catalog
        return catalog
    except Exception:           # pragma: no cover - defensive
        return None


def _state_tensors(ckpt: dict):
    """The rs:/rsd: frames' data tensors: prompt, emitted tokens,
    logprobs, the generator's state bytes (empty when the checkpoint
    carries none; the reference ships its rng key words here)."""
    rng = ckpt.get("rng")
    return (np.asarray(ckpt["prompt"], np.int32),
            np.asarray(ckpt["tokens"], np.int32),
            np.asarray(ckpt["lps"], np.float32),
            np.zeros(0, np.uint8) if rng is None
            else torch.as_tensor(rng).numpy().astype(np.uint8))


def _state_meta(ckpt: dict, *, rid: str, attempt: int, n_frames: int,
                n_blocks: int, source_id: str, reply_to: str) -> dict:
    return {"rid": rid, "attempt": attempt, "n_frames": n_frames,
            "n_blocks": n_blocks, "max_new": int(ckpt["max_new"]),
            "length": int(ckpt["length"]),
            "last_tok": int(ckpt["last_tok"]),
            "kv_dtype": ckpt["kv_dtype"],
            "block_tokens": int(ckpt["block_tokens"]),
            "source_id": source_id, "reply_to": reply_to,
            # observability identity (docs/DESIGN.md §7): the manifest is
            # all the target sees, so tenant/trace must ride it or the
            # adopted request would lose its attribution mid-fleet
            "tenant": ckpt.get("tenant", "default"),
            "trace_id": int(ckpt.get("trace_id") or 0),
            "t_submit_wall": float(ckpt.get("t_submit_wall") or 0.0),
            "migration_pause": float(ckpt.get("migration_pause") or 0.0),
            # §22 verify-boundary freeze: adaptive-K state rides the
            # manifest (scalars); draft scratch / n-gram history do NOT
            # ship — the importer rebuilds them from prompt + tokens
            "spec_k": int(ckpt.get("spec_k") or 0),
            "spec_ewma": float(ckpt.get("spec_ewma") or 0.0)}


def _ckpt_from_staged(stager: PageStager, st: dict, meta: dict) -> dict:
    """Rebuild an ``import_request`` checkpoint from a staged frame set
    + a state manifest (rs or rsd).  Frames apply in seq order at their
    ``first_block`` offsets, so a phase-2 delta OVERWRITES the partial
    tail block phase 1 shipped."""
    prompt, tokens, lps, rng = st["state_tensors"]
    k_blocks, v_blocks = stager.concat_blocks(st, int(meta["n_blocks"]))
    return {"rid": meta["rid"],
            "prompt": np.asarray(prompt, np.int32),
            "max_new": int(meta["max_new"]),
            "tokens": [int(t) for t in tokens],
            "lps": [float(x) for x in lps],
            "length": int(meta["length"]),
            "last_tok": int(meta["last_tok"]),
            "kv_dtype": meta.get("kv_dtype", st["kv_dtype"]),
            "block_tokens": int(meta["block_tokens"]),
            "tenant": meta.get("tenant", "default"),
            "trace_id": int(meta.get("trace_id") or 0),
            "t_submit_wall": float(meta.get("t_submit_wall") or 0.0),
            "migration_pause": float(meta.get("migration_pause") or 0.0),
            "spec_k": int(meta.get("spec_k") or 0),
            "spec_ewma": float(meta.get("spec_ewma") or 0.0),
            "k": k_blocks, "v": v_blocks,
            "rng": (torch.from_numpy(np.asarray(rng, np.uint8).copy())
                    if len(rng) else None)}


class MigrationWorker:
    """One decode replica's live-migration endpoint — BOTH roles: the
    source (:meth:`migrate_out`) and the target (frame handlers +
    :meth:`import_request` adoption + token relay back).

    Sits beside a :class:`ContinuousBatchingEngine` and a §12 transport;
    in the worker roles it co-serves on the DecodeWorker's loop (the
    ``migration=`` co-handler seam), in-process it gets its own
    :meth:`serve_forever` thread."""

    def __init__(self, engine, transport,
                 ack_timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 page_frame_blocks: Optional[int] = None,
                 stager: Optional[PageStager] = None):
        self.engine = engine
        self.transport = transport
        self.device_id = transport.device_id
        self.ack_timeout = (DEFAULT_ACK_TIMEOUT_S if ack_timeout is None
                            else float(ack_timeout))
        self.retries = (DEFAULT_RETRIES if retries is None
                        else int(retries))
        self.page_frame_blocks = max(1, int(
            DEFAULT_PAGE_FRAME_BLOCKS if page_frame_blocks is None
            else page_frame_blocks))
        self.tracer = TraceRecorder(f"migration:{self.device_id}")
        # replica /trace drains the ENGINE's recorder: register ours so
        # the export (and the gateway's /trace/fleet stitch) carries
        # migration spans on the same page as prefill/decode spans
        reg = getattr(engine, "register_aux_tracer", None)
        if callable(reg):
            reg(self.tracer)
        # target side: (rid, attempt) page staging (host-only; zero pool
        # pages) — pass the DecodeWorker's stager to co-serve one
        # transport with the §15 admission join
        self.stager = stager or PageStager(
            self.device_id, on_evict=self._evicted)
        # rid -> attempt that was adopted (imported + decoding here):
        # re-ack + duplicate suppression, BOUNDED like
        # DecodeWorker._joined
        self._adopted: "OrderedDict[str, int]" = OrderedDict()
        # rid -> adopted Request (cancel forwarding + drain bookkeeping)
        self._imported: Dict[str, object] = {}
        # source side: rid -> (original Request, target_id) being relayed
        self._relays: Dict[str, tuple] = {}
        self._attempts: Dict[str, int] = {}
        self.stats = {"migrated_out": 0, "migrated_in": 0,
                      "failed_migrations": 0, "aborted_migrations": 0,
                      "replayed_steps": 0, "moved_pages": 0,
                      "moved_bytes": 0, "promoted_requests": 0,
                      "healed_requests": 0, "last_migration_ms": None}
        # acks the serve loop's recv_any consumed on behalf of a
        # concurrent migrate_out (same transport, two threads): the
        # migrating thread waits here FIRST, then on the transport
        self._ack_stash: Dict[str, list] = {}
        self._ack_cv = threading.Condition()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._flight = get_flight_recorder()

    _MARK_CAP = 4096

    @property
    def staged_bytes(self) -> int:
        return self.stager.staged_bytes

    def _evicted(self, rid: str) -> None:
        self.stats["aborted_migrations"] += 1

    # -- serve loop (in-process deployments; worker roles co-serve on
    # the DecodeWorker loop) ----------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def serve_forever(self, idle_timeout: Optional[float] = None) -> None:
        idle_since = time.monotonic()
        while not self._stop.is_set():
            try:
                tag, payload = self.transport.recv_any(timeout=0.1)
            except TransportTimeout:
                if (idle_timeout is not None
                        and time.monotonic() - idle_since > idle_timeout):
                    return
                continue
            idle_since = time.monotonic()
            try:
                self.handle_message(tag, payload)
            except Exception:
                # one malformed frame must not take the replica (and
                # every future migration) down with it
                log.exception("%s: migration frame %r failed",
                              self.device_id, tag)

    # -- message handling --------------------------------------------------

    def handle_message(self, tag: str, payload: bytes) -> bool:
        """Dispatch one inbound frame; returns True when the tag was a
        live-migration frame this worker owns (co-handler seam)."""
        parts = tag.split(":")
        kind = parts[0]
        if kind == "pg":
            self._on_page(parts[1], int(parts[2]), int(parts[3]),
                          payload, tag)
        elif kind == "rs":
            self._on_state(parts[1], int(parts[2]), payload, tag)
        elif kind == "rsd":
            self._on_handoff(parts[1], int(parts[2]), payload, tag)
        elif kind == "pgx":
            self._on_abort(parts[1])
        elif kind == "mcx":
            self._on_cancel(parts[1])
        elif kind == "tok":
            self._on_tok(parts[1], int(parts[2]), payload)
        elif kind == "fin":
            self._on_fin(parts[1], payload)
        elif kind in ("pga", "rsa"):
            with self._ack_cv:
                self._ack_stash.setdefault(tag, []).append(payload)
                self._ack_cv.notify_all()
        else:
            return False
        return True

    def _drop(self, tag: str, why: str) -> None:
        self._flight.record("migration_frame_dropped", tag=tag, why=why)

    def _mark_adopted(self, rid: str, attempt: int) -> None:
        self._adopted[rid] = max(attempt, self._adopted.get(rid, 0))
        self._adopted.move_to_end(rid)
        while len(self._adopted) > self._MARK_CAP:
            self._adopted.popitem(last=False)

    def _is_adopted(self, rid: str, attempt: int) -> bool:
        """True when ``attempt`` was already resolved here.  The gate is
        attempt-AWARE, not rid-keyed: a request can legally migrate
        away and bounce back later under a HIGHER attempt (the importer
        seeds its own counter from the adopted attempt, so attempts
        increase along the whole migration chain), and that newer
        attempt must stage fresh."""
        return attempt <= self._adopted.get(rid, 0)

    def _ack(self, peer: str, tag: str, complete: bool,
             expected: int) -> None:
        body = wire.serialize_tensors(
            [np.asarray([0 if complete else 1, expected], np.int32)])
        try:
            self.transport.send(peer, tag, body)
        except TransportError:
            pass                 # sender timeout/retry path recovers

    # -- target: staging ---------------------------------------------------

    def _on_page(self, rid: str, attempt: int, seq: int, payload: bytes,
                 tag: str) -> None:
        if self._is_adopted(rid, attempt):
            self._drop(tag, "already_adopted")
            return
        status = self.stager.stage_page(rid, attempt, seq, payload, tag)
        # staged frames are the migration path's only host-buffer growth:
        # feed the §20 watermark ledger here (peaks are what it keeps)
        _profiling.get_hbm_watermarks().sample(
            "migration_staged", self.stager.staged_bytes)
        if status in ("stale_attempt", "dedup"):
            self._drop(tag, status)

    def _on_state(self, rid: str, attempt: int, payload: bytes,
                  tag: str) -> None:
        """Phase-1 manifest: validate the staged frame set, stash the
        request state, ack.  NOTHING imports here — the row is still
        decoding on the source; staging stays host-only."""
        try:
            meta, tensors, ctx = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, tag, len(payload), e)
            return
        source = meta.get("source_id", "")
        ack_tag = f"pga:{rid}:{attempt}"
        if self._is_adopted(rid, attempt):
            self._ack(source, ack_tag, True, 0)
            return
        st = self.stager.staging(rid, attempt)
        if st is None:
            self._drop(tag, "stale_attempt")
            return
        if st["expected"] < int(meta["n_frames"]):
            self._ack(source, ack_tag, False, st["expected"])
            return
        st["state_meta"] = meta
        st["state_tensors"] = tensors
        st["ctx"] = ctx
        self._flight.record("migration_staged", rid=rid, attempt=attempt,
                            frames=st["expected"], bytes=st["bytes"])
        self._ack(source, ack_tag, True, st["expected"])

    def _on_handoff(self, rid: str, attempt: int, payload: bytes,
                    tag: str) -> None:
        """Phase-2 handoff: the source froze the row at its final state;
        adopt the complete checkpoint and resume decoding HERE."""
        try:
            meta, tensors, ctx = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, tag, len(payload), e)
            return
        source = meta.get("source_id", "")
        ack_tag = f"rsa:{rid}:{attempt}"
        # the same lock promote_staged holds across its staging check +
        # adopt: a delayed rsd frame racing an operator/policy promote
        # must not both pass the adopted gate and double-import one
        # (rid, attempt) into two engine slots
        with self._lock:
            if self._is_adopted(rid, attempt):
                # retransmitted handoff for a request already decoding
                # here: idempotent re-ack, never a second import
                self._ack(source, ack_tag, True, 0)
                return
            st = self.stager.staging(rid, attempt)
            if st is None:
                self._drop(tag, "stale_attempt")
                return
            if st["expected"] < int(meta["n_frames"]):
                self._ack(source, ack_tag, False, st["expected"])
                return
            st["state_meta"] = meta
            st["state_tensors"] = tensors
            self._adopt(rid, attempt, st, meta, ctx, source, ack_tag)

    def _adopt(self, rid: str, attempt: int, st: dict, meta: dict, ctx,
               source: str, ack_tag: Optional[str]) -> Optional[object]:
        try:
            ckpt = _ckpt_from_staged(self.stager, st, meta)
            req = self.engine.import_request(ckpt)
        except Exception as e:
            # an admission rejection (capacity, dtype mismatch) is a
            # per-REQUEST failure, never a dead replica: ack complete
            # (retransmitting cannot fix admission) and surface the
            # error through the fin path so the source unblocks the
            # client with a terminal error instead of a hang
            self.stager.clear(rid)
            # the aborted marker lives in the SHARED stager: when a
            # DecodeWorker co-serves this transport, a late retransmit
            # of this attempt must drop no matter whose _on_page sees it
            self.stager.mark_aborted(rid, attempt)
            self._mark_adopted(rid, attempt)
            self.stats["failed_migrations"] += 1
            self._flight.record("migration_adopt_rejected", rid=rid,
                                error=type(e).__name__, detail=str(e))
            if ack_tag is not None:
                self._ack(source, ack_tag, True, st["expected"])
            try:
                self.transport.send(
                    meta["reply_to"], f"fin:{rid}",
                    _meta_frame({"rid": rid, "ok": False,
                                 "error": f"{type(e).__name__}: {e}"},
                                (np.zeros(0, np.int32),)))
            except TransportError:
                pass
            return None
        n_blocks = int(meta["n_blocks"])
        dt = time.perf_counter() - st["t0"]
        self._mark_adopted(rid, attempt)
        self._imported[rid] = req
        self.stager.clear(rid)
        # shared-stager gate (see the rejection path): a co-serving
        # DecodeWorker must not re-stage late frames of this attempt
        self.stager.mark_aborted(rid, attempt)
        # chain the attempt counter: if THIS replica later re-exports
        # the request (bounce migration), its attempt must exceed every
        # attempt any replica has already seen for this rid
        self._attempts[rid] = max(self._attempts.get(rid, 0), attempt)
        self.stats["migrated_in"] += 1
        self.stats["moved_pages"] += n_blocks
        self.stats["last_migration_ms"] = round(dt * 1e3, 3)
        cat = _migration_metrics()
        if cat is not None:
            try:
                cat.MIGRATION_IMPORTED.inc()
                cat.MIGRATION_HANDOFF_SECONDS.observe(dt)
            except Exception:            # pragma: no cover - defensive
                pass
        if ctx is not None:
            self.tracer.record("migration_adopt", ctx[0], ctx[1],
                               ts=time.time() - dt, dur=dt, rid=rid,
                               blocks=n_blocks)
        self._flight.record("migration_adopt", rid=rid, attempt=attempt,
                            blocks=n_blocks,
                            resumed_at=len(req.tokens))
        if ack_tag is not None:
            self._ack(source, ack_tag, True, st["expected"])
        t = threading.Thread(
            target=self._relay_out,
            args=(req, rid, meta["reply_to"], len(req.tokens)),
            daemon=True, name=f"migration-relay-{rid}")
        t.start()
        return req

    def promote_staged(self, rid: str) -> Optional[object]:
        """Resume a phase-1-complete staged checkpoint whose SOURCE died
        before the handoff: adopt it at step T (the bulk snapshot) and
        stream to the manifest's ``reply_to``.  Steps the dead source
        emitted after T replay and dedup at the collector ((rid, step));
        none skip.  Returns the resumed Request, or None when nothing
        promotable is staged."""
        with self._lock:
            st = self.stager._staged.get(rid)
            if st is None or st["state_meta"] is None:
                return None
            meta = st["state_meta"]
            if st["expected"] < int(meta["n_frames"]):
                return None
            self.stats["promoted_requests"] += 1
            self._flight.record("migration_promote", rid=rid,
                                attempt=st["attempt"])
            return self._adopt(rid, st["attempt"], st, meta,
                               st.get("ctx"), meta.get("source_id", ""),
                               None)

    def _on_abort(self, rid: str) -> None:
        """Abort a staged migration: host buffers AND their byte
        accounting clear, and the attempt marker ensures late frames of
        the aborted attempt drop instead of restaging a leak."""
        st = self.stager._staged.get(rid)
        if st is None or self._is_adopted(rid, st["attempt"]):
            return               # nothing staged, or too late: adopted
        st = self.stager.clear(rid)
        if st is not None:
            self.stager.mark_aborted(rid, st["attempt"])
            self.stats["aborted_migrations"] += 1
            cat = _migration_metrics()
            if cat is not None:
                try:
                    cat.MIGRATION_ABORTED.inc()
                except Exception:        # pragma: no cover - defensive
                    pass
            self._flight.record("migration_abort", rid=rid,
                                attempt=st["attempt"])

    def _on_cancel(self, rid: str) -> None:
        """The source relayed a client cancel for a handed-off request:
        cancel it here — the engine sweep frees its slot/pages and the
        relay's fin reports the clean termination back."""
        req = self._imported.get(rid)
        if req is not None:
            req.cancel()
            self._flight.record("migration_cancel_forwarded", rid=rid)

    def _relay_out(self, req, rid: str, reply_to: str,
                   start_idx: int) -> None:
        """Forward an adopted request's NEW tokens to the source (its
        own thread, like the §15 drain).  ``start_idx`` continues the
        source's numbering — the stream only yields tokens decoded
        here, so index i on the wire is always absolute step i."""
        idx = start_idx
        while True:
            item = req.stream.get()
            if item is None:
                break
            try:
                self.transport.send(reply_to, f"tok:{rid}:{idx}",
                                    wire.serialize_token(int(item)))
            except TransportError:
                pass             # fin carries the authoritative tokens
            idx += 1
        self._imported.pop(rid, None)
        err = req.error
        meta = {"rid": rid,
                "ok": err is None and not req.cancelled,
                "cancelled": bool(req.cancelled),
                "error": None if err is None else
                f"{type(err).__name__}: {err}"}
        body = _meta_frame(meta, (np.asarray(req.tokens, np.int32),))
        try:
            self.transport.send(reply_to, f"fin:{rid}", body)
        except TransportError:
            pass

    # -- source: relay consumption ----------------------------------------

    @staticmethod
    def _end_pause(req) -> None:
        """Close the freeze→resume gap the detaching export opened: the
        accumulated pause is the timeline ledger's migration_pause field
        (first relayed/healed token, or fin, whichever lands first)."""
        t0 = getattr(req, "_pause_t0", None)
        if t0 is not None:
            req.migration_pause += time.perf_counter() - t0
            req._pause_t0 = None

    def _on_tok(self, rid: str, idx: int, payload: bytes) -> None:
        ent = self._relays.get(rid)
        if ent is None:
            return
        req, target = ent
        if req.cancelled:
            # forward the client's cancel to the replica that now owns
            # the row; its fin terminates the stream cleanly
            try:
                self.transport.send(target, f"mcx:{rid}",
                                    _meta_frame({"rid": rid}))
            except TransportError:
                pass
        try:
            tok = wire.deserialize_token(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, f"tok:{rid}", len(payload),
                                 e)
            return
        # the (rid, step) dedup: exactly the §15 collector rule — the
        # one replayed boundary step appends nowhere, a skipped step is
        # structurally impossible (idx == len(tokens) or it drops)
        if idx == len(req.tokens):
            self._end_pause(req)
            req.tokens.append(tok)
            req.stream.put(tok)
        elif idx < len(req.tokens):
            self.stats["replayed_steps"] += 1
            cat = _migration_metrics()
            if cat is not None:
                try:
                    cat.MIGRATION_REPLAYED.inc()
                except Exception:        # pragma: no cover - defensive
                    pass

    def _on_fin(self, rid: str, payload: bytes) -> None:
        ent = self._relays.pop(rid, None)
        if ent is None:
            return
        req, _target = ent
        try:
            meta, tensors, _ = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, f"fin:{rid}",
                                 len(payload), e)
            req.error = MigrationError(
                f"relay fin for {rid!r} was corrupt")
            self._end_pause(req)
            req.stream.put(None)
            req.done.set()
            try:
                self.engine._close_timeline(req, error="MigrationError")
            except Exception:        # pragma: no cover - defensive
                pass
            return
        if meta.get("ok"):
            # the authoritative token list reconciles any relay frames
            # the wire lost (fin rides the reliable send-retry path)
            final = [int(t) for t in tensors[0]]
            for tok in final[len(req.tokens):]:
                self._end_pause(req)
                req.tokens.append(tok)
                req.stream.put(tok)
        elif not meta.get("cancelled"):
            req.error = MigrationError(
                meta.get("error") or f"migrated request {rid!r} failed "
                "on the target replica")
        self._end_pause(req)
        req.t_done = time.perf_counter()
        req.stream.put(None)
        req.done.set()
        self._flight.record("migration_relay_done", rid=rid,
                            ok=bool(meta.get("ok")),
                            tokens=len(req.tokens))
        # the SOURCE closes the user-visible timeline: it held the
        # client connection across the handoff, so its clocks cover the
        # whole request (pause included) — the target never closes one
        try:
            self.engine._close_timeline(
                req, error=(None if meta.get("ok") else
                            ("cancelled" if meta.get("cancelled")
                             else "MigrationError")))
        except Exception:            # pragma: no cover - defensive
            pass

    # -- source: migrate out ----------------------------------------------

    def pick_migratable(self, n: int, min_remaining: int = 2) -> List[str]:
        """Up to ``n`` rids worth moving: actively decoding here, with
        at least ``min_remaining`` tokens of budget left (moving a row
        about to finish costs more than it frees)."""
        out = []
        for rid, _emitted, remaining in self.engine.active_requests():
            if remaining >= min_remaining and rid not in self._relays:
                out.append(rid)
            if len(out) >= n:
                break
        return out

    def migrate_out(self, rid: str, target_id: str,
                    trace: Optional[Tuple[int, int]] = None) -> bool:
        """Move one decoding request to ``target_id``.  Returns True on
        a completed handoff; False when the request resolved locally
        first (finished/cancelled before the freeze).  Raises
        :class:`MigrationError` when the target cannot be reached —
        after SELF-HEALING: the detached checkpoint (if any) re-imports
        locally, so the request survives a dead target."""
        t_all = SpanClock()
        # attempts start at 1: the adopted/aborted gates treat 0 as
        # "never seen", so attempt numbers must stay strictly positive
        attempt = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = attempt
        req = self.engine.get_request(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid!r}")
        if trace is None:
            # join the request's own trace when it carries one (the
            # gateway-propagated id), so /trace/fleet stitches the
            # migration spans into the same request lane as the proxy
            # and engine spans; a fresh id otherwise
            trace = (getattr(req, "trace_id", 0) or new_trace_id(), 0)
        cat = _migration_metrics()
        if cat is not None:
            try:
                cat.MIGRATION_INFLIGHT.inc()
            except Exception:            # pragma: no cover - defensive
                pass
        try:
            return self._migrate_out(rid, attempt, req, target_id, trace,
                                     t_all)
        finally:
            if cat is not None:
                try:
                    cat.MIGRATION_INFLIGHT.dec()
                except Exception:        # pragma: no cover - defensive
                    pass

    def _migrate_out(self, rid: str, attempt: int, req, target_id: str,
                     trace, t_all: SpanClock) -> bool:
        bt = self.engine.kv_cache.block_tokens
        # ---- phase 1: bulk checkpoint, row keeps decoding ----
        with SpanClock() as t_exp:
            try:
                ckpt1 = self.engine.export_request(rid)
            except (KeyError, ValueError):
                # finished/cancelled between pick and export: no-op
                return False
            except TimeoutError as e:
                # stalled scheduler: the mailbox was abandoned (the
                # late export is a no-op) and the row keeps decoding
                # locally — loud failure, nothing to heal
                self.stats["failed_migrations"] += 1
                raise MigrationError(
                    f"phase-1 export of {rid!r} timed out on the "
                    f"scheduler mailbox: {e}") from e
        span1 = self.tracer.record("migration_export", trace[0], trace[1],
                                   clock=t_exp, rid=rid,
                                   tokens=len(ckpt1["tokens"]))
        frames: List[Tuple[str, bytes]] = []

        def add_block_frames(ckpt, lo: int) -> None:
            n = 0 if ckpt["k"] is None else int(ckpt["k"].shape[0])
            step = self.page_frame_blocks
            for first in range(lo, n, step):
                sl = slice(first, min(first + step, n))
                kb, vb = ckpt["k"][sl], ckpt["v"][sl]
                frames.append(
                    (f"pg:{rid}:{attempt}:{len(frames)}",
                     _page_frame(kb, vb, first,
                                 trace=(trace[0], span1))))

        add_block_frames(ckpt1, 0)
        n1 = 0 if ckpt1["k"] is None else -(-ckpt1["length"] // bt)
        state1 = _meta_frame(
            _state_meta(ckpt1, rid=rid, attempt=attempt,
                        n_frames=len(frames), n_blocks=n1,
                        source_id=self.device_id,
                        reply_to=self.device_id),
            _state_tensors(ckpt1), trace=(trace[0], span1))
        try:
            for tag, body in frames:
                self.transport.send(target_id, tag, body)
            acked1 = self._await_ack(rid, attempt, target_id, frames,
                                     f"rs:{rid}:{attempt}", state1,
                                     f"pga:{rid}:{attempt}")
        except TransportError:
            # dead/unconnected peer mid-bulk: the row never froze, same
            # recovery as an unacked phase 1
            acked1 = False
        if not acked1:
            self._abort_target(rid, target_id)
            self.stats["failed_migrations"] += 1
            raise MigrationError(
                f"phase-1 checkpoint of {rid!r} to {target_id} was not "
                f"acked within {self.retries} retries")
        # ---- phase 2: freeze, ship the delta, hand off ----
        with SpanClock() as t_frz:
            try:
                ckpt2 = self.engine.export_request(rid, detach=True)
            except (KeyError, ValueError):
                # the row finished or was cancelled while phase 1
                # shipped: it resolved locally — abort the staging
                self._abort_target(rid, target_id)
                return False
            except TimeoutError as e:
                # the abandoned mailbox guarantees the freeze did NOT
                # happen — the row keeps decoding locally
                self._abort_target(rid, target_id)
                self.stats["failed_migrations"] += 1
                raise MigrationError(
                    f"freeze of {rid!r} timed out on the scheduler "
                    "mailbox; request keeps decoding locally") from e
        span2 = self.tracer.record("migration_freeze", trace[0], span1,
                                   clock=t_frz, rid=rid,
                                   tokens=len(ckpt2["tokens"]))
        # delta: blocks from the (re-shipped) partial tail of phase 1 on
        # — phase 2's version of that block supersedes phase 1's
        lo = (ckpt1["length"] // bt) if ckpt1["k"] is not None else 0
        n_phase1 = len(frames)
        add_block_frames(ckpt2, lo)
        n2 = -(-ckpt2["length"] // bt)
        state2 = _meta_frame(
            _state_meta(ckpt2, rid=rid, attempt=attempt,
                        n_frames=len(frames), n_blocks=n2,
                        source_id=self.device_id,
                        reply_to=self.device_id),
            _state_tensors(ckpt2), trace=(trace[0], span2))
        self._relays[rid] = (req, target_id)
        # EVERYTHING between the detach and the ack must funnel into the
        # self-heal: the row already froze, so a raw TransportError here
        # (dead peer — no retry/timeout softens a hard send failure)
        # would otherwise orphan a request whose pages are released and
        # whose stream nobody owns
        try:
            for tag, body in frames[n_phase1:]:
                self.transport.send(target_id, tag, body)
            acked2 = self._await_ack(rid, attempt, target_id, frames,
                                     f"rsd:{rid}:{attempt}", state2,
                                     f"rsa:{rid}:{attempt}")
        except TransportError:
            acked2 = False
        if not acked2:
            # target unreachable AFTER the freeze: self-heal — the
            # checkpoint re-imports locally and a local relay pump keeps
            # the original stream alive; the request never drops.  The
            # ack may also have been lost after a successful adopt,
            # which pgx: deliberately ignores — mcx: rides along so an
            # adopted target cancels its duplicate row instead of
            # decoding it to completion (its fin finds no relay entry
            # here and drops)
            self._relays.pop(rid, None)
            self._abort_target(rid, target_id)
            self._cancel_target(rid, target_id)
            self.stats["failed_migrations"] += 1
            self._heal_local(rid, req, ckpt2)
            raise MigrationError(
                f"handoff of {rid!r} to {target_id} was not acked; "
                "request re-imported locally")
        nbytes = sum(len(b) for _, b in frames)
        self.stats["migrated_out"] += 1
        self.stats["moved_pages"] += n2
        self.stats["moved_bytes"] += nbytes
        self.stats["last_migration_ms"] = round(t_all.seconds * 1e3, 3)
        cat = _migration_metrics()
        if cat is not None:
            try:
                cat.MIGRATION_EXPORTED.inc()
                cat.MIGRATION_MOVED_PAGES.inc(n2)
                cat.MIGRATION_MOVED_BYTES.inc(nbytes)
            except Exception:            # pragma: no cover - defensive
                pass
        self.tracer.record("migration_handoff", trace[0], span2,
                           ts=t_all.ts, dur=t_all.seconds, rid=rid,
                           target=target_id, blocks=n2, bytes=nbytes)
        self._flight.record("migration_out", rid=rid, attempt=attempt,
                            target=target_id, blocks=n2, bytes=nbytes,
                            ms=self.stats["last_migration_ms"])
        return True

    def _await_ack(self, rid: str, attempt: int, target_id: str,
                   frames: List[Tuple[str, bytes]], end_tag: str,
                   end_body: bytes, ack_tag: str) -> bool:
        """§15 go-back-n: send the end/manifest frame, wait for its ack,
        retransmit the tail from the receiver's expected seq on a
        nack, under the bounded retry budget."""
        for _round in range(self.retries + 1):
            try:
                self.transport.send(target_id, end_tag, end_body)
            except TransportError:
                return False
            try:
                payload = self._recv_ack(ack_tag)
            except TransportTimeout:
                continue
            except TransportError:
                return False
            try:
                status = np.asarray(
                    wire.deserialize_tensors(payload).tensors[0])
            except wire.WireError:
                continue
            if int(status[0]) == 0:
                return True
            expected = int(status[1])
            for tag, body in frames[expected:]:
                try:
                    self.transport.send(target_id, tag, body)
                except TransportError:
                    return False
            self._flight.record("migration_retransmit", rid=rid,
                                attempt=attempt, from_seq=expected)
        return False

    def _recv_ack(self, ack_tag: str) -> bytes:
        """One ack payload within ``ack_timeout`` — from the worker ack
        stash (a concurrent serve loop routed it there) or straight off
        the transport (no serve loop running), whichever lands first."""
        deadline = time.monotonic() + self.ack_timeout
        while True:
            with self._ack_cv:
                items = self._ack_stash.get(ack_tag)
                if items:
                    payload = items.pop(0)
                    if not items:
                        del self._ack_stash[ack_tag]
                    return payload
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeout(
                    f"{self.device_id}: no {ack_tag!r} within "
                    f"{self.ack_timeout}s")
            try:
                return self.transport.recv(
                    ack_tag, timeout=min(0.05, remaining))
            except TransportTimeout:
                continue

    def _abort_target(self, rid: str, target_id: str) -> None:
        try:
            self.transport.send(target_id, f"pgx:{rid}",
                                _meta_frame({"rid": rid}))
        except TransportError:
            pass

    def _cancel_target(self, rid: str, target_id: str) -> None:
        """mcx: the target — if the handoff DID land there (the phase-2
        ack was lost after a successful adopt), the duplicate row
        cancels instead of burning a slot decoding to completion; on a
        never-adopted target it is a no-op."""
        try:
            self.transport.send(target_id, f"mcx:{rid}",
                                _meta_frame({"rid": rid}))
        except TransportError:
            pass

    def _heal_local(self, rid: str, req, ckpt: dict) -> None:
        """Re-import a detached checkpoint into the local engine and
        pump the resumed request's stream into the ORIGINAL Request —
        the client's stream survives a failed handoff untouched."""
        try:
            healed = self.engine.import_request(ckpt, request_id=None)
        except Exception as e:
            req.error = MigrationError(
                f"handoff failed and local re-import failed too: "
                f"{type(e).__name__}: {e}")
            self._end_pause(req)
            req.stream.put(None)
            req.done.set()
            try:
                self.engine._close_timeline(req, error="MigrationError")
            except Exception:        # pragma: no cover - defensive
                pass
            return
        self.stats["healed_requests"] += 1
        self._flight.record("migration_healed", rid=rid,
                            resumed_at=len(healed.tokens))

        def pump():
            while True:
                item = healed.stream.get()
                if item is None:
                    break
                self._end_pause(req)
                req.tokens.append(int(item))
                req.stream.put(int(item))
            req.error = healed.error
            self._end_pause(req)
            req.t_done = time.perf_counter()
            req.stream.put(None)
            req.done.set()
            try:
                self.engine._close_timeline(
                    req, error=(None if healed.error is None else
                                type(healed.error).__name__))
            except Exception:        # pragma: no cover - defensive
                pass

        threading.Thread(target=pump, daemon=True,
                         name=f"migration-heal-{rid}").start()

    # -- observability -----------------------------------------------------

    def debug_state(self) -> dict:
        return {"staged_migrations": self.stager.debug_state(),
                "staged_bytes": self.stager.staged_bytes,
                "relaying": sorted(self._relays),
                "imported": sorted(self._imported),
                "migration": dict(self.stats)}


# ---------------------------------------------------------------------------
# co-serving: one transport, two protocols
# ---------------------------------------------------------------------------


class CoServingWorker:
    """One recv loop over a transport shared by a §15
    :class:`~.disagg.DecodeWorker` (prefill->decode admission joins) and
    a §18 :class:`MigrationWorker` (decode->decode live handoffs).

    The two protocols share the ``pg:``/``pgx:`` tags, so they MUST
    share one :class:`~.disagg.PageStager` (pass
    ``decode_worker.stager`` into the MigrationWorker): whichever
    completion frame arrives — ``pge:`` (admission join) or ``rsd:``
    (live handoff) — claims the staged record, and the stager's aborted
    markers make late retransmits drop no matter whose ``_on_page``
    sees them.  Dispatch tries the decode worker first (it owns
    pg/pge/pgx), then the migration worker (rs/rsd/mcx/tok/fin + acks).
    """

    def __init__(self, decode, migration):
        if migration.stager is not decode.stager:
            raise ValueError(
                "co-serving workers must share one PageStager "
                "(MigrationWorker(..., stager=decode_worker.stager))")
        self.decode = decode
        self.migration = migration
        self.transport = decode.transport
        self.device_id = decode.device_id

    def serve_forever(self, idle_timeout: Optional[float] = None) -> None:
        idle_since = time.monotonic()
        while not (self.decode._stop.is_set()
                   or self.migration._stop.is_set()):
            try:
                tag, payload = self.transport.recv_any(timeout=0.1)
            except TransportTimeout:
                if (idle_timeout is not None
                        and time.monotonic() - idle_since > idle_timeout):
                    return
                continue
            idle_since = time.monotonic()
            try:
                if not self.decode.handle_message(tag, payload):
                    self.migration.handle_message(tag, payload)
            except Exception:
                # one malformed frame must not take the replica down
                log.exception("%s: co-served frame %r failed",
                              self.device_id, tag)

    def stop(self) -> None:
        self.decode.stop()
        self.migration.stop()

    def debug_state(self) -> dict:
        out = self.decode.debug_state()
        out["live_migration"] = self.migration.debug_state()
        return out


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class MigrationController:
    """Rebalance/drain policy over the gateway registry's load view.

    ``mover(src_rid, dst_rid, n) -> int`` is the injected mechanism (how
    many requests actually moved) — in-process deployments resolve the
    replica's :class:`MigrationWorker` and call ``migrate_out`` per
    picked rid; a remote control plane would RPC the source replica.

    Load = ``active_slots + queue_depth`` from each replica's last
    ``/stats`` probe (the same numbers the router's least-loaded
    tiebreak consumes)."""

    def __init__(self, registry, mover: Callable[[str, str, int], int],
                 *, load_gap: int = 2, max_moves_per_round: int = 1):
        self.registry = registry
        self.mover = mover
        self.load_gap = max(1, int(load_gap))
        self.max_moves = max(1, int(max_moves_per_round))
        self.stats = {"rebalances": 0, "moved_requests": 0,
                      "drained_requests": 0}
        self._flight = get_flight_recorder()

    def load(self, rid: str) -> int:
        r = self.registry.get(rid)
        st = (r.last_stats or {}) if r is not None else {}
        return int(st.get("active_slots", 0)) + int(
            st.get("queue_depth", 0))

    def pick_rebalance(self) -> Optional[Tuple[str, str, int]]:
        """(hot_source, light_target, n) — or None when the fleet is
        balanced.  Sources include draining replicas (their load must
        go somewhere); targets only routable (up, not draining) ones."""
        targets = [r for r in self.registry.routable_replicas()]
        sources = [r for r in self.registry.replica_ids()
                   if self.registry.is_up(r)]
        if not targets or not sources:
            return None
        src = max(sources, key=self.load)
        dst = min(targets, key=self.load)
        if src == dst:
            return None
        gap = self.load(src) - self.load(dst)
        if gap < self.load_gap and not self.registry.is_draining(src):
            return None
        n = (self.load(src) if self.registry.is_draining(src)
             else max(1, gap // 2))
        return src, dst, min(n, self.max_moves)

    def rebalance_once(self) -> int:
        pick = self.pick_rebalance()
        if pick is None:
            return 0
        src, dst, n = pick
        moved = int(self.mover(src, dst, n))
        if moved:
            self.stats["rebalances"] += 1
            self.stats["moved_requests"] += moved
            self._flight.record("migration_rebalance", source=src,
                                target=dst, moved=moved)
        return moved

    def drain(self, rid: str, *, deadline_s: float = 30.0,
              poll_s: float = 0.05) -> int:
        """Drive ``rid`` empty: mark it draining (no new routes, no
        eviction strike) and migrate its in-flight requests to the
        lightest routable peers until none remain or the deadline
        passes.  Returns how many requests moved; requests that finish
        on their own while draining count as drained too (they just
        needed no move)."""
        self.registry.set_draining(rid, True)
        moved = 0
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            targets = [t for t in self.registry.routable_replicas()
                       if t != rid]
            if not targets:
                break
            dst = min(targets, key=self.load)
            n = int(self.mover(rid, dst, self.max_moves))
            if n:
                moved += n
                self.stats["drained_requests"] += n
                continue
            # nothing migratable right now: done, or mid-admission rows
            # need a beat to become movable
            r = self.registry.get(rid)
            st = (r.last_stats or {}) if r is not None else {}
            if (int(st.get("active_slots", 0))
                    + int(st.get("queue_depth", 0))) == 0:
                break
            time.sleep(poll_s)
        self._flight.record("migration_drain", replica=rid, moved=moved)
        return moved
