"""Disaggregated prefill/decode serving with KV page migration.

Colocating compute-bound prefill and bandwidth-bound decode on one
engine makes TTFT and TPOT fight for the same chip (docs/DESIGN.md
§3/§6): a long prefill's chunks interleave with — and stall — every
in-flight decode step, and decode steals the HBM bandwidth the chunked
prefill needs.  This module splits the two roles (docs/DESIGN.md §15):

- :class:`PrefillWorker` runs chunked prefill into its local paged pool
  and **migrates the request's KV pages** to a decode worker over the
  §12 transport — a new tagged frame kind (``pg:{rid}:{attempt}:{seq}``)
  carrying page payloads + block metadata, so CRC integrity, bounded
  send retry, and receiver dedup come for free.  Pages stream
  **per prefill chunk**: migration overlaps the remaining prefill
  instead of waiting for it.
- :class:`DecodeWorker` stages arriving page frames on the HOST (a
  partial migration therefore holds ZERO pool pages — crash cleanup is
  structural), and on a complete, CRC-verified migration ADOPTS the
  pages into its scheduler's pool + radix tree
  (``ContinuousBatchingEngine.submit_premigrated`` → §11
  ``store_shared`` ownership adoption) and joins the request into the
  paged-native continuous-batching drain.  The join is a block-table
  reference plus one short suffix prefill (≤ one block) — decode
  batches never stall behind a long prefill again, and
  ``dwt_kvcache_h2d_bytes_total`` stays 0 on the decode side (the
  adopt is a device scatter + table reference, never a dense-row
  host gather).
- :class:`DisaggCoordinator` owns request handoff and migration
  scheduling: round-robin dispatch over prefill workers, and
  crash-rescheduling — a prefill worker that dies mid-migration gets
  its unfinished requests resent to a surviving worker under a bumped
  ``attempt`` (the decode worker discards stale-attempt frames, so a
  half-migrated attempt can never corrupt the decode-side tree).

Reliability protocol (rides the §12 substrate):

- every frame is a `wire.serialize_tensors` payload → CRC-checked; a
  corrupt page frame is counted + dropped, never adopted;
- the receiver tracks the expected next ``seq`` per (rid, attempt):
  duplicated / reordered / retried frames are dropped idempotently
  (the (rid, step) dedup rule, migration-shaped);
- the end frame (``pge``) carries the frame count; the receiver acks
  with its expected seq, and the sender retransmits the missing tail
  (go-back-n) under a bounded retry budget — drops and CRC rejections
  recover without resharding;
- a completed (joined) rid re-acks "complete" for any late attempt's
  frames, so retransmits and reschedule races stay idempotent.

Exactness: migrated pages hold the model's K/V for whole prompt
blocks, which depend only on the prompt prefix (causality) — the same
bytes the decode engine's own cold prefill would write.  Chunked
prefill is bit-identical to whole-prompt prefill (§10), so greedy
output through the disaggregated path is bit-identical to the
colocated engine (pinned by tests/test_disagg.py + the chaos soak).
Under a quantized ``kv_dtype`` (docs/DESIGN.md §17) the prefill worker
quantizes ONCE at export; the frames carry the narrow bytes plus the
scale sidecars (a ``kv_dtype`` tag in the page-frame metadata), and
the decode pool adopts them verbatim — the migrated pages are
bit-identical to the prefill side's, so there is exactly one
quantization rounding on the whole path, the same one a colocated
quantized engine pays at its own page-write.

Counterpart of ``distributed_inference_demo_tpu/runtime/disagg.py``,
speaking its wire protocol frame for frame.  Host block payloads are
CPU tensors (``QuantizedKVPages`` of them for narrow pages) and become
numpy only at the wire: a bf16 leaf travels as its ``uint16`` bits
under the wire's bf16 code (``comm.wire.bf16_view``).  The wire has no
float8 code, so a float8 payload is refused there, as in the
reference.  The prefill worker's chunks run through
``InferenceEngine``'s prefill programs (``runtime/engine.
prefill_programs``) over a dense row cache, which on the card launch
the flash kernel; the row is seeded from and stored to pages with
``kvcache/device.seed_cache_from_pages`` / ``store_cache_to_pages``.

Frame tags (rids must not contain ``:``):

    dreq:{rid}:{attempt}    coordinator → prefill   request handoff
    pg:{rid}:{attempt}:{n}  prefill → decode        page payload frame
    pge:{rid}:{attempt}     prefill → decode        migration end/manifest
    pga:{rid}:{attempt}     decode → prefill        ack (status, expected)
    pgx:{rid}               coordinator → decode    abort a staged attempt
    tok:{rid}:{i}           decode → coordinator    one streamed token
    fin:{rid}               decode → coordinator    final tokens / error
    perr:{rid}:{attempt}    prefill → coordinator   handoff failed
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..comm import wire
from ..comm.transport import (TransportError, TransportTimeout,
                              record_corrupt_frame)
from ..telemetry._env import env_float, env_int
from ..telemetry.flightrecorder import get_flight_recorder
from ..telemetry.tracing import SpanClock, TraceRecorder, new_trace_id
from .kvcache.device import payload_to

log = logging.getLogger(__name__)

# migration reliability knobs (docs/DESIGN.md §15 table)
DEFAULT_ACK_TIMEOUT_S = env_float("DWT_DISAGG_ACK_TIMEOUT_S", 2.0)
DEFAULT_MIGRATION_RETRIES = env_int("DWT_DISAGG_MIGRATION_RETRIES", 5)


def _disagg_metrics():
    """The dwt_disagg_* series, resolved lazily and never fatally (a
    metrics regression must not take down the data plane) — the
    transport's pattern."""
    try:
        from ..telemetry import catalog
        return catalog
    except Exception:           # pragma: no cover - defensive
        return None


def _meta_frame(meta: dict, tensors=(), trace=None) -> bytes:
    """One migration-control payload: a JSON metadata blob as a u8
    tensor, followed by any data tensors — CRC + optional trace-context
    trailer via the standard wire codec."""
    blob = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    arrays = [blob] + list(tensors)
    if trace is None:
        return wire.serialize_tensors(arrays)
    return wire.serialize_tensors_traced(arrays, trace[0], trace[1])


def _parse_meta_frame(payload: bytes):
    """(meta, tensors, trace_ctx) — raises WireError/WireIntegrityError
    on a corrupt or malformed frame (the caller drops it)."""
    tensors, ctx = wire.split_trace_context(
        wire.deserialize_tensors(payload))
    if not tensors:
        raise wire.WireError("migration frame without metadata tensor")
    meta = json.loads(bytes(tensors[0].tobytes()).decode())
    return meta, tensors[1:], ctx


#: leaves per side on the wire for each page width: bf16 ships the one
#: full-width tensor (byte-identical to the pre-quantization format),
#: int8 ships (data, scale), packed int4 (data, scale, zero).
_WIRE_LEAVES = {"bf16": 1, "int8": 2, "int4": 3}


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A host leaf as the wire's numpy array: bf16 as its marked uint16
    bits, float8 refused (the wire has no float8 code)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return wire.bf16_view(t.view(torch.uint16).numpy())
    if t.dtype.is_floating_point and t.element_size() == 1:
        raise wire.WireError(
            f"unsupported dtype for wire: {str(t.dtype).split('.')[-1]}")
    return t.numpy()


def _from_wire(a: np.ndarray) -> torch.Tensor:
    """A decoded wire tensor as a host leaf (inverse of :func:`_to_wire`)."""
    if isinstance(a, wire.Bf16Bits):
        return torch.from_numpy(np.asarray(a, np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _kv_leaf_lists(blocks):
    """Flatten one side's (possibly quantized) host block payload into
    the wire's flat tensor list + its page-width tag."""
    from ..ops.quant import QuantizedKVPages
    if isinstance(blocks, QuantizedKVPages):
        return ([_to_wire(t) for t in blocks.leaves()],
                "int4" if blocks.bits == 4 else "int8")
    return [_to_wire(blocks)], "bf16"


def _kv_from_leaves(leaves, kv_dtype: str):
    """Rebuild one side's block payload from its host leaf list."""
    if kv_dtype == "bf16":
        return leaves[0]
    from ..ops.quant import QuantizedKVPages
    bits = 4 if kv_dtype == "int4" else 8
    zero = leaves[2] if bits == 4 else None
    return QuantizedKVPages(leaves[0], leaves[1], zero, bits)


def _page_frame(k_blocks, v_blocks, first_block: int, trace=None) -> bytes:
    """One page-payload frame: ``[n, L, H, bt, D]`` K and V block runs
    starting at block index ``first_block`` of the migration.  Quantized
    runs (``ops.quant.QuantizedKVPages``) ship their narrow data plus
    the scale (and int4 zero-point) sidecars as extra tensors with a
    ``kv_dtype`` tag in the metadata; full-width frames carry no tag and
    stay byte-identical to the pre-quantization wire format."""
    k_leaves, kv_dtype = _kv_leaf_lists(k_blocks)
    v_leaves, _ = _kv_leaf_lists(v_blocks)
    meta = {"first_block": int(first_block),
            "n_blocks": int(k_blocks.shape[0])}
    if kv_dtype != "bf16":
        meta["kv_dtype"] = kv_dtype
    return _meta_frame(meta, k_leaves + v_leaves, trace=trace)


class MigrationError(RuntimeError):
    """A migration could not complete within its retry budget."""


class PageStager:
    """Host-side ``(rid, attempt)`` page-frame staging shared by the §15
    admission join (:class:`DecodeWorker`) and the §18 live-migration
    handoff (``runtime.migration.MigrationWorker``).

    One store serves both protocols because their bulk-transfer leg is
    the same ``pg:`` frame stream — when a decode replica runs both
    workers on one transport, they SHARE one stager (the worker whose
    completion frame arrives — ``pge:`` or ``rsd:`` — claims the staged
    record), so an inbound page frame never needs to announce which
    protocol it belongs to.

    Invariants the stager owns:

    - staging is HOST memory only — zero pool pages held until a
      complete, CRC-verified frame set is adopted (crash cleanup is
      structural);
    - ``staged_bytes`` tracks every staged tensor byte and every removal
      path (abort, adopt, supersede, eviction) funnels through
      :meth:`clear`, so an aborted handoff provably leaves
      ``staged_bytes == 0`` and no record behind;
    - an ABORTED ``(rid, attempt)`` is remembered (bounded markers): a
      late frame of that attempt drops instead of silently restaging a
      leak the abort already cleaned up;
    - bounded: past ``STAGED_CAP`` records the OLDEST evicts — the
      backstop for migrations orphaned by a sender that died without an
      abort reaching us.  Evicting a still-live migration is safe: its
      next frame restages from seq 0, the end frame nacks, and the
      sender's go-back-n retransmits the lot.

    Record schema (the keys tests may pin): ``attempt``, ``expected``
    (next seq), ``frames`` ({seq: (first_block, k_leaves, v_leaves)}),
    ``kv_dtype``, ``bytes``, ``t0``, plus ``state_meta`` /
    ``state_tensors`` / ``ctx`` slots the live-migration manifest
    fills."""

    STAGED_CAP = 256
    MARK_CAP = 4096

    def __init__(self, device_id: str, on_evict=None):
        self.device_id = device_id
        self._staged: Dict[str, dict] = {}
        from collections import OrderedDict
        self._aborted: "OrderedDict[str, int]" = OrderedDict()
        self.staged_bytes = 0
        self._on_evict = on_evict
        self._flight = get_flight_recorder()

    def clear(self, rid: str) -> Optional[dict]:
        """Pop a staging record AND its byte accounting."""
        st = self._staged.pop(rid, None)
        if st is not None:
            self.staged_bytes -= st["bytes"]
        return st

    def mark_aborted(self, rid: str, attempt: int) -> None:
        self._aborted[rid] = attempt
        self._aborted.move_to_end(rid)
        while len(self._aborted) > self.MARK_CAP:
            self._aborted.popitem(last=False)

    def staging(self, rid: str, attempt: int) -> Optional[dict]:
        """The record for ``(rid, attempt)``: fresh on the first frame
        of a NEWER attempt (superseding the stale one), None for a stale
        or aborted attempt (the caller drops the frame)."""
        if self._aborted.get(rid, -1) >= attempt:
            return None
        st = self._staged.get(rid)
        if st is None or st["attempt"] < attempt:
            if st is not None:
                self.clear(rid)
                self._flight.record("disagg_attempt_superseded", rid=rid,
                                    old=st["attempt"], new=attempt)
            st = {"attempt": attempt, "expected": 0, "frames": {},
                  "kv_dtype": "bf16", "bytes": 0,
                  "state_meta": None, "state_tensors": None, "ctx": None,
                  "t0": time.perf_counter()}
            self._staged[rid] = st
            while len(self._staged) > self.STAGED_CAP:
                victim = min(self._staged,
                             key=lambda r: self._staged[r]["t0"])
                self.clear(victim)
                self._flight.record("disagg_staging_evicted", rid=victim)
                if self._on_evict is not None:
                    self._on_evict(victim)
            return st
        if st["attempt"] > attempt:
            return None
        return st

    def stage_page(self, rid: str, attempt: int, seq: int,
                   payload: bytes, tag: str) -> str:
        """Stage one ``pg:`` frame; returns ``"staged"`` or the drop
        reason (``"corrupt"`` frames are counted via
        :func:`record_corrupt_frame` here — the sender's ack round
        retransmits them)."""
        try:
            meta, tensors, _ = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, tag, len(payload), e)
            return "corrupt"
        st = self.staging(rid, attempt)
        if st is None:
            return "stale_attempt"
        if seq != st["expected"]:
            # duplicate (seq < expected) or a reorder hole (seq >
            # expected): drop — the (rid, attempt, seq) dedup that makes
            # retried page frames idempotent; go-back-n refills holes
            return "dedup"
        kv_dtype = meta.get("kv_dtype", "bf16")
        nk = _WIRE_LEAVES.get(kv_dtype)
        if nk is None or len(tensors) != 2 * nk:
            # a malformed leaf list is a corrupt frame, not a protocol
            # state: drop it and let the sender's ack round retransmit
            record_corrupt_frame(
                self.device_id, tag, len(payload),
                wire.WireError(f"page frame kv_dtype={kv_dtype!r} with "
                               f"{len(tensors)} tensors"))
            return "corrupt"
        # frames of one migration share one width (one exporter); the
        # leaf lists stage per frame and concatenate leaf-wise on adopt
        st["kv_dtype"] = kv_dtype
        nb = int(sum(t.nbytes for t in tensors))
        st["frames"][seq] = (int(meta["first_block"]),
                             [_from_wire(t) for t in tensors[:nk]],
                             [_from_wire(t) for t in tensors[nk:]])
        st["bytes"] += nb
        st["expected"] += 1
        self.staged_bytes += nb
        return "staged"

    def concat_blocks(self, st: dict, n_blocks: int):
        """``(k_blocks, v_blocks)`` assembled from a complete frame set:
        frames apply in seq order at their ``first_block`` offsets, so a
        later frame's version of a block (the live handoff's re-shipped
        partial tail) OVERWRITES an earlier one's.  Raises
        :class:`MigrationError` on block holes (a manifest/frames
        mismatch — the caller fails the migration rather than adopting
        the wrong pages)."""
        if not st["frames"]:
            return None, None
        slots: List[Optional[tuple]] = [None] * n_blocks
        overrun = 0
        for seq in sorted(st["frames"]):
            first, k_leaves, v_leaves = st["frames"][seq]
            n = k_leaves[0].shape[0]
            for j in range(n):
                if 0 <= first + j < n_blocks:
                    slots[first + j] = (
                        [lv[j:j + 1] for lv in k_leaves],
                        [lv[j:j + 1] for lv in v_leaves])
                else:
                    overrun += 1
        holes = sum(s is None for s in slots)
        if holes or overrun:
            raise MigrationError(
                f"staged frames cover {n_blocks - holes}/{n_blocks} "
                f"blocks ({overrun} out of range)")
        k_leaves = [torch.cat(parts, dim=0)
                    for parts in zip(*(s[0] for s in slots))]
        v_leaves = [torch.cat(parts, dim=0)
                    for parts in zip(*(s[1] for s in slots))]
        return (_kv_from_leaves(k_leaves, st["kv_dtype"]),
                _kv_from_leaves(v_leaves, st["kv_dtype"]))

    def debug_state(self) -> dict:
        return {rid: {"attempt": st["attempt"],
                      "frames_staged": st["expected"],
                      "bytes": st["bytes"]}
                for rid, st in list(self._staged.items())}


# ---------------------------------------------------------------------------
# prefill worker
# ---------------------------------------------------------------------------


class PrefillWorker:
    """Prefill-only serving role: chunked prefill into a local paged
    pool, per-chunk KV page migration to a decode worker.

    The worker never samples a token — chunks run ``chunk_mid``, whose
    last-row logits are dropped — and the first sampled token comes
    from the decode worker's suffix prefill.  Its paged pool + radix
    tree give repeat prompts prefix reuse: a matched prefix migrates
    straight out of the pool with zero recompute.
    """

    def __init__(self, cfg, params, transport, max_seq: int = 1024,
                 prefill_chunk: int = 32,
                 kv_cache_blocks: Optional[int] = None,
                 kv_block_tokens: Optional[int] = None,
                 ack_timeout: Optional[float] = None,
                 migration_retries: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device=None):
        """Arguments as in the reference.  Port-only: ``device`` (CUDA
        unless "cpu" is asked for; ``params`` live there).  Attention is
        ``InferenceEngine``'s "auto": the flash kernel on the card."""
        from ..device import resolve_device
        from ..models.base import KVCache, StageSpec
        from ..models.decoder import stage_forward
        from ..ops.flash_attention import make_flash_attn_impl
        from ..ops.quant import alloc_kv_pages, resolve_kv_dtype
        from .engine import (prefill_programs, resolve_attn_backend,
                             validate_prefill_chunk)
        from .kvcache import PagedKVCacheManager, resolve_kvcache_config

        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.transport = transport
        self.device_id = transport.device_id
        self.max_seq = max_seq
        self.prefill_chunk = validate_prefill_chunk(
            prefill_chunk or 32, max_seq) or 32
        self.ack_timeout = (DEFAULT_ACK_TIMEOUT_S if ack_timeout is None
                            else float(ack_timeout))
        self.migration_retries = (DEFAULT_MIGRATION_RETRIES
                                  if migration_retries is None
                                  else int(migration_retries))
        spec = StageSpec(0, 1, 0, cfg.num_layers)
        self.attn_backend = resolve_attn_backend(
            "auto", self.device.type, cfg.head_dim)
        attn_impl = (make_flash_attn_impl()
                     if self.attn_backend == "flash" else None)

        def fwd(ids, cache, pos, last_logits_only):
            return stage_forward(params, cfg, spec, ids, cache, pos,
                                 attn_impl=attn_impl,
                                 last_logits_only=last_logits_only)

        _, self._chunk_mid, _ = prefill_programs(fwd, self.device)
        self._KVCache = KVCache

        n_blocks, bt = resolve_kvcache_config(
            kv_cache_blocks, kv_block_tokens, default_blocks=0)
        if n_blocks < 1:
            # default pool: enough pages for a handful of max_seq prompts
            n_blocks = 4 * max(1, -(-max_seq // bt))
        # page width: the local reuse pool, the exported block payloads
        # and the decode-side engine pool all share ONE kv_dtype so a
        # migrated page adopts verbatim
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.kv_cache = PagedKVCacheManager.for_model(
            cfg, n_blocks, bt, kv_dtype=self.kv_dtype)
        N = self.kv_cache.num_blocks
        # N pages a table may name + the drop page N
        shape = (cfg.num_layers, N + 1, cfg.num_kv_heads, bt, cfg.head_dim)
        self._pk = alloc_kv_pages(shape, self.kv_dtype, cfg.dtype,
                                  self.device)
        self._pv = alloc_kv_pages(shape, self.kv_dtype, cfg.dtype,
                                  self.device)

        self.tracer = TraceRecorder(f"prefill:{self.device_id}")
        self.stats = {"handoffs": 0, "migrated_pages": 0,
                      "migrated_bytes": 0, "retransmitted_frames": 0,
                      "failed_handoffs": 0, "last_migration_ms": None}
        self._backlog: List[tuple] = []
        self._inflight_rid: Optional[str] = None
        self._stop = threading.Event()
        self._flight = get_flight_recorder()

    # -- serve loop --------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def serve_forever(self, idle_timeout: Optional[float] = None) -> None:
        """Process handoff requests until :meth:`stop` (or
        ``idle_timeout`` seconds without work)."""
        idle_since = time.monotonic()
        while not self._stop.is_set():
            try:
                tag, payload = self.transport.recv_any(timeout=0.1)
            except TransportTimeout:
                if not self._backlog:
                    if (idle_timeout is not None
                            and time.monotonic() - idle_since
                            > idle_timeout):
                        return
                    continue
                tag = None
            if tag is not None:
                idle_since = time.monotonic()
                if tag.startswith("dreq:"):
                    self._backlog.append((tag, payload))
                # anything else (stray late acks) is dropped: the
                # handoff that wanted it already resolved
            if self._backlog:
                t, p = self._backlog.pop(0)
                self._handle_request(t, p)
                idle_since = time.monotonic()

    def _handle_request(self, tag: str, payload: bytes) -> None:
        try:
            meta, tensors, ctx = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, tag, len(payload), e)
            return
        prompt = np.asarray(tensors[0], np.int32).reshape(-1)
        rid, attempt = meta["rid"], int(meta.get("attempt", 0))
        self._inflight_rid = rid
        try:
            self.handoff(rid, attempt, prompt, int(meta["max_new"]),
                         meta["decode_id"], meta["reply_to"], ctx)
        except (MigrationError, TransportError) as e:
            # a dead/blocked decode peer surfaces as TransportError out
            # of ship()/end sends: a FAILED HANDOFF, never a dead
            # worker — report perr so the coordinator reschedules.
            # (InjectedCrash is a RuntimeError, not TransportError: a
            # chaos crash still kills the serve loop like a real one.)
            self.stats["failed_handoffs"] += 1
            self._flight.record("disagg_handoff_failed", rid=rid,
                                attempt=attempt, error=str(e))
            try:
                self.transport.send(
                    meta["reply_to"], f"perr:{rid}:{attempt}",
                    _meta_frame({"rid": rid, "attempt": attempt,
                                 "error": str(e)}))
            except TransportError:
                pass      # the coordinator's supervision will notice
        finally:
            self._inflight_rid = None

    # -- the handoff itself ------------------------------------------------

    def _export_blocks(self, row_k, row_v, lo: int, hi: int):
        """Blocks ``[lo, hi)`` of a dense prefill row as host
        ``[n, L, H, bt, D]`` pairs (the copy to the host is the wire
        export; the decode-side adopt stays on the device).  Under a
        quantized ``kv_dtype`` each side quantizes here, once, as the
        reference's export rounds (its quantizer runs eagerly there, so it
        divides by 127 or 15): the frames carry the narrow bytes plus
        scale sidecars, adopted verbatim on the decode side."""
        bt = self.kv_cache.block_tokens
        L, _, H, _, D = row_k.shape
        n = hi - lo

        def blocks(row):
            x = row[:, 0, :, lo * bt:hi * bt, :].reshape(L, H, n, bt, D)
            return x.permute(2, 0, 1, 3, 4).contiguous()

        k, v = blocks(row_k), blocks(row_v)
        if self.kv_dtype != "bf16":
            from ..ops.quant import quantize_kv_pages
            bits = 4 if self.kv_dtype == "int4" else 8
            k = quantize_kv_pages(k.float(), bits)
            v = quantize_kv_pages(v.float(), bits)
        return payload_to(k, "cpu"), payload_to(v, "cpu")

    def handoff(self, rid: str, attempt: int, prompt: np.ndarray,
                max_new: int, decode_id: str, reply_to: str,
                ctx=None) -> None:
        """Run chunked prefill for ``prompt`` and migrate its KV pages
        to ``decode_id``, streaming page frames per chunk; the decode
        worker samples and streams tokens straight to ``reply_to``."""
        from .kvcache.device import seed_cache_from_pages

        mgr = self.kv_cache
        bt = mgr.block_tokens
        plen = len(prompt)
        n_mig = (plen - 1) // bt     # blocks the decode-side join can use
        clock = SpanClock()
        trace = ctx
        span = 0
        if trace is not None:
            span = self.tracer.next_span_id()
        self.stats["handoffs"] += 1
        self._flight.record("disagg_handoff", rid=rid, attempt=attempt,
                            prompt_len=plen, blocks=n_mig)

        frames: List[bytes] = []    # kept until acked, for retransmit

        def ship(k_blocks, v_blocks, first_block):
            body = _page_frame(k_blocks, v_blocks, first_block,
                               trace=(trace[0], span) if trace else None)
            frames.append(body)
            self.transport.send(decode_id,
                                f"pg:{rid}:{attempt}:{len(frames) - 1}",
                                body)

        # 1. prefix reuse: matched blocks migrate straight out of the
        #    pool (zero recompute); the row is seeded from the same
        #    pages so the remaining chunks continue from position m.
        #    The lease is released in the finally — a handoff that dies
        #    mid-send (dead decode peer, injected crash) must not pin
        #    prefix pages in the pool forever.
        lease = mgr.match(prompt) if n_mig >= 1 else None
        try:
            m = lease.tokens if lease is not None else 0
            # room for the padded last chunk past max_seq: the
            # reference's clamped write, without the clamp
            row = self._KVCache.create(self.cfg, self.cfg.num_layers, 1,
                                       self.max_seq + self.prefill_chunk,
                                       device=self.device)
            row_k, row_v = row.keys, row.values
            if lease is not None:
                seed_cache_from_pages(row_k, row_v, self._pk, self._pv,
                                      np.asarray(lease.block_ids, np.int64))
                pk, pv = self._export_blocks(row_k, row_v, 0, m // bt)
                ship(pk, pv, 0)

            # 2. chunked prefill over [m, n_mig*bt), exporting each
            #    chunk's completed blocks the moment the chunk lands —
            #    migration overlaps the remaining prefill.  Logits-free
            #    chunk_mid only: this role never samples.
            C = self.prefill_chunk
            cache = self._KVCache(row_k, row_v, m)
            pos, exported = m, m // bt
            prefill_clock = SpanClock()
            while pos < n_mig * bt:
                step = min(C, n_mig * bt - pos)
                chunk = np.zeros((1, C), np.int64)
                chunk[0, :step] = prompt[pos:pos + step]
                cache = self._chunk_mid(
                    torch.from_numpy(chunk).to(self.device),
                    self._KVCache(cache.keys, cache.values, pos), pos)
                pos += step
                done_blocks = min(pos // bt, n_mig)
                if done_blocks > exported:
                    pk, pv = self._export_blocks(
                        cache.keys, cache.values, exported, done_blocks)
                    ship(pk, pv, exported)
                    exported = done_blocks
            if trace is not None:
                self.tracer.record("disagg_prefill", trace[0], span,
                                   clock=prefill_clock, rid=rid,
                                   blocks=n_mig)

            # 3. adopt the freshly computed blocks into the local
            #    pool/tree (prefix reuse for the NEXT request with this
            #    prompt) — before the ack wait, so a slow decode worker
            #    cannot delay the store.  Best-effort: pool pressure
            #    skips it.
            self._store_local(prompt, cache, m, n_mig)
        finally:
            if lease is not None:
                lease.release()

        # 4. end-of-migration manifest + bounded ack/retransmit loop.
        end_meta = {"rid": rid, "attempt": attempt,
                    "n_frames": len(frames), "n_blocks": n_mig,
                    "block_tokens": bt, "max_new": int(max_new),
                    "reply_to": reply_to, "prefill_id": self.device_id}
        end = _meta_frame(end_meta, (prompt,),
                          trace=(trace[0], span) if trace else None)
        acked = False
        for round_i in range(self.migration_retries + 1):
            self.transport.send(decode_id, f"pge:{rid}:{attempt}", end)
            try:
                body = self.transport.recv(f"pga:{rid}:{attempt}",
                                           timeout=self.ack_timeout)
            except TransportTimeout:
                continue
            try:
                status = np.asarray(
                    wire.deserialize_tensors(body).tensors[0]
                ).reshape(-1)
            except wire.WireError as e:
                # a corrupted ack burns one retry round, nothing more
                record_corrupt_frame(self.device_id,
                                     f"pga:{rid}:{attempt}",
                                     len(body), e)
                continue
            if int(status[0]) == 0:
                acked = True
                break
            expected = int(status[1])    # go-back-n from the receiver
            for seq in range(expected, len(frames)):
                self.stats["retransmitted_frames"] += 1
                cat = _disagg_metrics()
                if cat is not None:
                    try:
                        cat.DISAGG_RETRANSMITTED.inc()
                    except Exception:    # pragma: no cover - defensive
                        pass
                self.transport.send(decode_id,
                                    f"pg:{rid}:{attempt}:{seq}",
                                    frames[seq])
        if not acked:
            raise MigrationError(
                f"migration {rid} attempt {attempt} not acknowledged "
                f"after {self.migration_retries + 1} rounds "
                f"({len(frames)} frames, {n_mig} blocks)")

        nbytes = sum(len(f) for f in frames)
        dt = clock.seconds
        self.stats["migrated_pages"] += n_mig
        self.stats["migrated_bytes"] += nbytes
        self.stats["last_migration_ms"] = round(dt * 1e3, 3)
        cat = _disagg_metrics()
        if cat is not None:
            try:
                cat.DISAGG_MIGRATED_PAGES.inc(n_mig)
                cat.DISAGG_MIGRATED_BYTES.inc(nbytes)
                cat.DISAGG_MIGRATION_SECONDS.observe(dt)
            except Exception:            # pragma: no cover - defensive
                pass
        if trace is not None:
            self.tracer.record("disagg_migrate", trace[0], span,
                               clock=clock, rid=rid, blocks=n_mig,
                               bytes=nbytes)
        self._flight.record("disagg_migrated", rid=rid, attempt=attempt,
                            blocks=n_mig, nbytes=nbytes,
                            ms=round(dt * 1e3, 3))

    def _store_local(self, prompt, cache, m: int, n_mig: int) -> None:
        """Adopt blocks ``[m//bt, n_mig)`` of the prefill row into the
        local pool + tree (store_cache_to_pages scatter + store_shared
        ownership adoption) so a repeat prompt migrates from cache.
        Ownership: adopted pages become tree-owned; non-adopted ones go
        straight back to the free list — idle ``used_blocks`` always
        equals ``tree.block_count`` (the prefill half of the leak
        invariant)."""
        from .kvcache.device import store_cache_to_pages

        mgr = self.kv_cache
        bt = mgr.block_tokens
        start = m // bt
        if n_mig <= start:
            return
        new_ids = mgr.alloc(n_mig - start)
        if new_ids is None:
            return              # pool pressure: reuse is best-effort
        store_cache_to_pages(self._pk, self._pv, cache.keys, cache.values,
                             np.asarray(new_ids, np.int64), start)
        # table for store_shared: matched ids are already tree-owned
        # (declined by insert); None would also work but the real ids
        # keep the assertion inside store_shared meaningful
        table: List[Optional[int]] = [None] * start + list(new_ids)
        adopted, store_lease = mgr.store_shared(prompt[:n_mig * bt],
                                                table)
        adopted_set = set(adopted)
        leftovers = [b for b in new_ids if b not in adopted_set]
        if leftovers:
            mgr.free(leftovers)
        if store_lease is not None:
            store_lease.release()

    # -- observability -----------------------------------------------------

    def debug_state(self) -> dict:
        """``GET /debugz`` fragment for the prefill role: in-flight
        handoff, backlog depth, migration counters, pool picture."""
        return {"role": "prefill",
                "inflight_handoff": self._inflight_rid,
                "handoff_backlog": len(self._backlog),
                "migration": dict(self.stats),
                "kvcache": self.kv_cache.snapshot()}

    def scrape_stats(self) -> dict:
        return {"kvcache": self.kv_cache.snapshot()}


# ---------------------------------------------------------------------------
# decode worker
# ---------------------------------------------------------------------------


class DecodeWorker:
    """Decode-only serving role: stages inbound page frames, adopts
    complete migrations into the batching engine's pool, and streams
    the joined request's tokens back to the requester.

    Partial migrations are HOST staging only — no pool pages are
    allocated until the migration is complete and CRC-verified, so a
    crashed or aborted migration holds zero pages and the §11 ownership
    invariant (``used == tree.block_count + in-flight requests'
    pages``) holds unconditionally on this side.
    """

    def __init__(self, engine, transport, stager: "PageStager" = None):
        self.engine = engine
        self.transport = transport
        self.device_id = transport.device_id
        self.tracer = TraceRecorder(f"decode:{self.device_id}")
        # (rid, attempt) page-frame staging — shared with a co-serving
        # live-migration worker when one is chained (docs/DESIGN.md §18)
        self.stager = stager or PageStager(
            self.device_id, on_evict=self._evicted)
        self._staged = self.stager._staged       # test seam (schema pin)
        # rid -> attempt that joined (re-ack + duplicate suppression).
        # BOUNDED: oldest markers evict past _JOINED_CAP — a marker
        # only matters while late retransmits/reschedules of its rid
        # can still arrive, not for the process lifetime
        from collections import OrderedDict
        self._joined: "OrderedDict[str, int]" = OrderedDict()
        self.stats = {"joined_requests": 0, "adopted_pages": 0,
                      "dropped_frames": 0, "aborted_migrations": 0,
                      "last_migration_ms": None}
        self._stop = threading.Event()
        self._flight = get_flight_recorder()

    def _evicted(self, rid: str) -> None:
        self.stats["aborted_migrations"] += 1

    _JOINED_CAP = 4096

    def _mark_joined(self, rid: str, attempt: int) -> None:
        self._joined[rid] = attempt
        self._joined.move_to_end(rid)
        while len(self._joined) > self._JOINED_CAP:
            self._joined.popitem(last=False)

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
                # one malformed frame must not take the decode worker
                # (and every future migration) down with it
                log.exception("%s: migration frame %r failed",
                              self.device_id, tag)

    # -- message handling --------------------------------------------------

    def handle_message(self, tag: str, payload: bytes) -> bool:
        """Dispatch one inbound frame; returns True when the tag was a
        migration frame this worker owns (test seam)."""
        parts = tag.split(":")
        kind = parts[0]
        if kind == "pg":
            self._on_page(parts[1], int(parts[2]), int(parts[3]),
                          payload, tag)
        elif kind == "pge":
            self._on_end(parts[1], int(parts[2]), payload, tag)
        elif kind == "pgx":
            self._on_abort(parts[1])
        else:
            return False
        return True

    def _drop(self, tag: str, why: str) -> None:
        self.stats["dropped_frames"] += 1
        cat = _disagg_metrics()
        if cat is not None:
            try:
                cat.DISAGG_DROPPED_FRAMES.inc()
            except Exception:            # pragma: no cover - defensive
                pass
        self._flight.record("disagg_frame_dropped", tag=tag, why=why)

    def _ack(self, rid: str, attempt: int, prefill_id: str,
             complete: bool, expected: int) -> None:
        body = wire.serialize_tensors(
            [np.asarray([0 if complete else 1, expected], np.int32)])
        try:
            self.transport.send(prefill_id, f"pga:{rid}:{attempt}", body)
        except TransportError:
            pass                 # sender timeout/retry path recovers

    def _on_page(self, rid: str, attempt: int, seq: int, payload: bytes,
                 tag: str) -> None:
        if rid in self._joined:
            # late retransmit / stale reschedule for a request already
            # decoding: dropped; the end frame's complete-ack keeps the
            # sender happy without a second join
            self._drop(tag, "already_joined")
            return
        status = self.stager.stage_page(rid, attempt, seq, payload, tag)
        if status in ("stale_attempt", "dedup"):
            self._drop(tag, status)

    def _on_end(self, rid: str, attempt: int, payload: bytes,
                tag: str) -> None:
        try:
            meta, tensors, ctx = _parse_meta_frame(payload)
        except wire.WireError as e:
            record_corrupt_frame(self.device_id, tag, len(payload), e)
            return
        prefill_id = meta.get("prefill_id", "")
        if rid in self._joined:
            self._ack(rid, attempt, prefill_id, True, 0)
            return
        st = self.stager.staging(rid, attempt)
        if st is None:
            self._drop(tag, "stale_attempt")
            return
        n_frames = int(meta["n_frames"])
        if st["expected"] < n_frames:
            # dropped/corrupt frames upstream: nack with the expected
            # seq so the sender retransmits exactly the missing tail
            self._ack(rid, attempt, prefill_id, False, st["expected"])
            return
        prompt = np.asarray(tensors[0], np.int32).reshape(-1)
        n_blocks = int(meta["n_blocks"])
        try:
            k_blocks, v_blocks = self.stager.concat_blocks(st, n_blocks)
        except MigrationError:
            # manifest/frames disagree — treat as a failed migration
            # rather than adopting the wrong pages
            self._drop(tag, "manifest_mismatch")
            self._ack(rid, attempt, prefill_id, False, 0)
            self.stager.clear(rid)
            return
        try:
            req = self.engine.submit_premigrated(
                prompt, int(meta["max_new"]), k_blocks, v_blocks)
        except Exception as e:
            # an admission rejection (overload shed, capacity bound) is
            # a per-REQUEST failure, never a dead decode worker: ack
            # complete (the migration itself arrived — retransmitting
            # cannot fix admission) and surface the error to the
            # requester through the ordinary fin path
            self.stager.clear(rid)
            self._mark_joined(rid, attempt)
            self._flight.record("disagg_join_rejected", rid=rid,
                                error=type(e).__name__, detail=str(e))
            self._ack(rid, attempt, prefill_id, True, st["expected"])
            try:
                self.transport.send(
                    meta["reply_to"], f"fin:{rid}",
                    _meta_frame({"rid": rid, "ok": False,
                                 "error": f"{type(e).__name__}: {e}"},
                                (np.zeros(0, np.int32),)))
            except TransportError:
                pass
            return
        self._mark_joined(rid, attempt)
        self.stager.clear(rid)
        self.stats["joined_requests"] += 1
        self.stats["adopted_pages"] += n_blocks
        dt = time.perf_counter() - st["t0"]
        self.stats["last_migration_ms"] = round(dt * 1e3, 3)
        cat = _disagg_metrics()
        if cat is not None:
            try:
                cat.DISAGG_ADOPTED_PAGES.inc(n_blocks)
                cat.DISAGG_JOINED.inc()
            except Exception:            # pragma: no cover - defensive
                pass
        if ctx is not None:
            self.tracer.record("disagg_adopt", ctx[0], ctx[1],
                               ts=time.time() - dt, dur=dt,
                               rid=rid, blocks=n_blocks)
        self._flight.record("disagg_join", rid=rid, attempt=attempt,
                            blocks=n_blocks, prompt_len=len(prompt))
        self._ack(rid, attempt, prefill_id, True, st["expected"])
        reply_to = meta["reply_to"]
        t = threading.Thread(target=self._drain, args=(req, rid, reply_to),
                             daemon=True,
                             name=f"disagg-drain-{rid}")
        t.start()

    def _on_abort(self, rid: str) -> None:
        """Abort a staged migration: the host buffers AND their byte
        accounting clear (``staged_bytes`` back to what it was before
        frame 1), and the attempt is marked aborted so a late frame of
        the same handoff drops instead of restaging a leak."""
        if rid in self._joined:
            return               # too late: the request is decoding
        st = self.stager.clear(rid)
        if st is not None:
            self.stager.mark_aborted(rid, st["attempt"])
            self.stats["aborted_migrations"] += 1
            self._flight.record("disagg_abort", rid=rid,
                                attempt=st["attempt"])

    def _drain(self, req, rid: str, reply_to: str) -> None:
        """Forward one joined request's token stream to the requester
        (its own thread: the serve loop must keep staging other
        migrations while this request decodes)."""
        idx = 0
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
        err = req.error
        meta = {"rid": rid, "ok": err is None,
                "error": None if err is None else
                f"{type(err).__name__}: {err}"}
        body = _meta_frame(meta, (np.asarray(req.tokens, np.int32),))
        try:
            self.transport.send(reply_to, f"fin:{rid}", body)
        except TransportError:
            pass

    # -- observability -----------------------------------------------------

    def debug_state(self) -> dict:
        """``GET /debugz`` fragment for the decode role: staged
        (in-flight) migrations, joined/adopted counters, the engine's
        KV picture."""
        out = {"role": "decode",
               "staged_migrations": self.stager.debug_state(),
               "staged_bytes": self.stager.staged_bytes,
               "migration": dict(self.stats)}
        try:
            out["engine"] = self.engine.debug_state()
        except Exception:                # pragma: no cover - defensive
            pass
        return out

    def scrape_stats(self) -> dict:
        return self.engine.stats()


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


class DisaggRequest:
    """One disaggregated request as the coordinator sees it."""

    def __init__(self, rid: str, prompt: np.ndarray, max_new: int,
                 worker: str):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.worker = worker          # current prefill worker
        self.attempt = 0
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first = 0.0
        self.trace_id = new_trace_id()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} did not complete")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)

    @property
    def ttft_s(self) -> Optional[float]:
        return (self.t_first - self.t_submit) if self.t_first else None


class DisaggCoordinator:
    """Request handoff + migration scheduling + crash rescheduling.

    Fronts a fleet of prefill workers and one decode worker: submits
    route round-robin over the prefill workers; a worker failure
    (signalled by supervision, a ``perr`` frame, or an undeliverable
    handoff) resends every unfinished request it held to the next
    surviving worker under a bumped attempt, and aborts the stale
    staged attempt on the decode side.  Rides the elastic machinery's
    supervision pattern: the caller watches worker liveness (thread or
    process) and calls :meth:`signal_failure`.
    """

    def __init__(self, transport, prefill_ids: List[str],
                 decode_id: str, max_attempts: int = 4):
        if not prefill_ids:
            raise ValueError("need at least one prefill worker")
        self.max_attempts = max(1, int(max_attempts))
        self.transport = transport
        self.device_id = transport.device_id
        self.prefill_ids = list(prefill_ids)
        self.decode_id = decode_id
        self.tracer = TraceRecorder(f"coord:{self.device_id}")
        import uuid
        self._session = uuid.uuid4().hex[:8]
        self._alive = set(prefill_ids)
        # LIVE requests only: finished ones are pruned in _finish so a
        # long-running coordinator's memory (and the per-token depth
        # gauge scan) stays bounded by in-flight work, not history
        self._reqs: Dict[str, DisaggRequest] = {}
        self._rr = 0
        self._n = 0
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0, "rescheduled": 0}
        self._stop = threading.Event()
        self._flight = get_flight_recorder()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name=f"disagg-coord-{self.device_id}")
        self._pump.start()

    # -- submission --------------------------------------------------------

    def _pick_worker(self) -> str:
        alive = [w for w in self.prefill_ids if w in self._alive]
        if not alive:
            raise RuntimeError("no live prefill workers")
        w = alive[self._rr % len(alive)]
        self._rr += 1
        return w

    def _live_reqs(self) -> list:
        """Locked snapshot: the pump thread prunes `_reqs` concurrently
        with submitters and scrape threads — bare iteration would race
        ('dictionary changed size during iteration')."""
        with self._lock:
            return list(self._reqs.values())

    def _queue_depth(self) -> int:
        return sum(1 for r in self._live_reqs()
                   if not r.done.is_set() and not r.t_first)

    def _set_depth_gauge(self) -> None:
        cat = _disagg_metrics()
        if cat is not None:
            reqs = self._live_reqs()
            try:
                cat.DISAGG_HANDOFF_QUEUE.set(
                    sum(1 for r in reqs
                        if not r.done.is_set() and not r.t_first))
                cat.DISAGG_INFLIGHT.set(
                    sum(1 for r in reqs if not r.done.is_set()))
            except Exception:            # pragma: no cover - defensive
                pass

    def _send_handoff(self, req: DisaggRequest) -> None:
        span = self.tracer.next_span_id()
        self.tracer.record("disagg_submit", req.trace_id, 0,
                           span_id=span, rid=req.rid,
                           attempt=req.attempt, worker=req.worker)
        meta = {"rid": req.rid, "attempt": req.attempt,
                "max_new": req.max_new, "decode_id": self.decode_id,
                "reply_to": self.device_id}
        body = _meta_frame(meta, (req.prompt,),
                           trace=(req.trace_id, span))
        self.transport.send(req.worker,
                            f"dreq:{req.rid}:{req.attempt}", body)

    def submit(self, prompt_ids, max_new: int) -> DisaggRequest:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        with self._lock:
            # salted per coordinator INSTANCE: a restarted client's
            # 'r0' must not collide with the previous session's in the
            # decode worker's per-rid joined/staged dedup state (a
            # collision would drop the new migration as already_joined)
            rid = f"r{self._session}-{self._n}"
            self._n += 1
            req = DisaggRequest(rid, prompt, max_new, self._pick_worker())
            self._reqs[rid] = req
            self.stats["submitted"] += 1
        self._flight.record("disagg_submit", rid=rid, worker=req.worker,
                            prompt_len=len(prompt))
        try:
            self._send_handoff(req)
        except TransportError:
            self._reschedule_locked_safe(req)
        self._set_depth_gauge()
        return req

    def generate(self, prompts, max_new: int,
                 timeout: float = 120.0) -> List[np.ndarray]:
        """Submit every row and wait for all (bench/test convenience)."""
        reqs = [self.submit(p, max_new) for p in prompts]
        return [r.wait(timeout=timeout) for r in reqs]

    # -- failure handling --------------------------------------------------

    def signal_failure(self, prefill_id: str) -> None:
        """A prefill worker died: reschedule its unfinished handoffs
        (requests already streaming tokens stay with the decode worker
        — their prefill is done)."""
        with self._lock:
            self._alive.discard(prefill_id)
            victims = [r for r in self._reqs.values()
                       if r.worker == prefill_id and not r.done.is_set()
                       and not r.t_first]
        for req in victims:
            self._reschedule_locked_safe(req)

    def _reschedule_locked_safe(self, req: DisaggRequest) -> None:
        with self._lock:
            req.attempt += 1
            fail: Optional[BaseException] = None
            if req.attempt >= self.max_attempts:
                # bounded: a persistently failing handoff (e.g. a DEAD
                # decode side — every prefill worker would fail the
                # same way) must terminally fail the request, not churn
                # full prefills forever
                fail = MigrationError(
                    f"request {req.rid} failed {req.attempt} handoff "
                    f"attempts (max_attempts={self.max_attempts})")
            else:
                try:
                    req.worker = self._pick_worker()
                except RuntimeError as e:
                    fail = e
            if fail is None:
                self.stats["rescheduled"] += 1
        if fail is not None:
            self._finish(req, error=fail)
            return
        cat = _disagg_metrics()
        if cat is not None:
            try:
                cat.DISAGG_RESCHEDULED.inc()
            except Exception:            # pragma: no cover - defensive
                pass
        self._flight.record("disagg_reschedule", rid=req.rid,
                            attempt=req.attempt, worker=req.worker)
        # stale staged frames on the decode side are superseded by the
        # new attempt anyway; the abort just frees the staging promptly
        self._abort_decode(req.rid)
        try:
            self._send_handoff(req)
        except TransportError as e:
            self._finish(req, error=e)

    def _abort_decode(self, rid: str) -> None:
        try:
            self.transport.send(self.decode_id, f"pgx:{rid}", b"")
        except TransportError:
            pass

    def _finish(self, req: DisaggRequest,
                error: Optional[BaseException] = None) -> None:
        """Complete a request and PRUNE it from the live table: late
        tok/fin/perr frames for a finished rid fall through the dict
        lookup and are ignored, and the table only ever holds in-flight
        work.  A terminal FAILURE also aborts the decode side so a
        half-staged migration's host buffers are freed promptly (the
        decode worker's staging cap is the backstop).  Never called
        with self._lock held."""
        if error is not None:
            req.error = error
            self._abort_decode(req.rid)
        req.done.set()
        with self._lock:
            self._reqs.pop(req.rid, None)
        self._set_depth_gauge()

    # -- inbound pump ------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                tag, payload = self.transport.recv_any(timeout=0.1)
            except TransportTimeout:
                continue
            try:
                self._dispatch(tag, payload)
            except Exception:            # pragma: no cover - defensive
                log.exception("coordinator dispatch failed for %r", tag)

    def _dispatch(self, tag: str, payload: bytes) -> None:
        parts = tag.split(":")
        kind = parts[0]
        if kind == "tok":
            rid, idx = parts[1], int(parts[2])
            req = self._reqs.get(rid)
            if req is None or req.done.is_set():
                return
            if idx == len(req.tokens):   # (rid, step) dedup
                req.tokens.append(wire.deserialize_token(payload))
                if idx == 0:
                    req.t_first = time.perf_counter()
                    self._set_depth_gauge()
        elif kind == "fin":
            try:
                meta, tensors, _ = _parse_meta_frame(payload)
            except wire.WireError as e:
                record_corrupt_frame(self.device_id, tag, len(payload), e)
                return
            req = self._reqs.get(parts[1])
            if req is None or req.done.is_set():
                return
            err = None
            if meta.get("ok"):
                req.tokens = [int(t) for t in
                              np.asarray(tensors[0]).reshape(-1)]
                if not req.t_first:
                    req.t_first = time.perf_counter()
            else:
                err = RuntimeError(
                    meta.get("error") or "decode-side failure")
            self.stats["completed"] += 1
            self._finish(req, error=err)
        elif kind == "perr":
            req = self._reqs.get(parts[1])
            if req is not None and not req.done.is_set():
                self._reschedule_locked_safe(req)

    # -- observability / lifecycle -----------------------------------------

    def debug_state(self) -> dict:
        with self._lock:
            inflight = {r.rid: {"worker": r.worker, "attempt": r.attempt,
                                "tokens": len(r.tokens)}
                        for r in self._reqs.values()
                        if not r.done.is_set()}
        return {"role": "coordinator", "inflight": inflight,
                "handoff_queue_depth": self._queue_depth(),
                "alive_prefill_workers": sorted(self._alive),
                "stats": dict(self.stats)}

    def close(self) -> None:
        self._stop.set()
        self._pump.join(timeout=2.0)
