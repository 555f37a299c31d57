"""Distributed pipeline inference: the ring token loop over a transport.

Counterpart of ``distributed_inference_demo_tpu/runtime/distributed.py``
(the reference's hot path ``Communication.running`` → ``multiSteps`` →
``OneStep``, SURVEY.md §3.3): the header embeds and runs its layer range,
hidden states hop stage to stage, the tail samples, and the token id
rides the ring back to the header.  As in the reference:

- **KV-cached decode** at every stage: each step moves a [b, 1, H]
  hidden row.  A stage's KV lives in ONE page pool
  ``[L_stage, N + 1, H_kv, bt, D]`` (page N is the drop page) behind the
  port's paged seam (``parallel.tensor.make_paged_forward_seam``), so
  on the card the prompt chunk launches ``paged_prefill_mma_kernel`` and
  every one-token hop ``paged_decode_split_kernel``.
- **In-flight samples are tags, not socket sets**: ``pool_size``
  requests interleave through the same transport edges, each with its
  own block table in every stage's pool.
- **Sampling at the tail** with a stream per (rid, step): the port's
  ``torch.Generator`` is seeded by a fixed mix of (seed, rid, step) on
  the stage's device (the reference folds (rid, step) into a JAX key).
  The fused tail and the split pair draw the same tokens, interleaved
  rids do not perturb each other, and a relaunch redraws the same
  tokens.  Greedy tokens equal the reference's; sampled tokens are
  equal in distribution.
- All receives carry timeouts.

Stages run eagerly.  Messages are wire bytes even in one process: a
hidden chunk leaves the card with one explicit copy
(``StageStats.record_host_copy``) and a bf16 chunk travels as its uint16
bits under the wire's bf16 code, so a port stage and a reference stage
sit in one chain.

Message tags (payloads are wire.py tensor messages):

- ``h:{rid}:{step}``   hidden chunk (step 0 = prefill, else one token row)
- ``tok:{rid}:{step}`` sampled [b] token ids, tail → header
- ``c:{rid}``          classification chunk: [hidden, label_token_ids];
  the tail answers ``ctok:{rid}`` with argmax-over-labels indices
- ``end:{rid}``        free the request's pages, forwarded along the chain
- ``stop``             shut down the worker loop, forwarded along the chain
- ``statsreq``         forwarded along the chain; every non-header stage
  replies to the header with a ``statsrep:{device_id}`` JSON snapshot
"""

from __future__ import annotations

import json
import logging
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..comm import wire
from ..comm.transport import (BaseTransport, TransportTimeout,
                              record_corrupt_frame)
from ..device import resolve_device
from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..ops.sampling import SamplingParams, sample_logits
from ..telemetry import postmortem
from ..telemetry import profiling as _profiling
from ..telemetry.flightrecorder import get_flight_recorder
from ..telemetry.tracing import SpanClock, TraceRecorder, new_trace_id
from .disagg import _from_wire, _to_wire
from .stats import StageStats

log = logging.getLogger(__name__)

DEFAULT_STEP_TIMEOUT = 120.0

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, rid: int, step: int) -> int:
    """The sampling stream of one (rid, step) at a tail seeded ``seed``:
    a fixed mix, so any stage built with the same seed redraws it."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(rid) & _MASK64))
    h = _splitmix64(h ^ (int(step) & _MASK64))
    return h & ((1 << 63) - 1)


class StageRuntime:
    """Compute for one stage over its page pool, with a block table per
    request id.

    ``kv_cache_dtype`` ("float8_e4m3fn") stores the pool as float8;
    ``kv_dtype`` ("bf16", "int8", "int4"; None: ``DWT_KV_DTYPE``) is the
    pages' width; the two do not compose.  Pool size:
    ``DWT_STAGE_KV_BLOCKS`` (default ``DWT_STAGE_KV_ROWS`` = 16 rows'
    worth of ``max_seq``); pages come from ``DWT_KVCACHE_BLOCK_TOKENS``.
    Pages are reserved per chunk actually run and returned on
    ``end:{rid}``; exhaustion raises rather than evict live KV.
    ``kv_layout`` takes the reference's only value, "paged".
    ``attn_backend`` is the paged hook's ("auto", "cuda", "plain").
    ``device``: CUDA unless "cpu" is asked for; ``params`` live there.

    ``launches`` counts this stage's own paged kernel launches
    (``{"decode": n, "prefill": n}``), apart from the wrappers'
    process-wide counters, which every stage of a process bumps; under
    a tp mesh, rank 0's (``parallel.tensor.rank_launches`` reads every
    rank's).

    ``mesh``: a local tp mesh (``parallel.mesh.local_tp_mesh``): the
    stage's layer range runs with Megatron-sliced weights
    (``parallel.tensor.distribute_params``) and its page pool on
    kv-head shards, every rank its plane (``make_paged_forward_seam``
    over the mesh), the way ``ContinuousBatchingEngine`` runs one.  The
    block tables stay on rank 0's host and go out with each forward;
    the wire stays ``[b, s, H]`` (replicated activations), one
    device-to-host copy a hop at rank 0."""

    def __init__(self, cfg: ModelConfig, spec: StageSpec, params: StageParams,
                 max_seq: int, sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, kv_cache_dtype=None, kv_layout=None,
                 kv_dtype=None, attn_backend: str = "auto", device=None,
                 mesh=None):
        from ..ops.quant import resolve_kv_cache_dtype, resolve_kv_dtype
        from ..parallel.tensor import validate_tp
        from .kvcache import resolve_kv_layout
        self.cfg = cfg
        self.mesh = mesh
        self._tp = validate_tp(cfg, mesh)
        self.max_seq = max_seq
        self.sampling = sampling
        self.device = resolve_device(device)
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        if self.kv_dtype != "bf16" and self.kv_cache_dtype is not None:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} quantizes the stage page "
                "pool and cannot compose with a kv_cache_dtype storage "
                f"cast ({self.kv_cache_dtype}); drop one of the two knobs")
        self.kv_layout = resolve_kv_layout(kv_layout)
        self.attn_backend = attn_backend
        self.seed = int(seed)
        if self._tp > 1 and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the stage "
                             f"on {self.device}")
        self.launches = {"decode": 0, "prefill": 0}
        self._prof = _profiling.get_profiler()
        self._pk = self._pv = None
        self._own_params = False
        self._build(spec, params)

    def _build(self, spec: StageSpec, params: StageParams) -> None:
        """Pool, seam and tables for ``spec``'s layer range: any earlier
        pool (and, under a tp mesh, the weights this stage sharded) is
        dropped on every rank before the new one is allocated."""
        from ..ops.quant import alloc_kv_pages
        from ..parallel.tensor import (alloc_tp_kv, make_paged_forward_seam)
        from ..telemetry._env import env_int
        from .kvcache import resolve_kvcache_config
        cfg = self.cfg
        p_dev = next(v for v in params.layers.values()
                     if torch.is_tensor(v)).device
        if p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, the stage on "
                             f"{self.device}")
        self.free_tp()
        if self._tp > 1:
            from .engine import engine_params_for_mesh
            sharded = engine_params_for_mesh(params, cfg, self.mesh)
            self._own_params = sharded is not params
            params = sharded
        self.spec = spec
        self.params = params
        _, bt = resolve_kvcache_config(None, None)
        g = math.lcm(8, bt)
        S = -(-self.max_seq // g) * g
        self._bt, self._table_width = bt, S // bt
        rows = env_int("DWT_STAGE_KV_ROWS", 16)
        n_blocks = env_int("DWT_STAGE_KV_BLOCKS", rows * self._table_width)
        page_dtype = self.kv_cache_dtype or cfg.dtype
        shape = (spec.num_layers, n_blocks + 1, cfg.num_kv_heads, bt,
                 cfg.head_dim)
        if self._tp > 1:
            self._pk, self._pv = alloc_tp_kv(self.mesh, "pages", shape,
                                             page_dtype, self.kv_dtype)
        else:
            self._pk = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                      self.device)
            self._pv = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                      self.device)
        self._fwd, self._bind, _ = make_paged_forward_seam(
            cfg, spec, self.mesh, params, bt, self.attn_backend,
            num_pages=n_blocks, device_type=self.device.type,
            launches=self.launches)
        self._sentinel = n_blocks
        self._pool_free = list(range(n_blocks - 1, -1, -1))
        self._tables: Dict[int, np.ndarray] = {}
        self._rid_len: Dict[int, int] = {}
        self._rid_blocks: Dict[int, int] = {}
        # DWT_RING_FUSED_TAIL=0 restores the split forward-then-sample
        # pair (the parity reference of the fused tail)
        self.fused_tail = (spec.is_last
                           and env_int("DWT_RING_FUSED_TAIL", 1) != 0)
        self._kv_token_bytes = _profiling.kv_dispatch_bytes(
            1, spec.num_layers, cfg.num_kv_heads, cfg.head_dim,
            self.kv_dtype, page_dtype)

    # -- the page pool ---------------------------------------------------

    @property
    def num_pages(self) -> int:
        return self._sentinel

    @property
    def pages_free(self) -> int:
        return len(self._pool_free)

    def _paged_chunk_state(self, rid: int, batch: int, s: int):
        """(table, length) for this rid's next ``s``-token chunk,
        growing its block table from the stage pool first.  The grow is
        all-or-nothing: a refused chunk leaves the pool as it was."""
        tbl = self._tables.get(rid)
        if tbl is None:
            tbl = np.full((batch, self._table_width), self._sentinel,
                          np.int32)
            self._tables[rid] = tbl
        cur = self._rid_len.get(rid, 0)
        need = -(-(cur + s) // self._bt)
        have = self._rid_blocks.get(rid, 0)
        if need > self._table_width:
            raise RuntimeError(
                f"rid {rid} needs {need} KV blocks but the stage table "
                f"is {self._table_width} wide (max_seq {self.max_seq})")
        grow = (need - have) * batch
        if grow > len(self._pool_free):
            raise RuntimeError(
                "stage page pool exhausted: raise "
                "DWT_STAGE_KV_BLOCKS (or DWT_STAGE_KV_ROWS) — "
                "refusing to evict live request KV")
        for j in range(have, need):
            for row in range(batch):
                tbl[row, j] = self._pool_free.pop()
        self._rid_blocks[rid] = max(have, need)
        return tbl, cur

    def _sample_stage_hbm(self) -> None:
        """One HBM-watermark sample for this stage's page pool, per chunk
        served (host integer math only)."""
        used = self._sentinel - len(self._pool_free)
        _profiling.get_hbm_watermarks().sample(
            "stage_pool", used * self._bt * self._kv_token_bytes)

    def _input(self, inputs) -> torch.Tensor:
        """A chunk as this stage takes it: ids as int64, hidden rows in
        the dtype they came in (``stage_forward`` casts them)."""
        x = inputs if torch.is_tensor(inputs) else _from_wire(inputs)
        x = x.to(self.device)
        return x if torch.is_floating_point(x) else x.long()

    def run_chunk(self, rid: int, inputs) -> torch.Tensor:
        """Run this stage on a chunk ([b, s] ids or [b, s, H] hidden,
        numpy or torch); the request's pages take its K/V in place.
        Returns hidden [b, s, H] on the device (last-position logits
        [b, V] on the tail)."""
        x = self._input(inputs)
        b, s = x.shape[0], x.shape[1]
        tbl, cur = self._paged_chunk_state(rid, b, s)
        self._bind(torch.from_numpy(tbl).to(self.device))
        pos = (cur + torch.arange(s, device=self.device)).expand(b, s)
        out, _ = self._fwd(self.params, x, KVCache(self._pk, self._pv, cur),
                           pos, self.spec.is_last)
        self._rid_len[rid] = cur + s
        self._sample_stage_hbm()
        return out[:, -1] if self.spec.is_last else out

    def _generator(self, rid: int, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, rid, step))

    def sample_tokens(self, rid: int, step: int, last_logits) -> np.ndarray:
        """[b] int32 token ids drawn from the (rid, step) stream."""
        gen = None if self.sampling.greedy else self._generator(rid, step)
        tok = sample_logits(last_logits, gen, self.sampling)
        return tok.to(torch.int32).cpu().numpy()

    def run_chunk_sample(self, rid: int, step: int, inputs) -> np.ndarray:
        """Tail-only fused step: this stage's forward and the draw, one
        call, under the ``ring_chunk_sample`` dispatch signature.  The
        stream is :meth:`sample_tokens`'s, so fused and split tails emit
        bit-identical tokens."""
        b, s = inputs.shape[0], inputs.shape[1]
        sig = _profiling.dispatch_signature(
            "ring_chunk_sample", batch=b, chunk=s, kv_dtype=self.kv_dtype)
        t0 = self._prof.begin(sig)
        cur = self._rid_len.get(rid, 0)
        tok = self.sample_tokens(rid, step, self.run_chunk(rid, inputs))
        # the host copy of the tokens synced; the chunk attends the rid's
        # whole KV prefix and writes s new tokens
        self._prof.end(sig, t0, hbm_bytes=(
            b * (cur + s) * self._kv_token_bytes))
        return tok

    def free(self, rid: int) -> None:
        tbl = self._tables.pop(rid, None)
        self._rid_len.pop(rid, None)
        self._rid_blocks.pop(rid, None)
        if tbl is not None:
            self._pool_free.extend(
                int(v) for v in tbl.flat if v != self._sentinel)

    def reset_caches(self) -> None:
        """Hand every request's pages back to the pool (reshard,
        restart)."""
        for rid in list(self._tables):
            self.free(rid)

    def free_tp(self) -> None:
        """Under a tp mesh: drop this stage's pool, its forward's hooks
        and the weights it sharded on every rank (a reassign, a
        shutdown).  A no-op off a
        mesh, or once the mesh is closed."""
        if self._tp <= 1 or self._pk is None or self.mesh.closed:
            return
        from ..parallel.tensor import free_tp
        objs = [self._pk, self._pv, self._fwd]
        if self._own_params:
            objs.append(self.params)
        free_tp(self.mesh, *objs)
        self._pk = self._pv = None


def _h_tag(rid: int, step: int) -> str:
    return f"h:{rid}:{step}"


def _tok_tag(rid: int, step: int) -> str:
    return f"tok:{rid}:{step}"


def _host(stats: StageStats, out: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of an outgoing chunk, timed and
    counted, as the wire's array (a fresh host tensor: no frame holds a
    view of a device buffer)."""
    t0 = time.perf_counter()
    host = out.detach().to("cpu", copy=True)
    stats.record_host_copy(time.perf_counter() - t0,
                           host.numel() * host.element_size())
    return _to_wire(host)


class PipelineWorker:
    """A non-header stage: recv → run layer range → send onward; the tail
    additionally samples and returns tokens to the header."""

    def __init__(self, runtime: StageRuntime, transport: BaseTransport,
                 next_id: Optional[str], header_id: str,
                 step_timeout: float = DEFAULT_STEP_TIMEOUT):
        self.rt = runtime
        self.transport = transport
        self.next_id = next_id          # None on the tail
        self.header_id = header_id
        self.step_timeout = step_timeout
        role = "tail" if runtime.spec.is_last else "worker"
        self.stats = StageStats(role=role)
        self.tracer = TraceRecorder(f"{role}:{transport.device_id}")
        self.flight = get_flight_recorder()
        self.tail_dispatches = 0   # host dispatches spent sampling
        self._last_wait: Optional[float] = None  # serve loop's recv wait
        self._last_wait_start: Optional[float] = None  # its wall start
        # per-rid expected next step: the pages are append-only, so a
        # duplicated or out-of-order hidden chunk must be dropped, never
        # run twice.  The first frame of a request (or a relaunch after a
        # reshard, which arrives at a mid-stream step) is accepted at any
        # step; after that, steps must advance by exactly one.
        self._next_step: Dict[int, int] = {}

    def _forward_control(self, tag: str, payload: bytes = b"") -> None:
        if self.next_id is not None:
            self.transport.send(self.next_id, tag, payload)

    def _count_tail_dispatches(self, dispatches: int) -> None:
        """Per-token host-dispatch accounting on the tail: 1 on the fused
        forward+sample path, 2 on the split pair."""
        from .engine import count_device_loop
        self.tail_dispatches += dispatches
        count_device_loop("PipelineWorkerTail", 1, dispatches)

    # tag factories: the elastic runtime appends a reshard epoch
    def _make_h_tag(self, rid: int, step: int) -> str:
        return _h_tag(rid, step)

    def _make_tok_tag(self, rid: int, step: int) -> str:
        return _tok_tag(rid, step)

    def serve_forever(self, idle_timeout: Optional[float] = None) -> None:
        """Loop until a ``stop`` message arrives; returns cleanly if
        ``idle_timeout``/step_timeout expires with no traffic at all."""
        while True:
            t0_wall = time.time()
            t0 = time.perf_counter()
            try:
                tag, payload = self.transport.recv_any(
                    timeout=idle_timeout or self.step_timeout)
            except TransportTimeout:
                log.info("worker %s: idle timeout, exiting",
                         self.transport.device_id)
                return
            wait = time.perf_counter() - t0
            self.stats.record_recv(wait, len(payload))
            self._last_wait = wait
            self._last_wait_start = t0_wall
            if not self.handle_message(tag, payload):
                return

    def handle_message(self, tag: str, payload: bytes) -> bool:
        """Process one message; returns False on ``stop``."""
        kind, _, rest = tag.partition(":")
        if kind == "stop":
            self.flight.record("worker_stop",
                               stage=self.transport.device_id)
            self._forward_control(tag)
            return False
        if kind == "end":
            rid = int(rest.split(":")[0])
            self.rt.free(rid)
            self._next_step.pop(rid, None)
            self._forward_control(tag)
            return True
        if kind == "statsreq":
            from ..comm.transport import TransportError
            snap = dict(self.stats.snapshot(include_samples=True),
                        device_id=self.transport.device_id,
                        seq=rest)
            spans = None
            if payload == b"spans":
                # trace collection rides the stats poll: spans drain into
                # the reply at most once
                spans = snap["spans"] = self.tracer.drain()
            try:
                self.transport.send(
                    self.header_id,
                    f"statsrep:{self.transport.device_id}",
                    json.dumps(snap).encode("utf-8"))
            except TransportError:
                if spans:
                    for s in spans:      # keep them for the next poll
                        self.tracer.record(
                            s["name"], s["trace_id"], s["parent_id"],
                            ts=s["ts_us"] / 1e6, dur=s["dur_us"] / 1e6,
                            span_id=s["span_id"], **(s.get("args") or {}))
                raise
            self._forward_control(tag, payload)
            return True
        if kind == "statsreset":
            self.stats.reset()
            self._forward_control(tag)
            return True
        if kind == "c":
            self._run_classify(int(rest.split(":")[0]), payload)
            return True
        if kind != "h":
            log.warning("worker %s: unexpected tag %r",
                        self.transport.device_id, tag)
            return True
        fields = rest.split(":")
        rid, step = int(fields[0]), int(fields[1])
        self._run_and_forward(rid, step, payload)
        return True

    def _record_hop_spans(self, ctx, compute_span: int, t_wall: float,
                          compute_s: float, rid: int, step: int) -> None:
        """recv_wait + compute spans for one traced hop; ``compute_span``
        was minted before serialization so the outbound trailer could
        name it as the downstream parent."""
        trace_id, parent = ctx
        if self._last_wait is not None:
            start = (self._last_wait_start
                     if self._last_wait_start is not None
                     else t_wall - self._last_wait)
            self.tracer.record("recv_wait", trace_id, parent, ts=start,
                               dur=self._last_wait, rid=rid, step=step)
            self._last_wait = None
            self._last_wait_start = None
        self.tracer.record("compute", trace_id, parent, ts=t_wall,
                           dur=compute_s, span_id=compute_span,
                           rid=rid, step=step)

    def _traced_send(self, ctx, compute_span: int, dest: str, tag: str,
                     body: bytes, rid: int, step: int) -> None:
        t_s = SpanClock()
        with t_s:
            self.transport.send(dest, tag, body)
        self.stats.record_send(t_s.seconds, len(body))
        self.flight.record("hop_send", stage=self.transport.device_id,
                           rid=rid, step=step, dest=dest,
                           nbytes=len(body))
        if ctx is not None:
            self.tracer.record("send", ctx[0], compute_span, clock=t_s,
                               rid=rid, step=step, dest=dest)

    def _run_and_forward(self, rid: int, step: int, payload: bytes) -> None:
        expected = self._next_step.get(rid)
        if expected is not None and step != expected:
            # a duplicate or out-of-order frame would append to the pages
            # twice: drop it; a genuinely lost frame surfaces as a stall
            self.flight.record("dup_frame_dropped",
                               stage=self.transport.device_id,
                               rid=rid, step=step, expected=expected)
            log.info("worker %s: dropping duplicate/out-of-order frame "
                     "rid=%d step=%d (expected %d)",
                     self.transport.device_id, rid, step, expected)
            return
        self.flight.record("hop_recv", stage=self.transport.device_id,
                           rid=rid, step=step, nbytes=len(payload))
        try:
            tensors, ctx = wire.split_trace_context(
                wire.deserialize_tensors(payload))
        except wire.WireIntegrityError as e:
            # counted, flight-recorded and dropped: the header's stall
            # recovery retransmits this step
            record_corrupt_frame(self.transport.device_id,
                                 self._make_h_tag(rid, step),
                                 len(payload), e)
            return
        t_c = SpanClock()
        with t_c:
            [x] = tensors
            if self.rt.fused_tail:
                toks = self.rt.run_chunk_sample(rid, step, x)
                self._next_step[rid] = step + 1
                self._count_tail_dispatches(1)
                result = [toks]
                dest, tag = self.header_id, self._make_tok_tag(rid, step)
            else:
                out = self.rt.run_chunk(rid, x)
                self._next_step[rid] = step + 1
                if self.rt.spec.is_last:
                    result = [self.rt.sample_tokens(rid, step, out)]
                    self._count_tail_dispatches(2)
                    dest, tag = self.header_id, self._make_tok_tag(rid,
                                                                   step)
                else:
                    result = [_host(self.stats, out)]
                    dest, tag = self.next_id, self._make_h_tag(rid, step)
            compute_span = self.tracer.next_span_id() if ctx else 0
            body = (wire.serialize_tensors_traced(result, ctx[0],
                                                  compute_span)
                    if ctx else wire.serialize_tensors(result))
        self.stats.record_compute(t_c.seconds)
        if ctx is not None:
            self._record_hop_spans(ctx, compute_span, t_c.ts, t_c.seconds,
                                   rid, step)
        self._traced_send(ctx, compute_span, dest, tag, body, rid, step)

    def _run_classify(self, rid: int, payload: bytes) -> None:
        """Classification hop: payload = [chunk, label_token_ids].  The
        tail answers the header with argmax-over-label-logits indices;
        other stages forward."""
        self.flight.record("hop_recv", stage=self.transport.device_id,
                           rid=rid, step=0, nbytes=len(payload),
                           classify=True)
        try:
            tensors, ctx = wire.split_trace_context(
                wire.deserialize_tensors(payload))
        except wire.WireIntegrityError as e:
            record_corrupt_frame(self.transport.device_id, f"c:{rid}",
                                 len(payload), e)
            return
        t_c = SpanClock()
        with t_c:
            x, label_ids = tensors
            out = self.rt.run_chunk(rid, x)
            if self.rt.spec.is_last:
                sub = out[:, torch.as_tensor(label_ids.astype(np.int64),
                                             device=out.device)]
                pred = torch.argmax(sub, dim=-1).to(torch.int32)
                result = [pred.cpu().numpy()]
                dest, tag = self.header_id, f"ctok:{rid}"
            else:
                result = [_host(self.stats, out), label_ids]
                dest, tag = self.next_id, f"c:{rid}"
            compute_span = self.tracer.next_span_id() if ctx else 0
            body = (wire.serialize_tensors_traced(result, ctx[0],
                                                  compute_span)
                    if ctx else wire.serialize_tensors(result))
        self.stats.record_compute(t_c.seconds)
        if ctx is not None:
            self._record_hop_spans(ctx, compute_span, t_c.ts, t_c.seconds,
                                   rid, 0)
        self._traced_send(ctx, compute_span, dest, tag, body, rid, 0)


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray                 # [b, s] int32
    max_new_tokens: int
    tokens: List[np.ndarray] = None    # collected [b] arrays
    step: int = 0
    done: bool = False
    trace_id: int = 0                  # telemetry: ring-propagated id

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = []


class PipelineHeader:
    """The header role: owns stage 0, tokenized inputs, the request window,
    and token collection (``Communication.running``'s driver half)."""

    def __init__(self, runtime: StageRuntime, transport: BaseTransport,
                 next_id: str, eos_id: Optional[int] = None,
                 step_timeout: float = DEFAULT_STEP_TIMEOUT):
        if not runtime.spec.is_first:
            raise ValueError("header must own stage 0")
        self.rt = runtime
        self.transport = transport
        self.next_id = next_id
        self.eos_id = eos_id
        self.step_timeout = step_timeout
        self._next_rid = 0
        self.stats = StageStats(role="header")
        self.tracer = TraceRecorder(f"header:{transport.device_id}")
        self.flight = get_flight_recorder()
        self._sent_at: Dict[tuple, float] = {}  # (rid, step) -> send time
        # (rid, step) -> (trace_id, send span id, epoch ts of send end);
        # the ring_rtt span's start/identity when the token comes back
        self._rtt_ctx: Dict[tuple, tuple] = {}
        self._next_stats_seq = 0

    def _make_h_tag(self, rid: int, step: int) -> str:
        return _h_tag(rid, step)

    def _send_hidden(self, rid: int, step: int, hidden: np.ndarray,
                     trace_id: int = 0, parent_id: int = 0) -> None:
        send_span = self.tracer.next_span_id() if trace_id else 0
        body = wire.serialize_tensors_traced(
            [hidden], trace_id or None, send_span)
        t_s = SpanClock()
        with t_s:
            self.transport.send(self.next_id, self._make_h_tag(rid, step),
                                body)
        self.stats.record_send(t_s.seconds, len(body))
        self.flight.record("hop_send", stage=self.transport.device_id,
                           rid=rid, step=step, dest=self.next_id,
                           nbytes=len(body))
        self._sent_at[(rid, step)] = time.perf_counter()
        if trace_id:
            self.tracer.record("send", trace_id, parent_id, clock=t_s,
                               span_id=send_span, rid=rid, step=step)
            self._rtt_ctx[(rid, step)] = (trace_id, send_span, time.time())

    def _prefill_array(self, req: _Request) -> np.ndarray:
        """Stage-0 prefill input for this request: its token ids."""
        return req.prompt.astype(np.int32)

    def _launch(self, req: _Request) -> None:
        t_c = SpanClock()
        with t_c:
            hidden = _host(self.stats, self.rt.run_chunk(
                req.rid, self._prefill_array(req)))
        self.stats.record_compute(t_c.seconds)
        parent = 0
        if req.trace_id:
            parent = self.tracer.record(
                "compute", req.trace_id, clock=t_c,
                rid=req.rid, step=0, phase="prefill")
        self._send_hidden(req.rid, 0, hidden, req.trace_id, parent)

    def _record_rtt(self, rid: int, step: int) -> None:
        """Token (or classify reply) returned: close the ring-RTT timer
        and its span."""
        sent = self._sent_at.pop((rid, step), None)
        rtt_ctx = self._rtt_ctx.pop((rid, step), None)
        if sent is None:
            return
        dt = time.perf_counter() - sent
        self.stats.record_rtt(dt)
        if rtt_ctx is not None:
            trace_id, send_span, ts0 = rtt_ctx
            self.tracer.record("ring_rtt", trace_id, send_span, ts=ts0,
                               dur=dt, rid=rid, step=step)

    def _advance(self, req: _Request, toks: np.ndarray) -> None:
        """Got step's tokens; either issue the next decode chunk or finish."""
        self._record_rtt(req.rid, req.step)
        req.tokens.append(toks)
        req.step += 1
        if req.step >= req.max_new_tokens or (
                self.eos_id is not None
                and bool(np.all(toks == self.eos_id))):
            req.done = True
            self.transport.send(self.next_id, f"end:{req.rid}", b"")
            self.rt.free(req.rid)
            self._sent_at = {k: v for k, v in self._sent_at.items()
                             if k[0] != req.rid}
            self._rtt_ctx = {k: v for k, v in self._rtt_ctx.items()
                             if k[0] != req.rid}
            return
        t_c = SpanClock()
        with t_c:
            hidden = _host(self.stats, self.rt.run_chunk(
                req.rid, toks[:, None].astype(np.int32)))
        self.stats.record_compute(t_c.seconds)
        parent = 0
        if req.trace_id:
            parent = self.tracer.record(
                "compute", req.trace_id, clock=t_c,
                rid=req.rid, step=req.step, phase="decode")
        self._send_hidden(req.rid, req.step, hidden, req.trace_id, parent)

    def _make_requests(self, prompts: Sequence[np.ndarray],
                       max_new_tokens) -> List[_Request]:
        """Capacity-check every prompt and mint _Requests with fresh rids.

        ``max_new_tokens``: one int for every prompt, or a per-prompt
        sequence (the dynamic-batching backend groups requests with
        different lengths into one window)."""
        if isinstance(max_new_tokens, (int, np.integer)):
            per = [max_new_tokens] * len(prompts)
        else:
            per = [int(n) for n in max_new_tokens]
            if len(per) != len(prompts):
                raise ValueError(
                    f"{len(per)} max_new_tokens for {len(prompts)} prompts")
        for p, mn in zip(prompts, per):
            need = p.shape[1] + mn
            if need > self.rt.max_seq:
                raise ValueError(
                    f"prompt ({p.shape[1]}) + new ({mn}) = "
                    f"{need} exceeds KV capacity {self.rt.max_seq}")
        pending = [
            _Request(rid=self._next_rid + i, prompt=np.asarray(p),
                     max_new_tokens=mn, trace_id=new_trace_id())
            for i, (p, mn) in enumerate(zip(prompts, per))]
        self._next_rid += len(pending)
        return pending

    def _stall_postmortem(self, phase: str) -> None:
        """A ring step timed out with work in flight: record the stall
        into the flight ring and capture a postmortem bundle naming the
        requests still awaiting their reply."""
        in_flight = [[r, s] for r, s in sorted(self._sent_at.keys())]
        self.flight.record("pipeline_stall",
                           stage=self.transport.device_id, phase=phase,
                           in_flight=in_flight,
                           step_timeout_s=self.step_timeout)
        postmortem.trigger(
            "pipeline_stall",
            detail={"stage": self.transport.device_id, "phase": phase,
                    "in_flight": in_flight,
                    "step_timeout_s": self.step_timeout},
            spans=self.tracer.snapshot())

    def generate_many(self, prompts: Sequence[np.ndarray],
                      max_new_tokens: int,
                      pool_size: int = 1,
                      on_token=None) -> List[np.ndarray]:
        """Generate for all prompts with ``pool_size`` requests in flight.
        Returns [b, new_tokens] arrays in prompt order.

        ``on_token(prompt_index, step, tokens)`` fires as each step's
        tokens arrive."""
        pending = self._make_requests(prompts, max_new_tokens)
        rid_to_index = {req.rid: i for i, req in enumerate(pending)}
        queue = list(pending)
        in_flight: Dict[int, _Request] = {}

        while queue or in_flight:
            while queue and len(in_flight) < pool_size:
                req = queue.pop(0)
                in_flight[req.rid] = req
                self._launch(req)
            t0 = time.perf_counter()
            try:
                tag, payload = self.transport.recv_any(
                    timeout=self.step_timeout)
            except TransportTimeout:
                self._stall_postmortem("generate")
                raise
            self.stats.record_recv(time.perf_counter() - t0, len(payload))
            kind, _, rest = tag.partition(":")
            if kind != "tok":
                log.warning("header: unexpected tag %r", tag)
                continue
            fields = rest.split(":")
            rid, tok_step = int(fields[0]), int(fields[1])
            req = in_flight.get(rid)
            if req is None or tok_step != req.step:
                continue    # finished request, or a duplicate/stale step
            self.flight.record("tok_recv", stage=self.transport.device_id,
                               rid=rid, step=req.step)
            try:
                tensors, _ = wire.split_trace_context(
                    wire.deserialize_tensors(payload))
            except wire.WireIntegrityError as e:
                # dropped: this step's token is lost and the step times
                # out, never a garbage token appended
                record_corrupt_frame(self.transport.device_id, tag,
                                     len(payload), e)
                continue
            [toks] = tensors
            step = req.step
            self._advance(req, toks)
            if on_token is not None:
                on_token(rid_to_index[rid], step, toks)
            if req.done:
                del in_flight[rid]

        return [np.stack(r.tokens, axis=1) for r in pending]

    def generate(self, prompt_ids: np.ndarray,
                 max_new_tokens: int) -> np.ndarray:
        """Single request; returns [b, new_tokens]."""
        return self.generate_many([prompt_ids], max_new_tokens)[0]

    def classify_many(self, prompts: Sequence[np.ndarray],
                      label_token_ids: Sequence[int],
                      pool_size: int = 1) -> List[np.ndarray]:
        """Classify each prompt batch over the pipeline: one prefill hop,
        the tail argmaxes the last-position logits restricted to
        ``label_token_ids``, and the predicted label index rides back.
        Returns [b] int32 label-index arrays, prompt order.  A dead
        worker surfaces as a TransportTimeout after ``step_timeout``."""
        label_ids = np.asarray(label_token_ids, np.int32)
        if label_ids.ndim != 1 or label_ids.size < 2:
            raise ValueError("label_token_ids must be >= 2 token ids")
        if (label_ids < 0).any() or (label_ids
                                     >= self.rt.cfg.vocab_size).any():
            # validated here: an out-of-range id reaching the tail would
            # raise inside its serve loop and poison the pipeline
            raise ValueError(
                f"label_token_ids out of range [0, "
                f"{self.rt.cfg.vocab_size})")
        for p in prompts:
            if p.shape[1] > self.rt.max_seq:
                raise ValueError(
                    f"prompt ({p.shape[1]}) exceeds KV capacity "
                    f"{self.rt.max_seq}")
        rids = list(range(self._next_rid, self._next_rid + len(prompts)))
        self._next_rid += len(prompts)
        trace_ids = {rid: new_trace_id() for rid in rids}
        results: Dict[int, np.ndarray] = {}
        queue = list(zip(rids, prompts))
        in_flight: Dict[int, int] = {}

        def launch(rid: int, prompt: np.ndarray) -> None:
            trace_id = trace_ids[rid]
            t_c = SpanClock()
            with t_c:
                hidden = _host(self.stats, self.rt.run_chunk(
                    rid, prompt.astype(np.int32)))
                send_span = self.tracer.next_span_id()
                body = wire.serialize_tensors_traced(
                    [hidden, label_ids], trace_id, send_span)
            self.stats.record_compute(t_c.seconds)
            parent = self.tracer.record(
                "compute", trace_id, clock=t_c,
                rid=rid, step=0, phase="classify")
            t_s = SpanClock()
            with t_s:
                self.transport.send(self.next_id, f"c:{rid}", body)
            self.stats.record_send(t_s.seconds, len(body))
            self.flight.record("hop_send",
                               stage=self.transport.device_id,
                               rid=rid, step=0, dest=self.next_id,
                               nbytes=len(body), classify=True)
            self.tracer.record("send", trace_id, parent, clock=t_s,
                               span_id=send_span, rid=rid, step=0)
            # one rtt per classify hop, as the tail records one compute
            self._sent_at[(rid, 0)] = time.perf_counter()
            self._rtt_ctx[(rid, 0)] = (trace_id, send_span, time.time())

        while queue or in_flight:
            while queue and len(in_flight) < pool_size:
                rid, prompt = queue.pop(0)
                in_flight[rid] = rid
                launch(rid, np.asarray(prompt))
            t0 = time.perf_counter()
            try:
                tag, payload = self.transport.recv_any(
                    timeout=self.step_timeout)
            except TransportTimeout:
                self._stall_postmortem("classify")
                raise
            self.stats.record_recv(time.perf_counter() - t0, len(payload))
            kind, _, rest = tag.partition(":")
            if kind != "ctok":
                log.warning("header: unexpected tag %r during classify", tag)
                continue
            rid = int(rest.split(":")[0])
            if rid not in in_flight:
                continue
            self.flight.record("tok_recv", stage=self.transport.device_id,
                               rid=rid, step=0, classify=True)
            try:
                tensors, _ = wire.split_trace_context(
                    wire.deserialize_tensors(payload))
            except wire.WireIntegrityError as e:
                record_corrupt_frame(self.transport.device_id, tag,
                                     len(payload), e)
                continue
            self._record_rtt(rid, 0)
            [pred] = tensors
            results[rid] = pred.astype(np.int32)
            self.transport.send(self.next_id, f"end:{rid}", b"")
            self.rt.free(rid)
            del in_flight[rid]

        return [results[r] for r in rids]

    def collect_stats(self, num_stages: int,
                      timeout: float = 10.0,
                      include_spans: bool = False) -> List[dict]:
        """Poll every downstream stage for its stats snapshot.

        Sends ``statsreq`` down the chain; each stage replies directly to
        the header and forwards the request.  Returns the header's own
        snapshot first, then one dict per responding stage (may be fewer
        than ``num_stages - 1`` on timeout).  Call outside of generation:
        replies share the transport with token traffic.
        ``include_spans`` asks every stage to drain its trace spans into
        the reply (at-most-once delivery)."""
        seq = str(self._next_stats_seq)
        self._next_stats_seq += 1
        self.transport.send(self.next_id, f"statsreq:{seq}",
                            b"spans" if include_spans else b"")
        mine = dict(self.stats.snapshot(include_samples=True),
                    device_id=self.transport.device_id)
        # keyed by device_id + filtered by seq: a stale reply from an
        # earlier timed-out poll can neither satisfy nor displace this one
        replies: Dict[str, dict] = {}
        deadline = time.monotonic() + timeout
        want = num_stages - 1
        while len(replies) < want:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                tag, payload = self.transport.recv_any(timeout=left)
            except TransportTimeout:
                break
            if tag.startswith("statsrep:"):
                snap = json.loads(payload.decode("utf-8"))
                if snap.get("seq") == seq:
                    replies[snap.get("device_id", tag)] = snap
            else:
                log.warning("header: unexpected tag %r during stats poll",
                            tag)
        return [mine] + list(replies.values())

    def collect_trace(self, num_stages: int,
                      timeout: float = 10.0) -> dict:
        """Drain every stage's spans (plus the header's own) as a Chrome
        trace-event JSON object.  Runs outside of generation, like
        :meth:`collect_stats`."""
        from ..telemetry.tracing import to_chrome_trace
        stats = self.collect_stats(num_stages, timeout,
                                   include_spans=True)
        spans = self.tracer.drain()
        for s in stats:
            spans.extend(s.pop("spans", None) or [])
        return to_chrome_trace(spans)

    def reset_stats(self) -> None:
        """Zero our counters and every downstream stage's."""
        self.stats.reset()
        self._sent_at.clear()
        self._rtt_ctx.clear()
        self.transport.send(self.next_id, "statsreset", b"")

    def shutdown_pipeline(self) -> None:
        """Send ``stop`` down the chain."""
        self.transport.send(self.next_id, "stop", b"")
