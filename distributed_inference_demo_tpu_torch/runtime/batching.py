"""Continuous batching: requests join and leave a running decode batch.

Counterpart of ``distributed_inference_demo_tpu/runtime/batching.py``'s
``ContinuousBatchingEngine`` in plain mode (no proposer): the serialized
interleave and the mixed prefill+decode dispatch.  A fixed pool of batch
SLOTS decodes in lockstep; a new request is admitted into a free slot
between two decode steps.

- **Paged slot cache.**  K/V live in one device page pool
  ``[L, N + 1, nkv, block_tokens, hd]`` addressed through per-slot block
  tables (host numpy, the scheduler's source of truth, copied once per
  dispatch into a static device buffer for decode, uploaded for
  admission and the mixed slab).  Memory is reserved per page a
  request holds, and radix prefix hits are shared table entries.  Page
  ``N`` is the drop page: writes through sentinel entries land there
  (``ops/paged_attention``).
  ``kv_dtype`` int8/int4 makes the pool ``ops.quant.QuantizedKVPages``,
  quantized once per token as it is written; ``kv_cache_dtype``
  "float8_e4m3fn" makes it float8 pages, cast as the reference rounds
  (``ops.quant.cast_kv``); the paged kernels have an instance for each.
- **Every step runs all slots.**  An ``active`` mask keeps freed and
  empty slots harmless: their tables are all-sentinel, so their writes
  drop, and their outputs are discarded.
- **Admission is a paged prefill straight into the pool**, padded to a
  bucket length as in the reference (which buckets to bound compiles;
  here the bucket also decides the attention route, so the launch
  pattern is the reference's), either in one dispatch or, with
  ``prefill_chunk``, as resumable chunked admission interleaved with
  decode steps.
- **Decode** is ``paged_step`` (one step) or ``paged_multi_step``
  (``decode_block`` steps with the reference's early exit: the active
  mask frozen for the block, a row done on eos or its token budget,
  and the steps that ran driving the drain).  A step reads and writes
  static buffers in place (the decode tables, the active mask, each
  slot's length and last token, the step's logprobs); on the card it
  is a CUDA graph captured when the engine is built and replayed from
  the host loop (``runtime/cuda_graph.py``), on the CPU the same step
  run eagerly.
- **Mixed dispatch** (``mixed_token_budget`` > 0): each scheduler
  iteration is ONE dispatch that packs C-token prefill segments of
  several concurrent admissions into an ``[n_seg, C]`` slab, samples and
  installs the finals, and runs the fused decode block over every
  active row, so decode fusion survives admission.

The reference's other jitted programs (admission prefill, the mixed
slab) run eagerly.  Sampling noise comes from one ``torch.Generator``
seeded with ``seed`` (the reference's single rng stream): per-request
seeds are not honored, and greedy decoding is bit-exact against
``InferenceEngine``.

Not ported yet, each refused where it is asked for: the draft-model and
prompt-lookup proposers, tiered KV, migration and resume, and tp
meshes.
"""

from __future__ import annotations

import copy
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import (KVCache, ModelConfig, StageParams, StageSpec,
                           pad_cache_capacity)
from ..ops.paged_attention import BACKENDS as PAGED_BACKENDS
from ..ops.quant import (alloc_kv_pages, resolve_kv_cache_dtype,
                         resolve_kv_dtype)
from ..ops.sampling import SamplingParams, sample_logits
from ..telemetry._env import env_int
from ..telemetry.flightrecorder import get_flight_recorder
from .engine import (GenerationResult, check_capacity,
                     make_paged_chunk_programs, validate_prefill_chunk)
from .cuda_graph import StepGraphs
from .kvcache import refuse_tiers
from .overload import SchedulerOverloaded

SPEC_LATER = ("the draft-model and prompt-lookup proposers are ported in a "
              "later slice (ROADMAP A11)")
TP_LATER = "tensor-parallel meshes are ported in a later slice (ROADMAP A13)"


class _BlocksExhausted(Exception):
    """Paged admission could not allocate its pages (every evictable
    block pinned by in-flight tables): the request goes back to pending
    and retries when a completion frees pages — never a failure."""


def _percentile(samples, q: float) -> float:
    """Nearest-rank percentile: smallest x with cdf(x) >= q/100."""
    if not samples:
        return float("nan")
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[idx]


def _emitted_logprob(logits: torch.Tensor, tok: torch.Tensor
                     ) -> torch.Tensor:
    """Raw log-softmax of the emitted tokens (the engines' convention)."""
    return torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                        tok[:, None])[:, 0]


@dataclass
class Request:
    """One in-flight generation request (row-level)."""
    prompt: np.ndarray                 # [s] int32
    max_new: int
    tokens: List[int] = field(default_factory=list)
    lps: List[float] = field(default_factory=list)   # emitted logprobs
    # latency markers (perf_counter seconds), set by submit()/scheduler
    t_submit: float = 0.0
    t_sched: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    stream: "queue.Queue" = field(default_factory=queue.Queue)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    cancelled: bool = False

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)

    def cancel(self) -> None:
        """Ask the scheduler to drop this request: a queued request is
        skipped at admission; an in-flight one frees its slot after the
        current step.  Tokens already produced stay in ``tokens``."""
        self.cancelled = True


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a single-stage model."""

    def __init__(self, cfg: ModelConfig, params: StageParams,
                 max_seq: Optional[int] = None, max_batch: int = 8,
                 sampling: SamplingParams = SamplingParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 prompt_buckets: tuple = (32, 128, 512, 2048),
                 kv_cache_blocks: Optional[int] = None,
                 kv_block_tokens: Optional[int] = None,
                 mesh=None, kv_cache_dtype=None, kv_dtype=None,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Optional[StageParams] = None,
                 num_draft: int = 4,
                 prompt_lookup: bool = False,
                 decode_block: int = 1,
                 prefill_chunk: Optional[int] = None,
                 kv_layout: Optional[str] = None,
                 max_queue_depth: Optional[int] = None,
                 mixed_token_budget: Optional[int] = None,
                 spec_adaptive: bool = True,
                 kv_host_tier_bytes: Optional[int] = None,
                 kv_disk_tier_path: Optional[str] = None,
                 kv_disk_tier_bytes: Optional[int] = None,
                 attn_backend: str = "auto",
                 device=None, cuda_graph: bool = True):
        """Arguments as in the reference.  ``kv_cache_blocks`` sizes the
        page pool (0/None = ``max_batch x table_width``);
        ``kv_block_tokens`` is the page size (default 16, or the
        ``DWT_KVCACHE_*`` knobs).  ``max_queue_depth`` > 0 sheds
        submissions past that many waiting requests with
        :class:`SchedulerOverloaded` (``None``: ``DWT_MAX_QUEUE_DEPTH``).

        Port-only: ``attn_backend`` picks the paged attention route:
        "auto" (the CUDA kernels on CUDA, their plain versions on the
        CPU), "cuda" (the kernels, CUDA only) or "plain"
        (the gather path everywhere); see
        ``ops.paged_attention.resolve_paged_backend``.  ``device``: where
        the engine runs, CUDA unless "cpu" is asked for; ``params`` must
        already live there.  ``cuda_graph``: on the card the decode step
        is captured as a CUDA graph here, before the scheduler starts
        (a failed capture raises), and replayed; False runs the same
        step eagerly (the comparison for the graph).  On the CPU the
        step always runs eagerly.

        ``mixed_token_budget`` > 0 (needs ``prefill_chunk``, at least one
        chunk): the mixed prefill+decode dispatch, see
        :meth:`_dispatch_mixed`.  ``kv_dtype`` "int8"/"int4": a quantized
        page pool; it does not compose with ``kv_cache_dtype``
        ("float8_e4m3fn": float8 pages, the reference's page dtype rule
        ``kv_cache_dtype or cfg.dtype``).

        Refused until their slice: the proposers (``draft_cfg``,
        ``prompt_lookup``), the tier knobs and a tp ``mesh``.
        ``num_draft``, ``spec_adaptive`` and ``kv_disk_tier_bytes`` only
        shape a proposer or a tier, so without one they do nothing, as in
        the reference."""
        if max_queue_depth is None:
            max_queue_depth = env_int("DWT_MAX_QUEUE_DEPTH", 0)
        self.max_queue_depth = max(0, int(max_queue_depth))
        if mixed_token_budget is None:
            mixed_token_budget = env_int("DWT_MIXED_TOKEN_BUDGET", 0)
        self.mixed_token_budget = max(0, int(mixed_token_budget))
        if draft_cfg is not None or draft_params is not None or prompt_lookup:
            raise NotImplementedError(SPEC_LATER)
        refuse_tiers(kv_host_tier_bytes, kv_disk_tier_path)
        # kv_dtype quantizes the page pool; the kv_cache_dtype storage
        # cast is another grid for the same full-width layout: one knob
        # or the other, as in the reference
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        if self.kv_dtype != "bf16" and self.kv_cache_dtype is not None:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} quantizes the page pool and "
                "cannot compose with a kv_cache_dtype storage cast; drop "
                "one of the two knobs")
        if mesh is not None and dict(mesh.shape).get("tp", 1) > 1:
            raise NotImplementedError(TP_LATER)
        if attn_backend not in PAGED_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; "
                             f"expected one of {PAGED_BACKENDS}")
        self.device = resolve_device(device)
        p_dev = params.embed["tokens"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, the engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq or cfg.max_seq_len
        self.max_batch = max_batch
        self.sampling = sampling
        self.eos_id = eos_id
        self.spec = StageSpec(0, 1, 0, cfg.num_layers)
        self.decode_block = decode_block
        self.prefill_chunk = validate_prefill_chunk(prefill_chunk,
                                                    self.max_seq)
        if decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if self.mixed_token_budget > 0:
            if self.prefill_chunk is None:
                raise ValueError(
                    "mixed_token_budget needs prefill_chunk: the budget "
                    "is packed with C-token prefill segments")
            if self.mixed_token_budget < self.prefill_chunk:
                raise ValueError(
                    f"mixed_token_budget ({self.mixed_token_budget}) must "
                    f"fit at least one prefill chunk "
                    f"({self.prefill_chunk} tokens)")
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.max_seq
        ) or (self.max_seq,)

        from .kvcache import (PagedKVCacheManager, resolve_kv_layout,
                              resolve_kvcache_config)
        self.kv_layout = resolve_kv_layout(kv_layout)
        n_blocks_arg, block_tokens = resolve_kvcache_config(
            kv_cache_blocks, kv_block_tokens, default_blocks=0)
        if block_tokens < 1:
            raise ValueError("kv_block_tokens must be >= 1")

        # the table width covers the caller's max_seq padded to the
        # sublane granule and to the page size (lcm keeps both), as the
        # reference's buffer capacity S
        B, bt = max_batch, block_tokens
        gran = math.lcm(8, bt)
        S = -(-pad_cache_capacity(self.max_seq) // gran) * gran
        self._table_width = S // bt
        n_blocks = (n_blocks_arg if n_blocks_arg >= 1
                    else B * self._table_width)
        self.kv_cache = PagedKVCacheManager.for_model(
            cfg, n_blocks, bt, dtype=self.kv_cache_dtype,
            kv_dtype=self.kv_dtype)
        N = self.kv_cache.num_blocks
        self._page_sentinel = N
        # N pages a table may name + the drop page N
        shape = (cfg.num_layers, N + 1, cfg.num_kv_heads, bt, cfg.head_dim)
        page_dtype = self.kv_cache_dtype or cfg.dtype
        self._pk = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                  self.device)
        self._pv = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                  self.device)
        self._tables = np.full((B, self._table_width), N, np.int32)

        from ..parallel.tensor import make_paged_forward_seam
        self.attn_backend = attn_backend
        self._fwd, self._bind, _ = make_paged_forward_seam(
            cfg, self.spec, None, params, bt, self.attn_backend,
            num_pages=N, device_type=self.device.type)
        self._paged_chunk_mid, self._slab_body = make_paged_chunk_programs(
            self._fwd, self._bind)
        # the mixed dispatch's slab: a FIXED budget // C segments per
        # dispatch (unused rows ride all-sentinel tables)
        self._mixed_seg_cap = (max(1, self.mixed_token_budget
                                   // self.prefill_chunk)
                               if self.mixed_token_budget > 0 else 0)

        # the decode step's static buffers, updated in place: the decode
        # tables and the active mask (filled per dispatch), each slot's
        # length and last token, the step's emitted logprobs
        self._dec_tables = torch.full((B, self._table_width), N,
                                      dtype=torch.int32, device=self.device)
        self._active = torch.zeros(B, dtype=torch.bool, device=self.device)
        self._lengths = torch.zeros(B, dtype=torch.int64, device=self.device)
        self._last_tok = torch.zeros(B, dtype=torch.int64,
                                     device=self.device)
        self._step_lp = torch.zeros(B, dtype=torch.float32,
                                    device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        # captured here, on the constructing thread, before the scheduler
        # thread starts and before any server can hand this engine a
        # request; the warm-up step runs with every slot inactive and
        # every table sentinel, so it changes no slot state
        self._decode = StepGraphs(self.device, self._gen,
                                  cuda_graph).capture(self._decode_step)
        self._step_count = 0
        # one host dispatch per step or fused block; device_loop_steps
        # counts the steps that ran in it (early exit shows here)
        self.loop_stats = {"host_dispatches": 0, "device_loop_steps": 0}
        self._reset_chunk_stats()
        # resumable chunked admission: at most ONE prompt streams its
        # chunks at a time (_adm); _pending holds popped-but-unserved
        # requests, served FIFO, serviceable ones passing blocked ones
        self._adm: Optional[dict] = None
        # mixed mode: several admissions stream their chunks at once
        self._adms: List[dict] = []
        self._pending: "deque[Request]" = deque()
        # completed-request latency reservoirs (seconds), bounded FIFO
        self._lat = {"ttft": deque(maxlen=512), "e2e": deque(maxlen=512),
                     "per_token": deque(maxlen=512)}
        self._completed = 0
        self._slots: List[Optional[Request]] = [None] * B
        self._queue: "queue.Queue" = queue.Queue()
        self._flight = get_flight_recorder()
        self._running = True
        # serializes submit() against close(): no request can be enqueued
        # after close() returns, so none can slip past the shutdown drain
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # public API

    def submit(self, prompt_ids, max_new_tokens: int) -> Request:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        check_capacity(self.max_seq, len(prompt), max_new_tokens)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            # admission records the first sampled token unconditionally,
            # so a 0-token request would still produce one
            raise ValueError("max_new_tokens must be >= 1")
        # the page-pool twin of check_capacity: a request whose full
        # table can never be allocated would wait in pending forever
        bt = self.kv_cache.block_tokens
        need = -(-(len(prompt) + max_new_tokens) // bt)
        if need > self.kv_cache.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (prompt {len(prompt)} + "
                f"new {max_new_tokens} at {bt} tokens/block) but the "
                f"paged pool holds only {self.kv_cache.num_blocks}; raise "
                "kv_cache_blocks")
        if self.max_queue_depth:
            depth = self._queue.qsize() + len(self._pending)
            if depth >= self.max_queue_depth:
                self._flight.record("admission_shed", depth=depth,
                                    limit=self.max_queue_depth)
                raise SchedulerOverloaded(
                    f"admission queue full ({depth} waiting >= "
                    f"--admission-queue-depth {self.max_queue_depth}); "
                    "shedding instead of queueing unboundedly",
                    retry_after_s=1.0)
        req = Request(prompt=prompt, max_new=max_new_tokens,
                      t_submit=time.perf_counter())
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            self._queue.put(req)
        return req

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 seed: int = 0, timeout: Optional[float] = None,
                 logprobs: bool = False) -> GenerationResult:
        """Submit each row as its own request (they batch with whatever
        else is in flight) and wait for all.  ``seed`` is accepted for
        surface compatibility but not honored (one engine rng stream).
        On ``timeout`` the requests are cancelled before TimeoutError
        propagates.  Rows that finished early pad their tokens with eos
        (0 without one) and their logprobs with 0.0."""
        ids = np.asarray(prompt_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        t0 = time.perf_counter()
        reqs = self._submit_rows(ids, max_new_tokens)
        try:
            rows = [r.wait(timeout=timeout) for r in reqs]
        except TimeoutError:
            for r in reqs:
                r.cancel()
            raise
        width = max(len(r) for r in rows)
        pad_id = self.eos_id if self.eos_id is not None else 0
        toks = np.full((len(rows), width), pad_id, np.int32)
        lps = np.zeros((len(rows), width), np.float32) if logprobs else None
        for i, r in enumerate(rows):
            toks[i, :len(r)] = r
            if logprobs:
                lps[i, :len(r)] = reqs[i].lps
        return GenerationResult(tokens=toks, prompt_len=ids.shape[1],
                                num_new=width,
                                seconds=time.perf_counter() - t0,
                                logprobs=lps)

    def _submit_rows(self, ids: np.ndarray, max_new_tokens: int) -> list:
        """Submit every row or none: rows already admitted are cancelled
        before a later row's rejection (e.g. a shed) propagates."""
        reqs = []
        try:
            for row in ids:
                reqs.append(self.submit(row, max_new_tokens))
        except Exception:
            for r in reqs:
                r.cancel()
            raise
        return reqs

    def generate_stream(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        seed: int = 0, timeout: Optional[float] = None,
                        logprobs: bool = False):
        """Yield one [batch] token array per step (the HTTP streaming
        surface); with ``logprobs=True``, ([batch] tokens, [batch]
        logprobs) pairs.  Multi-row prompts stream in lockstep of the
        slowest row; finished rows pad with eos (0 without one) and
        logprob 0.0.  An abandoned stream cancels its in-flight requests.
        ``timeout``: an overall deadline, after which the requests are
        cancelled and TimeoutError raised."""
        ids = np.asarray(prompt_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        deadline = None if not timeout else time.monotonic() + timeout
        reqs = self._submit_rows(ids, max_new_tokens)
        fetched = [[] for _ in reqs]
        finished = [False] * len(reqs)   # row's None sentinel was consumed
        pad = self.eos_id if self.eos_id is not None else 0
        try:
            for step_i in range(max_new_tokens):
                out = []
                for i, r in enumerate(reqs):
                    while not finished[i] and len(fetched[i]) <= step_i:
                        try:
                            item = r.stream.get(
                                timeout=None if deadline is None else
                                max(0.0, deadline - time.monotonic()))
                        except queue.Empty:
                            raise TimeoutError(
                                f"request deadline ({timeout}s) "
                                "exceeded") from None
                        if item is None:  # end sentinel: done, or failure
                            finished[i] = True
                            if r.error is not None:
                                raise r.error
                        else:
                            fetched[i].append(item)
                    out.append(step_i < len(fetched[i]))
                if not any(out):
                    return
                toks = np.asarray([fetched[i][step_i] if ok else pad
                                   for i, ok in enumerate(out)], np.int32)
                if logprobs:
                    # a token's logprob is recorded before the token is
                    # streamed, so it is there when the token arrives
                    lps = np.asarray([reqs[i].lps[step_i] if ok else 0.0
                                      for i, ok in enumerate(out)],
                                     np.float32)
                    yield toks, lps
                else:
                    yield toks
        finally:
            for r in reqs:
                if not r.done.is_set():
                    r.cancel()

    def _pending_prefill_tokens(self) -> int:
        """Queued + mid-admission prompt tokens still awaiting prefill
        (racy snapshot of scheduler-owned state: a gauge)."""
        total = 0
        for r in copy.copy(self._queue.queue):
            if isinstance(r, Request):
                total += len(r.prompt)
        for r in copy.copy(self._pending):
            total += len(r.prompt)
        adm = self._adm
        if adm is not None:
            total += max(0, len(adm["req"].prompt) - adm["start"])
        for a in list(self._adms):
            total += max(0, len(a["req"].prompt) - a["start"])
        return total

    def stats(self) -> dict:
        """Scheduler counters for the HTTP ``/stats`` surface: the slot,
        queue, kv-cache, device-loop, latency, chunked-prefill and mixed
        fragments of the reference's ``stats()``."""
        out = {"slots": self.max_batch, "steps": self._step_count,
               "kv_layout": self.kv_layout,
               "queue_depth": self._queue.qsize() + len(self._pending),
               "pending_prefill_tokens": self._pending_prefill_tokens(),
               "active_slots": sum(1 for s in self._slots
                                   if s is not None),
               "kvcache": self.kv_cache.snapshot(),
               "device_loop": dict(self.loop_stats,
                                   decode_block=self.decode_block)}
        lat = {"completed": self._completed}
        for name, res in self._lat.items():
            xs = sorted(copy.copy(res))
            if xs:
                lat[f"{name}_p50_ms"] = round(_percentile(xs, 50) * 1e3, 3)
                lat[f"{name}_p95_ms"] = round(_percentile(xs, 95) * 1e3, 3)
        out["latency"] = lat
        if self.prefill_chunk is not None:
            cs = self.chunk_stats
            out["chunked_prefill"] = {
                "chunk": self.prefill_chunk, "chunks": cs["chunks"],
                "interleaved_steps": cs["interleaved_steps"]}
        if self.mixed_token_budget > 0:
            cs = self.chunk_stats
            out["mixed"] = {
                "token_budget": self.mixed_token_budget,
                "dispatches": cs["mixed_dispatches"],
                "prefill_tokens": cs["mixed_prefill_tokens"],
                # the share of the offered budget actually carried
                # (prefill segment tokens + fused decode tokens)
                "budget_utilization": (
                    round(cs["mixed_packed_tokens"]
                          / cs["mixed_budget_tokens"], 4)
                    if cs["mixed_budget_tokens"] else None)}
        return out

    def reset_stats(self) -> None:
        self._step_count = 0
        self.loop_stats = {"host_dispatches": 0, "device_loop_steps": 0}
        self.kv_cache.reset_stats()
        self._reset_chunk_stats()
        self._completed = 0
        for res in self._lat.values():
            res.clear()

    def _reset_chunk_stats(self) -> None:
        """The chunk/mixed counters, the reference's, plus the port's
        ``mixed_slab_forwards``: the mixed dispatches that ran the slab
        (one with no segment packed skips it)."""
        self.chunk_stats = {"chunks": 0, "interleaved_steps": 0,
                            "mixed_dispatches": 0,
                            "mixed_prefill_tokens": 0,
                            "mixed_packed_tokens": 0,
                            "mixed_budget_tokens": 0,
                            "mixed_slab_forwards": 0}

    def close(self):
        self._running = False
        self._queue.put(None)              # wake the scheduler
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # device programs (the reference's jits: the decode step a CUDA
    # graph on the card, the rest eager)

    def _upload(self, tables: np.ndarray) -> torch.Tensor:
        """Admission or slab block tables to the device: once per
        dispatch, every layer of its forward reads this copy (decode
        reads the static ``_dec_tables``, :meth:`_load_decode`)."""
        return torch.from_numpy(np.ascontiguousarray(tables)).to(
            self.device)

    def _pool(self) -> KVCache:
        return KVCache(self._pk, self._pv, 0)

    @property
    def graph_replays(self) -> int:
        """Decode steps replayed from the captured graph."""
        return self._decode.replays

    def _decode_step(self) -> None:
        """One lockstep decode step over all slots, on the static buffers
        and in place: forward every slot's last token at its own length
        through the decode tables, sample, keep inactive slots' state.
        After it ``_last_tok`` holds the step's tokens and ``_step_lp``
        their logprobs."""
        self._bind(self._dec_tables)
        logits, _ = self._fwd(self.params, self._last_tok[:, None],
                              self._pool(), self._lengths[:, None], True)
        logits = logits[:, 0]
        tok = sample_logits(logits, self._gen, self.sampling)
        tok = torch.where(self._active, tok, self._last_tok)
        self._step_lp.copy_(_emitted_logprob(logits, tok))
        self._lengths.add_(self._active.long())
        self._last_tok.copy_(tok)

    def _load_decode(self, active_mask: np.ndarray) -> None:
        """A dispatch's decode inputs into the static buffers: the host
        tables and the active mask."""
        self._dec_tables.copy_(torch.from_numpy(self._tables))
        self._active.copy_(torch.from_numpy(active_mask))

    def _paged_multi_step(self, eos: int, budget: torch.Tensor,
                          num_steps: int,
                          done0: Optional[torch.Tensor] = None):
        """``decode_block`` fusion with the reference's early exit: up to
        ``num_steps`` steps, stopping once every active row is done (eos,
        or its remaining-token ``budget`` spent).  The active mask stays
        frozen for the block; rows that finish while others run keep
        decoding into their own positions or the drop page.  ``done0``:
        rows already done at entry (a mixed dispatch's freshly installed
        row whose token #1 was eos).  The decode tables and the active
        mask are already loaded (:meth:`_load_decode`).  Returns (toks
        [B, num_steps], lps, steps_ran)."""
        active = self._active
        B = active.shape[0]
        toks = torch.zeros((B, num_steps), dtype=torch.int64,
                           device=self.device)
        lps = torch.zeros((B, num_steps), dtype=torch.float32,
                          device=self.device)
        row_done = (done0 if done0 is not None else
                    torch.zeros(B, dtype=torch.bool, device=self.device))
        j = 0
        while j < num_steps and bool((active & ~row_done).any()):
            self._decode()
            tok = self._last_tok
            row_done = row_done | (j + 1 >= budget)
            if eos >= 0:
                row_done = row_done | ((tok == eos) & active)
            toks[:, j] = tok
            lps[:, j] = self._step_lp
            j += 1
        return toks, lps, j

    def _paged_prefill(self, ids: torch.Tensor, table: torch.Tensor,
                       start: int, real_len: int):
        """Batch-1 (suffix) paged prefill of a padded bucket at offset
        ``start`` through the request's table [1, W]; samples token #1 at
        the prompt's true last position.  Padded tail tokens write
        garbage K/V into the request's own pages past its length (or the
        drop page), which decode overwrites before any query attends it."""
        self._bind(table)
        b, s = ids.shape
        pos = (start + torch.arange(s, device=self.device)).expand(b, s)
        logits, _ = self._fwd(self.params, ids, self._pool(), pos, False)
        last = logits[:, real_len - 1]
        tok = sample_logits(last, self._gen, self.sampling)
        return tok[0], _emitted_logprob(last, tok)[0]

    # ------------------------------------------------------------------
    # scheduler

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.max_seq

    def _reserve_pages(self, req: Request) -> int:
        """Paged admission, phase 1: reserve the request's pages and
        build its block table; returns the matched-prefix length m.  The
        matched prefix's pages are shared (pinned by a lease until the
        request completes); the private rest, enough for prompt +
        max_new, is allocated up front (LRU tree leaves evict under
        pressure).  If even eviction cannot free enough,
        :class:`_BlocksExhausted` sends the request back to pending."""
        mgr = self.kv_cache
        bt = mgr.block_tokens
        plen = len(req.prompt)
        n_total = -(-(plen + req.max_new) // bt)
        # retry gate for a blocked admission: re-attempt only once the
        # pool could have changed, so a waiting request does not re-run
        # match() (and its counters) every scheduler iteration
        state = (mgr.epoch, mgr.free_blocks)
        if getattr(req, "_pkv_blocked", None) == state:
            raise _BlocksExhausted()
        lease = mgr.match(req.prompt)
        m = lease.tokens if lease is not None else 0
        n_pref = m // bt
        private = mgr.alloc(n_total - n_pref)
        if private is None:
            if lease is not None:
                lease.release()
            req._pkv_blocked = (mgr.epoch, mgr.free_blocks)
            raise _BlocksExhausted()
        req._pkv_blocked = None
        table = np.full((self._table_width,), self._page_sentinel, np.int32)
        if lease is not None:
            table[:n_pref] = lease.block_ids
        table[n_pref:n_total] = private
        req._pkv = {"lease": lease, "store_lease": None,
                    "private": private, "adopted": (), "n_pref": n_pref,
                    "table": table, "released": False}
        return m

    def _release_request_kv(self, req: Request) -> None:
        """Return a request's KV resources: release its pins (matched
        prefix + stored path) and free the private pages the tree did not
        adopt.  Idempotent: completion, cancel, failure and the shutdown
        drain all funnel here."""
        st = getattr(req, "_pkv", None)
        if st is None or st["released"]:
            return
        st["released"] = True
        if st["lease"] is not None:
            st["lease"].release()
        if st["store_lease"] is not None:
            st["store_lease"].release()
        adopted = set(st["adopted"])
        self.kv_cache.free([b for b in st["private"] if b not in adopted])

    def _needs_stream(self, req: Request) -> bool:
        """Does this prompt need the one-at-a-time chunk stream, or can
        it admit in one dispatch?  Classified by the effective suffix (a
        prefix hit may shrink a long prompt to one dispatch); memoized on
        the request against the manager's mutation epoch."""
        C = self.prefill_chunk
        if C is None:
            return False
        epoch = self.kv_cache.epoch
        cls = getattr(req, "_stream_cls", None)
        if cls is not None and cls[0] == epoch:
            return cls[1]
        needs = len(req.prompt) > C
        if needs:
            m = self.kv_cache.peek(req.prompt)
            if m and len(req.prompt) - m <= C:
                needs = False
        req._stream_cls = (epoch, needs)
        return needs

    def _admit_request(self, slot: int, req: Request):
        if req.t_sched == 0.0:
            req.t_sched = time.perf_counter()
        start = self._reserve_pages(req)
        self._finish_admission(slot, req, start, req.prompt[start:])

    def _start_admission(self, req: Request) -> bool:
        """Park a chunk-needing prompt as the in-progress admission the
        scheduler advances one dispatch per iteration.  Returns False
        when the pool cannot reserve its pages yet (the caller requeues
        it); everything else, failure included, is handled here."""
        if req.t_sched == 0.0:
            req.t_sched = time.perf_counter()
        try:
            start = self._reserve_pages(req)
        except _BlocksExhausted:
            return False
        except BaseException as e:
            self._fail_request(req, e)
            return True
        self._adm = {"req": req, "start": start, "m": start,
                     "suffix": req.prompt[start:]}
        return True

    def _advance_admission(self, free: list) -> None:
        """One dispatch of the in-progress admission: the next C-token
        chunk through ``chunk_mid``, or, once the remainder fits one
        dispatch, the sampling final prefill into a free slot (parked
        until one frees)."""
        a = self._adm
        if a is None:
            return
        req, C = a["req"], self.prefill_chunk
        if req.cancelled:
            self._adm = None
            self._fail_request(req, None)
            return
        if len(a["suffix"]) > C:
            try:
                head = torch.from_numpy(
                    np.asarray(a["suffix"][:C], np.int64)[None]).to(
                        self.device)
                self._paged_chunk_mid(self.params, self._pk, self._pv, head,
                                      self._upload(req._pkv["table"][None]),
                                      a["start"])
            except BaseException as e:
                # a per-request failure fails that request, never the
                # engine
                self._adm = None
                self._fail_request(req, e)
                return
            a["start"] += C
            a["suffix"] = a["suffix"][C:]
            self.chunk_stats["chunks"] += 1
        elif free:
            self._adm = None
            try:
                self._finish_admission(free.pop(0), req, a["start"],
                                       a["suffix"], prefix_reused=a["m"])
            except BaseException as e:
                self._fail_request(req, e)

    def _finish_admission(self, slot: int, req: Request, start: int,
                          suffix, prefix_reused: Optional[int] = None
                          ) -> None:
        """The sampling final prefill + slot install, shared by one-shot
        admission and the last dispatch of a chunked one.  Writes begin
        at ``start``, at or past the matched prefix, so the tree's shared
        pages are only read."""
        plen = len(req.prompt)
        st = req._pkv
        bucket = self._bucket(len(suffix))
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(suffix)] = suffix
        tok, lp0 = self._paged_prefill(
            torch.from_numpy(padded).to(self.device),
            self._upload(st["table"][None]), start, len(suffix))
        # store at PREFILL time, by adoption: the tree takes ownership of
        # the full-prompt pages it was missing, so the next request with
        # this prefix references the very pages this one decodes against
        bt = self.kv_cache.block_tokens
        if plen // bt >= 1:
            adopted, store_lease = self.kv_cache.store_shared(
                req.prompt, st["table"][:plen // bt])
            st["adopted"] = adopted
            st["store_lease"] = store_lease
        self._tables[slot] = st["table"]
        self._lengths[slot] = plen
        self._last_tok[slot] = tok
        self._slots[slot] = req
        self._flight.record("batch_admit", slot=slot, prompt_len=plen,
                            max_new=req.max_new,
                            prefix_reused=(start if prefix_reused is None
                                           else prefix_reused))
        self._record_token(slot, req, int(tok), float(lp0))

    def _record_row_blocks(self, em_np, counts, lps_np) -> None:
        """Record per-row token blocks (``counts[i]`` tokens of row i),
        stopping a row the moment it finishes mid-block."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            for j in range(int(counts[i])):
                if self._slots[i] is None:
                    break              # row hit max_new or eos mid-block
                self._record_token(i, req, int(em_np[i, j]),
                                   float(lps_np[i, j]))

    def _record_token(self, slot: int, req: Request, tok: int,
                      lp: Optional[float] = None):
        req.tokens.append(tok)
        if lp is not None:
            req.lps.append(lp)
        if len(req.tokens) == 1:
            req.t_first = time.perf_counter()
        req.stream.put(tok)
        hit_eos = self.eos_id is not None and tok == self.eos_id
        if len(req.tokens) >= req.max_new or hit_eos:
            req.t_done = time.perf_counter()
            self._completed += 1
            self._lat["ttft"].append(req.t_first - req.t_submit)
            self._lat["e2e"].append(req.t_done - req.t_submit)
            if len(req.tokens) > 1:
                self._lat["per_token"].append(
                    (req.t_done - req.t_first) / (len(req.tokens) - 1))
            req.stream.put(None)
            req.done.set()
            self._slots[slot] = None
            # completion frees the pages: pins released, private
            # non-adopted pages back to the pool, the slot's table row
            # sentineled so post-finish stale writes drop
            self._release_request_kv(req)
            self._sentinel_slot(slot)
            self._flight.record("batch_done", slot=slot,
                                prompt_len=len(req.prompt),
                                tokens=len(req.tokens),
                                ttft_s=req.t_first - req.t_submit,
                                reason="eos" if hit_eos else "length")

    def _fail_request(self, req: Request, err: Optional[BaseException]):
        """Finish a request with an error, or cleanly for err=None (a
        cancel), releasing its pages and pins.  The slot's table row is
        reset by the callers that own one."""
        self._release_request_kv(req)
        req.error = err
        req.stream.put(None)
        req.done.set()
        if err is not None:
            self._flight.record("batch_fail", error=type(err).__name__,
                                tokens=len(req.tokens))

    def _drain_all(self, err: BaseException):
        """Fail every in-flight slot, mid-admission, backlogged and
        queued request with ``err``."""
        for i, req in enumerate(self._slots):
            if req is not None:
                self._fail_request(req, err)
                self._slots[i] = None
                self._sentinel_slot(i)
        if self._adm is not None:
            self._fail_request(self._adm["req"], err)
            self._adm = None
        for a in self._adms:
            self._fail_request(a["req"], err)
        self._adms = []
        while self._pending:
            self._fail_request(self._pending.popleft(), err)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                self._fail_request(req, err)

    def _sweep_cancelled(self) -> None:
        """Free the slots of requests cancelled mid-flight."""
        for i, req in enumerate(self._slots):
            if req is not None and req.cancelled:
                self._fail_request(req, None)
                self._slots[i] = None
                self._sentinel_slot(i)

    def _sentinel_slot(self, slot: int) -> None:
        """Route a freed slot's future writes to the drop page."""
        self._tables[slot] = self._page_sentinel

    def _eos(self) -> int:
        return self.eos_id if self.eos_id is not None else -1

    def _budget_vec(self) -> torch.Tensor:
        """[B] remaining-token budget per slot (0 for empty slots)."""
        return torch.tensor([(r.max_new - len(r.tokens)) if r is not None
                             else 0 for r in self._slots],
                            dtype=torch.int64, device=self.device)

    def _count_loop(self, steps: int) -> None:
        self.loop_stats["host_dispatches"] += 1
        self.loop_stats["device_loop_steps"] += steps

    def _step_active(self, rounds: int) -> None:
        """Run up to ``rounds`` lockstep decode steps over the occupied
        slots and record the emitted tokens.  The fused block may run
        fewer (every row eos'd or out of budget); the steps that ran
        drive the drain."""
        self._load_decode(np.array([s is not None for s in self._slots]))
        if rounds > 1:
            toks, lps, steps = self._paged_multi_step(
                self._eos(), self._budget_vec(), rounds)
            self._count_loop(steps)
            self._step_count += steps
            self._record_row_blocks(toks.cpu().numpy(),
                                    np.full(len(self._slots), steps),
                                    lps.cpu().numpy())
        else:
            self._decode()
            self._count_loop(1)
            tok_np, lp_np = self._last_tok.tolist(), self._step_lp.tolist()
            self._step_count += 1
            for i, req in enumerate(self._slots):
                if req is not None:
                    self._record_token(i, req, int(tok_np[i]),
                                       float(lp_np[i]))

    # ------------------------------------------------------------------
    # the mixed prefill+decode dispatch

    def _slab_finals(self, logits: torch.Tensor, finals: list):
        """Token #1 of each packed final ``(row, n, slot, plen)``, in pack
        order: one batch-1 draw at the row's last real position, the
        serialized final prefill's draw.  Returns ([F] toks, [F] lps)."""
        toks, lps = [], []
        for r, n, _, _ in finals:
            last = logits[r, n - 1][None]                   # [1, V]
            tok = sample_logits(last, self._gen, self.sampling)
            toks.append(tok[0])
            lps.append(_emitted_logprob(last, tok)[0])
        return torch.stack(toks), torch.stack(lps)

    def _mixed_step(self, seg_ids: Optional[torch.Tensor],
                    seg_tables: torch.Tensor, seg_starts: torch.Tensor,
                    finals: list, active_mask: np.ndarray, eos: int,
                    budget: torch.Tensor, num_steps: int):
        """One mixed dispatch (the reference's ``mixed_step``).

        The prefill slab first: row r of ``seg_ids`` [n_seg, C] runs at
        ``seg_starts[r] + arange(C)`` through ``seg_tables[r]`` (unused
        rows ride all-sentinel tables, so their writes drop).
        ``seg_ids`` None: no segment is packed, and the slab forward,
        whose writes would all drop and whose logits nobody reads, is
        skipped (ROADMAP C).  Then each final ``(row, n, slot, plen)``
        samples token #1 (:meth:`_slab_finals`) and is installed at
        ``slot`` with length ``plen``; ``active_mask`` already marks it.
        Then the fused decode block over the host tables: freshly
        installed rows decode in the same dispatch, one whose token #1
        was eos, or with no budget left, enters the loop done.  On
        failure the engine's row state (lengths and last tokens,
        restored in place) is as before the call.  Returns (final toks
        [F], final lps [F], toks [B, num_steps], lps, steps ran)."""
        lengths0, last0 = self._lengths.clone(), self._last_tok.clone()
        try:
            final_toks = final_lps = None
            done0 = budget <= 0
            if seg_ids is not None:
                logits, _ = self._slab_body(self.params, self._pool(),
                                            seg_ids, seg_tables, seg_starts)
            if finals:
                final_toks, final_lps = self._slab_finals(logits, finals)
                idx = torch.tensor([f[2] for f in finals],
                                   device=self.device)
                self._lengths[idx] = torch.tensor([f[3] for f in finals],
                                                  device=self.device)
                self._last_tok[idx] = final_toks
                if eos >= 0:
                    done0[idx] |= final_toks == eos
            self._load_decode(active_mask)
            toks, lps, steps = self._paged_multi_step(
                eos, budget, num_steps, done0=done0)
        except BaseException:
            self._lengths.copy_(lengths0)
            self._last_tok.copy_(last0)
            raise
        return final_toks, final_lps, toks, lps, steps

    def _mixed_iteration(self) -> None:
        """One mixed-mode scheduler iteration: intake, start concurrent
        admissions (at most one per free slot, floor one, so a full batch
        still streams one prompt's chunks), drop cancelled ones, then ONE
        token-budget dispatch."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        # block for work only when truly idle
        timeout = (None if not (any(self._slots) or self._adms
                                or self._pending)
                   else 0.0)
        while True:
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            timeout = 0.0
            if req is None:                # close() sentinel
                break
            self._pending.append(req)
        # serve pending FIFO; serviceable requests pass blocked ones
        still: "deque[Request]" = deque()
        for req in self._pending:
            if req.cancelled:              # dropped while waiting
                self._fail_request(req, None)
            elif len(self._adms) < max(1, len(free)):
                if req.t_sched == 0.0:
                    req.t_sched = time.perf_counter()
                try:
                    start = self._reserve_pages(req)
                except _BlocksExhausted:
                    still.append(req)      # retry when pages free up
                    continue
                except BaseException as e:  # surface to the waiter
                    self._fail_request(req, e)
                    continue
                self._adms.append({"req": req, "start": start, "m": start,
                                   "suffix": req.prompt[start:]})
            else:
                still.append(req)
        self._pending = still
        # cancel latency: one dispatch, as in the serialized loop
        for a in [a for a in self._adms if a["req"].cancelled]:
            self._adms = [x for x in self._adms if x is not a]
            self._fail_request(a["req"], None)
        self._sweep_cancelled()
        if not any(self._slots) and not self._adms:
            return
        self._dispatch_mixed(
            [i for i, s in enumerate(self._slots) if s is None])

    def _dispatch_mixed(self, free: list) -> None:
        """Build and run ONE mixed token-budget dispatch, then drain it.

        Packing (the reference's): every active row takes its
        ``decode_block`` tokens off the top of the budget; the rest packs
        C-token segments FIFO over the concurrent admissions, each its
        next chunks, then its final segment (sampling token #1, installing
        the slot) once a free slot pops; a final with no slot waits while
        later admissions still pack their chunks.  At least one segment is
        packed while an admission is in flight, so a full decode batch
        cannot starve prefill.  Generator draws: one batch-1 draw per
        packed final in pack order, then the decode block's, the
        serialized schedule's order.  The slab tables are uploaded
        once, the decode tables copied once into the static buffer.  A
        failure with packed segments fails the packed requests only; one
        with nothing packed is an engine failure."""
        B, C = self.max_batch, self.prefill_chunk
        n_seg = self._mixed_seg_cap
        n_active = sum(1 for s in self._slots if s is not None)
        room = max(0, self.mixed_token_budget - n_active * self.decode_block)
        want = min(n_seg, max(1, room // C)) if self._adms else 0
        seg_ids = np.zeros((n_seg, C), np.int64)
        seg_tables = np.full((n_seg, self._table_width), self._page_sentinel,
                             np.int32)
        seg_starts = np.zeros((n_seg,), np.int64)
        packed = []          # (row, admission, is_final, slot)
        finals = []          # (row, n, slot, plen), pack order
        prefill_tokens = 0
        r = 0
        for a in self._adms:
            if r >= want:
                break
            table = a["req"]._pkv["table"]
            while r < want and len(a["suffix"]) > C:
                seg_ids[r] = a["suffix"][:C]
                seg_tables[r] = table
                seg_starts[r] = a["start"]
                packed.append((r, a, False, -1))
                prefill_tokens += C
                a["start"] += C
                a["suffix"] = a["suffix"][C:]
                self.chunk_stats["chunks"] += 1
                r += 1
            if r >= want or len(a["suffix"]) > C:
                break
            if not free:
                continue     # the final waits for a slot; later
                             # admissions may still pack their chunks
            slot = free.pop(0)
            n = len(a["suffix"])
            seg_ids[r, :n] = a["suffix"]
            seg_tables[r] = table
            seg_starts[r] = a["start"]
            # decode inside this dispatch pages through the installed
            # row, so its table is live before the dispatch; the radix
            # adoption waits until its pages hold data
            self._tables[slot] = table
            packed.append((r, a, True, slot))
            finals.append((r, n, slot, len(a["req"].prompt)))
            prefill_tokens += n
            r += 1
        active_mask = np.array([s is not None for s in self._slots])
        # the remaining-token budget per row; an installed final has
        # max_new - 1 left (token #1 comes from its slab logits)
        budget_vec = np.array([(s.max_new - len(s.tokens)) if s is not None
                               else 0 for s in self._slots], np.int64)
        for _, a, is_final, slot in packed:
            if is_final:
                active_mask[slot] = True
                budget_vec[slot] = a["req"].max_new - 1
        dev = self.device
        try:
            final_toks, final_lps, toks, lps, steps = self._mixed_step(
                torch.from_numpy(seg_ids).to(dev) if packed else None,
                self._upload(seg_tables), torch.from_numpy(seg_starts).to(dev),
                finals, active_mask, self._eos(),
                torch.from_numpy(budget_vec).to(dev), self.decode_block)
        except BaseException as e:
            if not packed:
                raise
            failed = []
            for _, a, is_final, slot in packed:
                if not any(a["req"] is f for f in failed):
                    failed.append(a["req"])
                if is_final:
                    self._sentinel_slot(slot)
            self._adms = [a for a in self._adms
                          if not any(a["req"] is f for f in failed)]
            for req in failed:
                self._fail_request(req, e)
            return
        cs = self.chunk_stats
        cs["mixed_dispatches"] += 1
        cs["mixed_prefill_tokens"] += prefill_tokens
        cs["mixed_budget_tokens"] += self.mixed_token_budget
        cs["mixed_slab_forwards"] += bool(packed)
        # finals first: slot install, radix adoption (only now: the tree
        # must never serve pages whose K/V is not written), token #1
        if finals:
            ft, fl = final_toks.cpu().numpy(), final_lps.cpu().numpy()
            installed = [(a, slot) for _, a, f, slot in packed if f]
            for i, (a, slot) in enumerate(installed):
                req = a["req"]
                self._adms = [x for x in self._adms if x is not a]
                st = req._pkv
                plen = len(req.prompt)
                bt = self.kv_cache.block_tokens
                if plen // bt >= 1:
                    adopted, store_lease = self.kv_cache.store_shared(
                        req.prompt, st["table"][:plen // bt])
                    st["adopted"] = adopted
                    st["store_lease"] = store_lease
                self._slots[slot] = req
                self._flight.record("batch_admit", slot=slot,
                                    prompt_len=plen, max_new=req.max_new,
                                    prefix_reused=a["m"])
                self._record_token(slot, req, int(ft[i]), float(fl[i]))
        cs["mixed_packed_tokens"] += prefill_tokens + n_active * steps
        if steps > 0:
            self._count_loop(steps)
            self._step_count += steps
            self._record_row_blocks(toks.cpu().numpy(), np.full(B, steps),
                                    lps.cpu().numpy())
            if self._adms:
                cs["interleaved_steps"] += 1

    def _loop(self):
        try:
            self._loop_body()
        except BaseException as e:
            # a failed step (device lost, OOM, ...) must not strand every
            # waiter on a dead thread: fail all in-flight and queued
            # requests, then refuse new work.  The submit lock orders the
            # drain after any submit that already saw _running True.
            self._flight.record("scheduler_crash", error=type(e).__name__,
                                detail=str(e))
            with self._submit_lock:
                self._running = False
                self._drain_all(e)

    def _loop_body(self):
        if self.mixed_token_budget > 0:
            # one token-budget dispatch per iteration; the serialized
            # loop below is the bit-identity reference
            while self._running:
                self._mixed_iteration()
            self._drain_all(
                RuntimeError("engine closed while request in flight"))
            return
        while self._running:
            free = [i for i, s in enumerate(self._slots) if s is None]
            # one dispatch of the in-progress chunked admission (if any)
            self._advance_admission(free)
            # block for work only when truly idle
            timeout = (None if not (any(self._slots) or self._adm
                                    or self._pending)
                       else 0.0)
            while True:
                try:
                    req = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                timeout = 0.0
                if req is None:            # close() sentinel
                    break
                self._pending.append(req)
            # serve pending FIFO: a chunk-needing prompt starts streaming
            # slot-free (only its final prefill needs a slot); short
            # prompts admit into free slots; serviceable requests pass
            # blocked ones
            still: "deque[Request]" = deque()
            for req in self._pending:
                if req.cancelled:          # dropped while waiting
                    self._fail_request(req, None)
                elif self._needs_stream(req):
                    if self._adm is None:
                        if not self._start_admission(req):
                            still.append(req)
                    else:
                        still.append(req)  # one stream at a time
                elif free:
                    slot = free.pop(0)
                    try:
                        self._admit_request(slot, req)
                    except _BlocksExhausted:
                        # give the slot back: a later request whose
                        # pages ARE available takes it this pass
                        free.insert(0, slot)
                        still.append(req)
                    except BaseException as e:  # surface to the waiter
                        self._fail_request(req, e)
                else:
                    still.append(req)      # waiting for a slot
            self._pending = still
            self._sweep_cancelled()
            if not any(self._slots):
                continue
            # fuse a block whenever no admission dispatch could land
            # anyway: not while a prompt streams its chunks, and only
            # when nothing waits or every slot is busy
            all_busy = all(s is not None for s in self._slots)
            fuse = (self.decode_block > 1 and self._adm is None
                    and (not self._pending or all_busy))
            if self._adm is not None:
                self.chunk_stats["interleaved_steps"] += 1
            self._step_active(self.decode_block if fuse else 1)

        self._drain_all(RuntimeError("engine closed while request in flight"))
