"""Continuous batching: requests join and leave a running decode batch.

Counterpart of ``distributed_inference_demo_tpu/runtime/batching.py``'s
``ContinuousBatchingEngine``: plain decode and the draft-model and
prompt-lookup proposers, each in the serialized interleave and the mixed
prefill+decode dispatch.  A fixed pool of batch SLOTS decodes in
lockstep; a new request is admitted into a free slot between two decode
steps.

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
- **Speculation** (``draft_cfg`` or ``prompt_lookup``): each decode step
  becomes a draft/verify ROUND over all slots: K proposals per row (the
  draft model's K+1 one-token paged steps over its own scratch page
  pool, or an n-gram match over the row's device history), ONE target
  verify over ``[B, K+1]`` through the paged hook (on the card the
  prefill kernel), the per-row accept rule
  (``runtime/speculative.verify_emit_per_row``), each row advancing by
  its own count.  A fused dispatch runs ``decode_block`` rounds; every
  reservation carries ``decode_block * (K+1)`` slack tokens, so a
  round's writes past a row's drained length land in its own pages.
  The round is a step over static buffers, captured as a CUDA graph
  per draft width (K serialized; each adaptive bucket {1, K/2, K} in
  the mixed dispatch, whose rows price ``(K_row + 1) * decode_block``
  budget tokens and move K_row by an acceptance EWMA) and replayed once
  per round, each round's block and counts copied into the dispatch's
  ``[R, B, K+1]`` buffer, with one host sync per dispatch.

Telemetry as in the reference: each request carries a ``tenant`` and a
``trace_id`` and closes into the process SLO ledger (``/timeline``);
with a trace id it leaves ``engine.prefill`` and ``engine.decode`` spans
in the engine's :class:`TraceRecorder` (:meth:`export_trace`, ``GET
/trace``); ``stats()`` feeds an :class:`AnomalyMonitor` and carries the
compile and SLO fragments; admission, the decode dispatches and the
mixed dispatch run under sampled dispatch signatures; the pool's
resident bytes feed the HBM watermarks and requests the workload sketch
(``telemetry/profiling``); a scheduler crash writes a postmortem.  The
decode step's graph capture is booked as a compile of the reference's
program (``paged_step``, ``paged_multi_step`` or ``mixed_step``).  A
span or a timeline closes after the readback that already syncs the
step; telemetry adds no sync of its own.

The reference's other jitted programs (admission prefill, the mixed
slab, the draft's dense admission prefill) run eagerly.  Sampling noise
comes from one ``torch.Generator`` seeded with ``seed`` (the reference's
single rng stream): per-request seeds are not honored, and greedy
decoding is bit-exact against ``InferenceEngine``.

KV movement, as in the reference: the host/disk tier below the pool
(``kvcache/tiered.py``: evicted leaves demote through the export seam,
admission promotes a demoted continuation before its ``match``);
:meth:`submit_premigrated` (a disaggregated prefill's blocks adopted
into the tree before admission); :meth:`export_request` /
:meth:`import_request` (live migration: a step-consistent checkpoint
taken on the scheduler thread between dispatches, pages verbatim, the
generator's state in place of the reference's rng key); and
:meth:`submit_resumed` (gateway-failover resume: the delivered prefix
re-derived through ordinary admission and verified token by token, a
sampled stream's generator rewound to its constructor seed right
before the request's first draw).  Exports and imports run on the
scheduler thread, so they are ordered with the graph replays on the
engine's stream: an export reads pages the last replay finished
writing, an adopt lands before the next replay reads the tables.

Over a tensor-parallel ``mesh`` (``parallel/tensor.py``) every rank
holds its kv-head plane of the page pool and runs the paged hook (the
paged kernels on the card) on it; rank 0 owns the scheduler, the page
allocator and sampling, and each forward goes out with its block
tables.  The step runs eagerly there.  A draft's rows and pool are
born on their kv-head shards the same way (its admission row is every
rank's plane of a dense tp cache, written into every rank's draft
pages), the n-gram history stays on rank 0, and the tier and the
fleet move blocks through ``kvcache/device.py``, which gathers every
rank's heads on an export or a demotion and scatters them on an adopt
or a promotion (``parallel.tensor``'s page commands): a block leaves
and enters in the tp=1 layout.
"""

from __future__ import annotations

import copy
import itertools
import math
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import (KVCache, ModelConfig, StageParams, StageSpec,
                           pad_cache_capacity)
from ..models.decoder import stage_forward
from ..ops.attention import slot_attention_impl
from ..ops.paged_attention import BACKENDS as PAGED_BACKENDS
from ..ops.quant import (alloc_kv_pages, resolve_kv_cache_dtype,
                         resolve_kv_dtype)
from ..ops.sampling import SamplingParams, sample_logits
from ..telemetry import postmortem
from ..telemetry import profiling as _profiling
from ..telemetry._env import env_int
from ..telemetry.anomaly import AnomalyMonitor
from ..telemetry.flightrecorder import get_flight_recorder
from ..telemetry.slo import get_slo_ledger, sanitize_tenant
from ..telemetry.tracing import TraceRecorder, to_chrome_trace
from .engine import (GenerationResult, check_capacity, count_device_loop,
                     make_paged_chunk_programs, validate_prefill_chunk)
from .cuda_graph import StepGraphs
from .kvcache.device import (adopt_blocks_into_pages,
                             export_blocks_from_pages, payload_to,
                             staging_device, write_row_to_pages)
from .overload import SchedulerOverloaded
from .prompt_lookup import ngram_propose
from .speculative import draw_noise, propose_token, verify_emit_per_row


# queue nudge from export_request: wakes an idle scheduler so it services
# the export mailbox
_WAKE = object()


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
    # engine-unique request id (``r<salt>-<n>``), the SLO record's rid
    rid: Optional[str] = None
    # tenant identity and the gateway-propagated trace id; the wall-clock
    # submit time anchors the request's spans
    tenant: str = "default"
    trace_id: int = 0
    t_submit_wall: float = 0.0
    # live migration: accumulated seconds frozen between a detaching
    # export and the first relayed token; adopted (migrated-in) requests
    # never close a timeline here (the source keeps the client)
    migration_pause: float = 0.0
    migrated: bool = False
    adopted: bool = False
    # gateway-failover resume: admitted through submit_resumed; the
    # replay window (first recorded to first visible token)
    resumed: bool = False
    resume_pause: float = 0.0

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

        ``draft_cfg`` / ``draft_params`` (a draft model sharing the
        target's vocab; its params on the engine's device) or
        ``prompt_lookup`` (exclusive): speculative slot decoding with
        ``num_draft`` proposals a round; the draft gets its own scratch
        page pool of the target's page type, reserved and freed with each
        request.  ``spec_adaptive``: the mixed dispatch's per-row draft
        length (False pins K_row = ``num_draft``).  Logprobs are refused
        with a proposer, as in the reference.

        ``kv_host_tier_bytes`` / ``kv_disk_tier_path`` /
        ``kv_disk_tier_bytes`` (over their ``DWT_KV_*_TIER_*`` env
        knobs): the host ring and disk segment below the page pool.

        ``mesh``: a ``parallel.mesh.Mesh`` with a tp axis; see the
        module docstring for what it shards and what it refuses.  The
        params may be a full tree (sharded here) or
        ``engine.shard_engine_params``' result."""
        if max_queue_depth is None:
            max_queue_depth = env_int("DWT_MAX_QUEUE_DEPTH", 0)
        self.max_queue_depth = max(0, int(max_queue_depth))
        if mixed_token_budget is None:
            mixed_token_budget = env_int("DWT_MIXED_TOKEN_BUDGET", 0)
        self.mixed_token_budget = max(0, int(mixed_token_budget))
        if prompt_lookup and draft_cfg is not None:
            raise ValueError(
                "prompt_lookup and draft_cfg are exclusive proposers")
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params go together")
        if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab_size}) != target vocab "
                f"({cfg.vocab_size}); speculative decoding needs a "
                "shared token space")
        self._proposer = ("prompt_lookup" if prompt_lookup else
                          "draft" if draft_cfg is not None else None)
        if self._proposer is not None and num_draft < 1:
            raise ValueError("num_draft must be >= 1")
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
        from ..parallel.tensor import check_graph_under_mesh, validate_tp
        self.mesh = mesh
        self._tp = validate_tp(cfg, mesh)
        if self._tp > 1 and draft_cfg is not None:
            validate_tp(draft_cfg, mesh)
        if attn_backend not in PAGED_BACKENDS:
            raise ValueError(f"unknown attn_backend {attn_backend!r}; "
                             f"expected one of {PAGED_BACKENDS}")
        self.device = resolve_device(device)
        p_dev = params.embed["tokens"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, the engine on "
                             f"{self.device}")
        if (draft_params is not None and draft_params.embed["tokens"]
                .device.type != self.device.type):
            raise ValueError("the draft's params live on "
                             f"{draft_params.embed['tokens'].device}, the "
                             f"engine on {self.device}")
        check_graph_under_mesh(mesh, cuda_graph, self.device)
        if self._tp > 1:
            from .engine import engine_params_for_mesh
            params = engine_params_for_mesh(params, cfg, mesh)
            if draft_params is not None:
                draft_params = engine_params_for_mesh(draft_params,
                                                      draft_cfg, mesh)
        self.cfg, self.params = cfg, params
        self.draft_cfg, self.draft_params = draft_cfg, draft_params
        self.num_draft = num_draft
        self.prompt_lookup = prompt_lookup
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
        # reference's buffer capacity S.  The speculative modes fold in
        # SLACK: a fused dispatch may write decode_block * (K+1)
        # positions past a row's drained length before the host learns
        # the accepted counts, and each such write must land in a page
        # the request reserved (else it drops, and a later round attends
        # the missing K/V)
        B, bt = max_batch, block_tokens
        self._slack_tokens = (decode_block * (num_draft + 1)
                              if self._proposer else 0)
        # adaptive per-row draft length (the mixed dispatch): K_row moves
        # within these buckets by an EWMA of the row's acceptance
        K0 = max(1, int(num_draft))
        self._spec_buckets = tuple(sorted({1, max(1, K0 // 2), K0}))
        self.spec_adaptive = bool(spec_adaptive) and bool(self._proposer)
        self._spec_krow = np.full((B,), K0, np.int32)
        self._spec_ewma = np.ones((B,), np.float64)
        self._spec_ewma_alpha = 0.5
        gran = math.lcm(8, bt)
        S = -(-(pad_cache_capacity(self.max_seq) + self._slack_tokens)
              // gran) * gran
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
        # a tp pool's device ops (export, adopt, row write), else None
        self._pool_ops = None
        if self._tp > 1:
            # every rank's kv-head plane (sidecars with their pages)
            from ..parallel.tensor import TPPoolOps
            self._pool_ops = TPPoolOps(mesh)
            self._pk, self._pv = self._pool_ops.alloc(
                shape, self.kv_dtype, page_dtype, self.device)
        else:
            self._pk = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                      self.device)
            self._pv = alloc_kv_pages(shape, self.kv_dtype, page_dtype,
                                      self.device)
        self._tables = np.full((B, self._table_width), N, np.int32)

        # the host/disk tier below the pool: the demote hook gathers the
        # victim's pages out of the live pools; promotion runs in
        # _reserve_pages, before the match
        from .kvcache import (TieredKVStore, make_demote_hook,
                              resolve_tier_config)
        tier_host, tier_path, tier_disk = resolve_tier_config(
            kv_host_tier_bytes, kv_disk_tier_path, kv_disk_tier_bytes)
        self._kv_tier = None
        if tier_host > 0:
            self._kv_tier = TieredKVStore(tier_host, bt, disk_path=tier_path,
                                          disk_bytes=tier_disk)
            self.kv_cache.tier = self._kv_tier
            self.kv_cache.demote_hook = make_demote_hook(
                self._kv_tier, lambda: (self._pk, self._pv),
                ops=self._pool_ops)

        from ..parallel.tensor import make_paged_forward_seam
        self.attn_backend = attn_backend
        self._fwd, self._bind, _ = make_paged_forward_seam(
            cfg, self.spec, mesh, params, bt, self.attn_backend,
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
        # the constructor seed's state, which a sampled resume rewinds to
        self._gen_seed_state = self._gen.get_state()
        if self._proposer is not None:
            self._init_spec(S, n_blocks, page_dtype)
        # captured here, on the constructing thread, before the scheduler
        # thread starts and before any server can hand this engine a
        # request; the warm-up step runs with every slot inactive and
        # every table sentinel, so it changes no slot state
        # the capture is booked as a compile of the reference's program
        # for this mode; paged_multi_step and mixed_step carry the
        # reference's two-variant budget
        self._graphs = StepGraphs(self.device, self._gen, cuda_graph)
        if self._proposer is None:
            program = ("mixed_step" if self.mixed_token_budget > 0 else
                       "paged_multi_step" if decode_block > 1
                       else "paged_step")
            _profiling.get_compile_tracker().register(
                program,
                variant_budget=None if program == "paged_step" else 2)
            self._decode = self._graphs.capture(self._decode_step,
                                                program=program)
        else:
            self._capture_rounds()
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        # disaggregated joins, failover resumes and live migrations
        self.disagg_stats = {"premigrated_requests": 0, "adopted_pages": 0}
        self.resume_stats = {"requests": 0, "replayed_tokens": 0,
                             "diverged": 0}
        self.migration_stats = {"exported_requests": 0,
                                "imported_requests": 0,
                                "detached_requests": 0}
        # rid -> live Request (export_request / get_request addressing)
        # and the export mailbox the scheduler services between dispatches
        self._by_rid: dict = {}
        self._export_q: "deque" = deque()
        # port-only: the rounds run at each draft width (every round, the
        # ones past a finished row's end too), which price the launches
        self.rounds_by_width = {}
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
        self._rid_salt = uuid.uuid4().hex[:8]
        self._rid_counter = itertools.count()
        self._flight = get_flight_recorder()
        # per-engine span sink (GET /trace): prefill/decode spans tagged
        # with the request's trace id; the rid salt keeps proc rows
        # distinct when several engines share a process
        self.tracer = TraceRecorder(f"engine:{self._rid_salt}")
        # co-located span sources drain through export_trace too
        self._aux_tracers: list = []
        # online anomaly watch over the stats() surface; throttled to
        # ~1 Hz inside the scheduler loop
        self.anomaly = AnomalyMonitor(config={
            "engine": type(self).__name__, "max_batch": max_batch,
            "max_seq": self.max_seq, "decode_block": decode_block,
            "prefill_chunk": prefill_chunk,
            "mixed_token_budget": self.mixed_token_budget})
        # cost observatory handles: the sampled dispatch profiler (an
        # unsampled dispatch is one dict increment, no sync), the HBM
        # watermark ledger (this engine's owners reset on close()), and
        # the workload sketch behind GET /sketch
        self._prof = _profiling.get_profiler()
        self._sketch = _profiling.get_sketch()
        self._hbm = _profiling.get_hbm_watermarks()
        self._hbm_owners: set = set()
        # per-token KV bytes (K+V over all layers, sidecar included) for
        # the achieved-GB/s attribution
        self._kv_bytes_per_token = max(
            1, self.kv_cache.block_bytes // self.kv_cache.block_tokens)
        self._running = True
        # serializes submit() against close(): no request can be enqueued
        # after close() returns, so none can slip past the shutdown drain
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # public API

    def submit(self, prompt_ids, max_new_tokens: int,
               tenant: Optional[str] = None,
               trace_id: int = 0,
               request_id: Optional[str] = None,
               _staged: Optional[dict] = None,
               _replay: Optional[dict] = None) -> Request:
        """Queue one request.  ``request_id``: the migration-addressable
        id (no ``:``, the frame tags' delimiter), else an engine-salted
        one.  ``_staged`` / ``_replay``: premigrated blocks and resume
        replay state (:meth:`submit_premigrated`,
        :meth:`submit_resumed`), attached before the queue put."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        check_capacity(self.max_seq, len(prompt), max_new_tokens)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            # admission records the first sampled token unconditionally,
            # so a 0-token request would still produce one
            raise ValueError("max_new_tokens must be >= 1")
        # the page-pool twin of check_capacity: a request whose full
        # table (with the speculative modes' slack) can never be
        # allocated would wait in pending forever
        bt = self.kv_cache.block_tokens
        need = -(-(len(prompt) + max_new_tokens
                   + self._slack_tokens) // bt)
        pool_bound = self.kv_cache.num_blocks
        if self._proposer == "draft":
            # the draft pool cannot evict (no tree), so it binds too
            pool_bound = min(pool_bound, self._dmgr.num_blocks)
        if need > pool_bound:
            raise ValueError(
                f"request needs {need} KV blocks (prompt {len(prompt)} + "
                f"new {max_new_tokens} + slack {self._slack_tokens} at "
                f"{bt} tokens/block) but the paged pool holds only "
                f"{pool_bound}; raise kv_cache_blocks")
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
                      t_submit=time.perf_counter(),
                      t_submit_wall=time.time(),
                      tenant=sanitize_tenant(tenant),
                      trace_id=int(trace_id or 0))
        if request_id is not None and ":" in request_id:
            raise ValueError(f"request_id {request_id!r} contains ':'")
        req.rid = (request_id if request_id is not None
                   else f"r{self._rid_salt}-{next(self._rid_counter)}")
        if _staged is not None:
            req._staged = _staged
        if _replay is not None:
            req.resumed = True
            req._suppress = _replay["suppress"]
            req._rng_rewind = _replay["rewind"]
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            self._by_rid[req.rid] = req
            self._queue.put(req)
        # workload sketch: admitted arrivals only (a shed request never
        # became workload); t_submit doubles as the interarrival clock
        self._sketch.record_request(len(prompt), tenant=req.tenant,
                                    now=req.t_submit)
        return req

    def submit_premigrated(self, prompt_ids, max_new_tokens: int,
                           k_blocks, v_blocks) -> Request:
        """Decode-side join of a disaggregated request: the prompt's
        whole-block K/V, computed by a prefill worker, arrives as host
        block payloads ``[n, L, H, bt, D]`` (CPU tensors, or
        ``QuantizedKVPages`` of them).  Admission first adopts them into
        the pool and the radix tree (:meth:`_import_staged`, on the
        scheduler thread), then admits through the ordinary paged path,
        whose ``match`` finds the adopted prefix: only the suffix
        prefills here.  ``k_blocks=None`` (no whole block) is a plain
        :meth:`submit`.  A quantized payload needs a pool of its width
        and adopts verbatim; a full-width one into a quantized pool
        quantizes at the adopt."""
        if k_blocks is None:
            return self.submit(prompt_ids, max_new_tokens)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        from ..ops.quant import QuantizedKVPages
        if isinstance(k_blocks, QuantizedKVPages):
            if (not isinstance(self._pk, QuantizedKVPages)
                    or self._pk.bits != k_blocks.bits):
                raise ValueError(
                    f"premigrated int{k_blocks.bits} blocks need a "
                    f"matching quantized pool; this engine's pages are "
                    f"kv_dtype={self.kv_dtype!r}")
        else:
            k_blocks = torch.as_tensor(k_blocks)
            v_blocks = torch.as_tensor(v_blocks)
        bt = self.kv_cache.block_tokens
        want = (self.cfg.num_layers, self.cfg.num_kv_heads, bt,
                self.cfg.head_dim)
        if (tuple(k_blocks.shape) != tuple(v_blocks.shape)
                or k_blocks.ndim != 5 or tuple(k_blocks.shape[1:]) != want):
            raise ValueError(
                f"premigrated blocks must be [n, L, H, bt, D] = "
                f"[n, {want[0]}, {want[1]}, {want[2]}, {want[3]}]; got "
                f"K {tuple(k_blocks.shape)} / V {tuple(v_blocks.shape)}")
        if k_blocks.shape[0] > len(prompt) // bt:
            raise ValueError(
                f"{k_blocks.shape[0]} migrated blocks exceed the "
                f"prompt's {len(prompt) // bt} whole blocks")
        return self.submit(prompt, max_new_tokens,
                           _staged={"k": k_blocks, "v": v_blocks,
                                    "imported": False})

    def submit_resumed(self, prompt_ids, max_new_tokens: int,
                       delivered_tokens, *,
                       request_id: Optional[str] = None,
                       tenant: Optional[str] = None,
                       trace_id: int = 0) -> Request:
        """Admit a stream that already delivered tokens on a dead
        replica: re-derive the delivered prefix through ordinary
        admission, verify it token by token (the suppress queue), and
        stream only the suffix.  ``prompt_ids`` / ``max_new_tokens`` are
        the original request's.

        - greedy: the prompt is extended with ``delivered[:-1]``;
          admission re-derives ``delivered[-1]``, which the suppress
          queue verifies.  Exact on any survivor.
        - sampled: the original prompt, with the engine's generator
          rewound to its constructor seed right before this request's
          first draw, so the draws that produced the delivered tokens
          repeat.  Exact when the survivor replays the original run's
          dispatch pattern (same config and seed, the request decoding
          alone from slot 0); a deviation fails the request instead of
          streaming a wrong suffix.

        Replayed tokens append to ``tokens`` but never reach the
        stream; the replay window is recorded as ``resume_pause``."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        delivered = [int(t) for t in
                     np.asarray(delivered_tokens, np.int64).reshape(-1)]
        k = len(delivered)
        if k == 0:
            raise ValueError("resume needs at least one delivered token")
        if k >= max_new_tokens:
            raise ValueError(
                f"{k} delivered tokens leave nothing to resume "
                f"(max_new_tokens={max_new_tokens})")
        if self.eos_id is not None and self.eos_id in delivered:
            raise ValueError(
                "delivered tokens contain eos — the stream already "
                "completed and has nothing to resume")
        if self.sampling.greedy:
            ext = np.concatenate(
                [prompt, np.asarray(delivered[:-1], np.int32)])
            replay = {"suppress": deque([delivered[-1]]), "rewind": False}
            req = self.submit(ext, max_new_tokens - (k - 1),
                              _replay=replay, request_id=request_id,
                              tenant=tenant, trace_id=trace_id)
        else:
            replay = {"suppress": deque(delivered), "rewind": True}
            req = self.submit(prompt, max_new_tokens, _replay=replay,
                              request_id=request_id, tenant=tenant,
                              trace_id=trace_id)
        self.resume_stats["requests"] += 1
        self._flight.record("resume_admit", rid=req.rid, delivered=k,
                            greedy=bool(self.sampling.greedy))
        return req

    def _import_staged(self, req: Request) -> None:
        """Land a premigrated request's staged blocks in the pool and
        adopt them into the tree: scheduler thread only, once, before
        the admission's ``match``.  On pool pressure the request goes
        back to pending (:class:`_BlocksExhausted`), staged data
        intact."""
        st = getattr(req, "_staged", None)
        if st is None or st["imported"]:
            return
        mgr = self.kv_cache
        n = st["k"].shape[0]
        ids = mgr.alloc(n)
        if ids is None:
            req._pkv_blocked = (mgr.epoch, mgr.free_blocks)
            raise _BlocksExhausted()
        bt = mgr.block_tokens
        sig = _profiling.dispatch_signature(
            "disagg_adopt", batch=n, chunk=bt, kv_dtype=self.kv_dtype)
        t0 = self._prof.begin(sig)
        dev = staging_device(self._pk, self._pool_ops)
        adopt_blocks_into_pages(
            self._pk, self._pv, payload_to(st["k"], dev),
            payload_to(st["v"], dev),
            np.asarray(ids, np.int64), num_pages=self._page_sentinel,
            ops=self._pool_ops)
        self._prof.end(sig, t0, out=self.device,
                       hbm_bytes=n * bt * self._kv_bytes_per_token)
        adopted, lease = mgr.store_shared(req.prompt[:n * bt], ids)
        adopted_set = set(adopted)
        leftovers = [b for b in ids if b not in adopted_set]
        if leftovers:
            # another request's store covered some blocks first: the tree
            # kept the incumbent's pages
            mgr.free(leftovers)
        if lease is not None:
            # the admission's own match() re-pins them on this thread
            lease.release()
        st["imported"] = True
        st["k"] = st["v"] = None
        self.disagg_stats["premigrated_requests"] += 1
        self.disagg_stats["adopted_pages"] += len(adopted)
        self._flight.record("disagg_engine_adopt", blocks=len(adopted),
                            prompt_len=len(req.prompt))

    # ------------------------------------------------------------------
    # live migration: checkpoint a decoding row out of this engine, or
    # adopt one into it

    def export_request(self, rid, *, detach: bool = False,
                       timeout: Optional[float] = 30.0) -> dict:
        """Snapshot everything a decoding row owns as a host checkpoint
        :meth:`import_request` resumes from: its used KV pages (verbatim,
        quantized pools included, as CPU tensors), emitted tokens and
        logprobs, the generator's state, length, last token, budget and
        page-width tags.

        Runs on the scheduler thread between dispatches (a mailbox; the
        caller blocks up to ``timeout``), so the snapshot is
        step-consistent and its page gather is queued after the last
        replay on the engine's stream.  A box the scheduler has not
        claimed when ``timeout`` passes is abandoned (a late service is a
        no-op) and TimeoutError raised.

        ``detach=True`` also removes the request (slot freed, tables back
        to sentinel, pages released) and leaves its ``stream`` open: the
        caller owns delivery from here.  The row decodes up to the
        snapshot and never after it, so a target resuming at the
        snapshot replays at most the in-flight step and skips none.

        Speculative rows export at a verify boundary (between
        dispatches): the checkpoint carries the row's adaptive K and its
        acceptance EWMA, not the draft pages or n-gram history, which the
        importer rebuilds from prompt + tokens."""
        req = rid if isinstance(rid, Request) else self._by_rid.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid!r}")
        box = {"req": req, "detach": detach, "ckpt": None, "err": None,
               "claimed": False, "abandoned": False,
               "event": threading.Event()}
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            self._export_q.append(box)
            self._queue.put(_WAKE)
        if not box["event"].wait(timeout):
            with self._submit_lock:
                if not box["claimed"]:
                    box["abandoned"] = True
            if box["abandoned"]:
                raise TimeoutError(
                    "export_request timed out waiting for the "
                    "scheduler; the export was abandoned and the "
                    "request left untouched")
            box["event"].wait()
        if box["err"] is not None:
            raise box["err"]
        return box["ckpt"]

    def _service_exports(self) -> None:
        """Serve queued export mailboxes (scheduler thread, between
        dispatches).  The claimed/abandoned handshake under
        ``_submit_lock`` makes a timed-out caller's box a no-op."""
        while self._export_q:
            box = self._export_q.popleft()
            with self._submit_lock:
                if box.get("abandoned"):
                    continue
                box["claimed"] = True
            try:
                box["ckpt"] = self._export_one(box["req"], box["detach"])
            except BaseException as e:
                box["err"] = e
            box["event"].set()

    def _export_one(self, req: Request, detach: bool) -> dict:
        if req.done.is_set():
            raise ValueError(f"request {req.rid!r} already finished")
        if req.cancelled:
            raise ValueError(f"request {req.rid!r} was cancelled")
        slot = next((i for i, r in enumerate(self._slots) if r is req),
                    None)
        mid_adm = ((self._adm is not None and self._adm["req"] is req)
                   or any(a["req"] is req for a in self._adms))
        if slot is None and mid_adm:
            raise ValueError(
                f"request {req.rid!r} is mid-chunked-admission; retry "
                "after its final prefill lands")
        ckpt = {"rid": req.rid,
                "prompt": np.asarray(req.prompt, np.int32),
                "max_new": int(req.max_new),
                "tokens": list(req.tokens), "lps": list(req.lps),
                "kv_dtype": self.kv_dtype,
                "block_tokens": int(self.kv_cache.block_tokens),
                "eos_id": self.eos_id,
                "tenant": req.tenant, "trace_id": int(req.trace_id),
                "t_submit_wall": float(req.t_submit_wall),
                "migration_pause": float(req.migration_pause)}
        if slot is None:
            # still queued: a cold checkpoint, which the importer turns
            # into a plain submit
            ckpt.update(length=0, last_tok=0, k=None, v=None, rng=None)
            n_used = 0
        else:
            # after T emitted tokens the row's length is plen + T - 1 and
            # K/V [0, length) is valid; the partial tail block ships
            # verbatim (decode rewrites its columns past the length
            # before any query attends them)
            length = int(self._lengths[slot])
            last_tok = int(self._last_tok[slot])
            bt = self.kv_cache.block_tokens
            n_used = -(-length // bt)
            ids = np.asarray(self._tables[slot][:n_used], np.int64)
            k_run, v_run = export_blocks_from_pages(self._pk, self._pv, ids,
                                                    ops=self._pool_ops)
            ckpt.update(length=length, last_tok=last_tok,
                        k=payload_to(k_run, "cpu"),
                        v=payload_to(v_run, "cpu"),
                        rng=self._gen.get_state().clone())
            if self._proposer is not None:
                ckpt["spec_k"] = int(self._spec_krow[slot])
                ckpt["spec_ewma"] = float(self._spec_ewma[slot])
        self.migration_stats["exported_requests"] += 1
        if detach:
            if slot is not None:
                self._slots[slot] = None
                self._sentinel_slot(slot)
                self._release_request_kv(req)
            else:
                try:
                    self._pending.remove(req)
                except ValueError:
                    pass
            if req.rid is not None and self._by_rid.get(req.rid) is req:
                del self._by_rid[req.rid]
            req._detached = True
            # the migration pause runs from here to the first relayed
            # token (the relay closes it)
            req.migrated = True
            req._pause_t0 = time.perf_counter()
            self.migration_stats["detached_requests"] += 1
        self._flight.record("migration_export", rid=req.rid,
                            tokens=len(req.tokens), blocks=n_used,
                            detach=detach)
        return ckpt

    def import_request(self, ckpt: dict,
                       request_id: Optional[str] = None) -> Request:
        """Adopt an :meth:`export_request` checkpoint: the shipped pages
        land in freshly allocated pages (the adopt scatter premigrated
        prefills use), whole-prompt blocks join the radix tree (pages
        holding generated tokens stay private), and decode resumes at
        the checkpointed length with no prefill.  The generator's state
        comes with it, so a single-request resume samples exactly;
        greedy streams are bit-identical regardless."""
        rid = request_id if request_id is not None else ckpt.get("rid")
        if not ckpt.get("tokens") or int(ckpt.get("length") or 0) <= 0:
            # cold checkpoint: plain admission (still adopted: the source
            # relay owns the client-visible timeline)
            req = self.submit(ckpt["prompt"], ckpt["max_new"],
                              request_id=rid,
                              tenant=ckpt.get("tenant"),
                              trace_id=int(ckpt.get("trace_id") or 0))
            req.adopted = True
            return req
        if ckpt.get("kv_dtype", "bf16") != self.kv_dtype:
            raise ValueError(
                f"checkpoint kv_dtype {ckpt.get('kv_dtype')!r} does not "
                f"match this engine's {self.kv_dtype!r} pages")
        bt = self.kv_cache.block_tokens
        if int(ckpt.get("block_tokens", bt)) != bt:
            raise ValueError(
                f"checkpoint block_tokens {ckpt.get('block_tokens')} != "
                f"pool block_tokens {bt}")
        prompt = np.asarray(ckpt["prompt"], np.int32).reshape(-1)
        max_new = int(ckpt["max_new"])
        tokens = [int(t) for t in ckpt["tokens"]]
        if len(tokens) >= max_new:
            raise ValueError("checkpointed request has no budget left")
        check_capacity(self.max_seq, len(prompt), max_new)
        need = -(-(len(prompt) + max_new + self._slack_tokens) // bt)
        if need > self.kv_cache.num_blocks:
            raise ValueError(
                f"checkpoint needs {need} KV blocks but the pool holds "
                f"only {self.kv_cache.num_blocks}")
        length = int(ckpt["length"])
        if length != len(prompt) + len(tokens) - 1:
            raise ValueError(
                f"checkpoint length {length} != prompt {len(prompt)} + "
                f"emitted {len(tokens)} - 1")
        n_used = -(-length // bt)
        n_shipped = int(ckpt["k"].shape[0])
        if n_shipped != n_used:
            raise ValueError(
                f"checkpoint ships {n_shipped} blocks; length "
                f"{length} needs {n_used}")
        req = Request(prompt=prompt, max_new=max_new,
                      t_submit=time.perf_counter(),
                      tenant=sanitize_tenant(ckpt.get("tenant")),
                      trace_id=int(ckpt.get("trace_id") or 0),
                      t_submit_wall=float(ckpt.get("t_submit_wall") or 0),
                      migration_pause=float(
                          ckpt.get("migration_pause") or 0),
                      migrated=True, adopted=True)
        req.rid = rid
        req.tokens = tokens
        req.lps = [float(x) for x in (ckpt.get("lps") or [])]
        req.t_first = time.perf_counter()
        req._resume = {"k": ckpt["k"], "v": ckpt["v"], "length": length,
                       "last_tok": int(ckpt["last_tok"]),
                       "rng": ckpt.get("rng"),
                       "spec_k": int(ckpt.get("spec_k") or 0),
                       "spec_ewma": float(ckpt.get("spec_ewma") or 0.0)}
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("engine is closed")
            if rid is not None:
                self._by_rid[rid] = req
            self._queue.put(req)
        return req

    def get_request(self, rid: str) -> Optional[Request]:
        """The live Request registered under ``rid`` (None once it
        finished or was detached)."""
        return self._by_rid.get(rid)

    def active_requests(self) -> list:
        """``[(rid, emitted, remaining)]`` of the decoding slots (a racy
        read-only snapshot; rows mid-admission or queued are left
        out)."""
        out = []
        for r in list(self._slots):
            if r is not None and r.rid is not None and not r.cancelled:
                out.append((r.rid, len(r.tokens),
                            r.max_new - len(r.tokens)))
        return out

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 seed: int = 0, timeout: Optional[float] = None,
                 logprobs: bool = False, tenant: Optional[str] = None,
                 trace_id: int = 0) -> GenerationResult:
        """Submit each row as its own request (they batch with whatever
        else is in flight) and wait for all.  ``seed`` is accepted for
        surface compatibility but not honored (one engine rng stream).
        On ``timeout`` the requests are cancelled before TimeoutError
        propagates.  Rows that finished early pad their tokens with eos
        (0 without one) and their logprobs with 0.0.  Logprobs are plain
        slot decoding only: the proposers' verify rounds score no
        emitted token."""
        if logprobs and self._proposer is not None:
            raise ValueError(
                "logprobs are not supported with speculative slot "
                "decoding (draft or prompt-lookup proposers)")
        ids = np.asarray(prompt_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        t0 = time.perf_counter()
        reqs = self._submit_rows(ids, max_new_tokens, tenant=tenant,
                                 trace_id=trace_id)
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

    def _submit_rows(self, ids: np.ndarray, max_new_tokens: int,
                     tenant: Optional[str] = None,
                     trace_id: int = 0) -> list:
        """Submit every row or none: rows already admitted are cancelled
        before a later row's rejection (e.g. a shed) propagates."""
        reqs = []
        try:
            for row in ids:
                reqs.append(self.submit(row, max_new_tokens,
                                        tenant=tenant, trace_id=trace_id))
        except Exception:
            for r in reqs:
                r.cancel()
            raise
        return reqs

    def generate_stream(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        seed: int = 0, timeout: Optional[float] = None,
                        logprobs: bool = False,
                        tenant: Optional[str] = None, trace_id: int = 0,
                        resume: Optional[dict] = None):
        """Yield one [batch] token array per step (the HTTP streaming
        surface); with ``logprobs=True``, ([batch] tokens, [batch]
        logprobs) pairs.  Multi-row prompts stream in lockstep of the
        slowest row; finished rows pad with eos (0 without one) and
        logprob 0.0.  An abandoned stream (a client gone, or a stop
        string closing the generator) cancels its in-flight requests,
        which frees their slots and pages after the current step.
        ``timeout``: an overall deadline, after which the requests are
        cancelled and TimeoutError raised.

        ``resume``: ``{"delivered_tokens": [...], "rng_step_offset": N}``
        (gateway-failover resumption, one row only): the stream yields
        only the tokens after the delivered prefix, which
        :meth:`submit_resumed` re-derives and verifies."""
        ids = np.asarray(prompt_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        deadline = None if not timeout else time.monotonic() + timeout
        if resume is not None:
            if ids.shape[0] != 1:
                raise ValueError("resume supports a single prompt row")
            delivered = resume.get("delivered_tokens")
            if not isinstance(delivered, (list, tuple)) or not delivered:
                raise ValueError(
                    "resume.delivered_tokens must be a non-empty list")
            off = resume.get("rng_step_offset", len(delivered))
            if int(off) != len(delivered):
                raise ValueError(
                    f"resume.rng_step_offset ({off}) must equal "
                    f"len(delivered_tokens) ({len(delivered)}) — the "
                    "rng schedule is derived from the delivered count")
            reqs = [self.submit_resumed(ids[0], max_new_tokens,
                                        delivered, tenant=tenant,
                                        trace_id=trace_id)]
        else:
            reqs = self._submit_rows(ids, max_new_tokens, tenant=tenant,
                                     trace_id=trace_id)
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

    def _spec_backlog_tokens(self) -> int:
        """Per-iteration speculative token cost of the active rows,
        sum of (K_row + 1) * decode_block (racy snapshot of scheduler
        state: a gauge)."""
        if self._proposer is None:
            return 0
        total = 0
        for i, r in enumerate(self._slots):
            if r is not None:
                k = (int(self._spec_krow[i]) if self.spec_adaptive
                     else int(self._spec_buckets[-1]))
                total += (k + 1) * self.decode_block
        return total

    def stats(self) -> dict:
        """Scheduler counters for the HTTP ``/stats`` surface: the slot,
        queue, kv-cache, device-loop, latency, chunked-prefill, mixed and
        speculative fragments of the reference's ``stats()``."""
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
        if self.disagg_stats["premigrated_requests"]:
            out["disagg"] = dict(self.disagg_stats)
        if self.resume_stats["requests"]:
            out["resumed"] = dict(self.resume_stats)
        if any(self.migration_stats.values()):
            out["migration"] = dict(self.migration_stats)
        # the compile ledger: the recompile_storm detector below reads it
        compile_snap = _profiling.get_compile_tracker().snapshot()
        if compile_snap:
            out["compile"] = compile_snap
        if self._proposer is not None:
            s = self.spec_stats
            # per-bucket occupancy of the active rows' adaptive K_row:
            # a low-acceptance workload walks mass toward bucket 1
            k_buckets = {
                str(b): int(sum(
                    1 for i, r in enumerate(self._slots)
                    if r is not None and int(self._spec_krow[i]) == b))
                for b in self._spec_buckets}
            out["speculative"] = {
                "proposer": self._proposer,
                "num_draft": self.num_draft, "rounds": s["rounds"],
                "drafted": s["drafted"], "accepted": s["accepted"],
                "adaptive": bool(self.spec_adaptive),
                "k_row_buckets": k_buckets,
                "acceptance_rate": (round(s["accepted"] / s["drafted"], 4)
                                    if s["drafted"] else None)}
            out["spec_backlog_tokens"] = self._spec_backlog_tokens()
        # the per-tenant SLO rollup (goodput + burn rates)
        try:
            out["slo"] = get_slo_ledger().summary()
        except Exception:
            pass
        # the anomaly watch rides every stats() reader as well as the
        # scheduler loop (a /metrics scrape runs on its own thread, so
        # the stall watchdog still fires when the scheduler is wedged);
        # the monitor's throttle swallows the observation its own
        # stats() call would trigger
        self.anomaly.observe(out)
        return out

    def debug_state(self) -> dict:
        """Backend fragment of ``GET /debugz``: anomaly-detector state,
        the observatory and the KV cache picture."""
        out = {"anomaly": self.anomaly.state(),
               "observatory": _profiling.observatory_state(),
               "kvcache": self.kv_cache.debug_state()}
        if self.disagg_stats["premigrated_requests"]:
            out["disagg"] = dict(self.disagg_stats)
        if any(self.migration_stats.values()):
            out["migration"] = dict(self.migration_stats)
        return out

    def register_aux_tracer(self, tracer) -> None:
        """Attach a co-located recorder so :meth:`export_trace` drains it
        with the engine's own spans."""
        self._aux_tracers.append(tracer)

    def export_trace(self) -> dict:
        """Chrome trace of the engine's spans and any registered
        auxiliary recorders (``GET /trace``).  Drains: each span exports
        once."""
        spans = self.tracer.drain()
        for t in self._aux_tracers:
            try:
                spans.extend(t.drain())
            except Exception:
                pass
        return to_chrome_trace(spans)

    def reset_stats(self) -> None:
        self._step_count = 0
        self.loop_stats = {"host_dispatches": 0, "device_loop_steps": 0}
        self.kv_cache.reset_stats()
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        self.rounds_by_width = {}
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
        # the tier dies with its pool: its entries reference this pool's
        # page layout, and the host ring / disk segment must not outlive
        # the engine that budgeted them
        if self._kv_tier is not None:
            self._kv_tier.close()
        if self._tp > 1 and not self._thread.is_alive():
            # every rank's plane of the pool goes with the engine
            from ..parallel.tensor import free_tp
            free_tp(self.mesh, self._pk, self._pv, self._fwd,
                    *((self._dpk, self._dpv, self._fwd_dp, self._fwd_drow)
                      if self._proposer == "draft" else ()))
        # reset-on-close: this engine's pool owners leave the process
        # watermark ledger
        for owner in self._hbm_owners:
            self._hbm.reset(owner)
        self._hbm_owners.clear()

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
        """Decode steps (or speculative rounds) replayed from a captured
        graph."""
        return self._graphs.replays

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
    # speculative slot decoding: the proposers' state and the round

    def _init_spec(self, S: int, n_blocks: int, page_dtype) -> None:
        """The proposer's device state and the round's static buffers.
        Draft model: a forward over the draft's own page pool (pure
        per-request scratch: no tree adopts its pages, so its manager is
        used for the free list only and holds no page while no request is
        in flight), its decode tables, and a dense forward for the
        draft's admission prefill into a temp row (the reference's slot
        impl).  Prompt lookup: the ``[B, S + 1]`` history (prompt +
        emitted per row) plus a dump column that inactive rows' writes
        go to (the reference's out-of-bounds scatter, which drops)."""
        from ..parallel.tensor import make_paged_forward_seam
        from .kvcache import PagedKVCacheManager
        B, K, dev = self.max_batch, self.num_draft, self.device
        bt = self.kv_cache.block_tokens
        self._S = S
        if self._proposer == "draft":
            dcfg = self.draft_cfg
            self.draft_spec = StageSpec(0, 1, 0, dcfg.num_layers)
            self._dmgr = PagedKVCacheManager.for_model(
                dcfg, n_blocks, bt, dtype=self.kv_cache_dtype,
                kv_dtype=self.kv_dtype)
            ND = self._dmgr.num_blocks
            self._dpage_sentinel = ND
            dshape = (dcfg.num_layers, ND + 1, dcfg.num_kv_heads, bt,
                      dcfg.head_dim)
            if self._tp > 1:
                from ..parallel.tensor import alloc_tp_kv, make_forward_seam
                self._dpk, self._dpv = alloc_tp_kv(
                    self.mesh, "pages", dshape, page_dtype, self.kv_dtype)
                # the admission row's forward: every rank its heads of
                # a dense row (the reference's slot impl under tp)
                self._fwd_drow, _ = make_forward_seam(
                    dcfg, self.draft_spec, self.mesh, self.draft_params,
                    attn_backend="slot")
            else:
                self._dpk = alloc_kv_pages(dshape, self.kv_dtype,
                                           page_dtype, dev)
                self._dpv = alloc_kv_pages(dshape, self.kv_dtype,
                                           page_dtype, dev)
            self._dtables = np.full((B, self._table_width), ND, np.int32)
            self._dec_dtables = torch.full((B, self._table_width), ND,
                                           dtype=torch.int32, device=dev)
            self._fwd_dp, self._bind_d, _ = make_paged_forward_seam(
                dcfg, self.draft_spec, self.mesh, self.draft_params, bt,
                self.attn_backend, num_pages=ND, device_type=dev.type)
        else:
            self._hcap = S + 1
            self._history = torch.zeros((B, self._hcap + 1),
                                        dtype=torch.int64, device=dev)
        # a round's outputs: the emitted block (the first k_disp + 1
        # columns), each row's advance; the per-row cap of the mixed
        # dispatch's adaptive K
        self._round_em = torch.zeros((B, K + 1), dtype=torch.int64,
                                     device=dev)
        self._round_n = torch.zeros(B, dtype=torch.int64, device=dev)
        self._krow = torch.full((B,), K, dtype=torch.int64, device=dev)

    def _capture_rounds(self) -> None:
        """The round graphs, one per draft width a dispatch can take:
        ``num_draft`` serialized; each bucket (only K without adaptive K)
        in the mixed dispatch, whose slab and finals run eagerly.  Booked
        as compiles of the reference's programs; the mixed ones carry its
        variant budget ``2 * (len(buckets) + 1)``."""
        mixed = self.mixed_token_budget > 0
        program = (("mixed_pld_step" if mixed else "pld_step")
                   if self._proposer == "prompt_lookup"
                   else ("mixed_spec_step" if mixed else "spec_step"))
        _profiling.get_compile_tracker().register(
            program, variant_budget=(2 * (len(self._spec_buckets) + 1)
                                     if mixed else None))
        widths = ((self._spec_buckets if self.spec_adaptive
                   else (self._spec_buckets[-1],)) if mixed
                  else (self.num_draft,))
        self._rounds = {
            k: self._graphs.capture(
                lambda k=k: self._spec_round(k, capped=mixed),
                program=program)
            for k in widths}

    def _dpool(self) -> KVCache:
        return KVCache(self._dpk, self._dpv, 0)

    def _spec_round(self, k: int, capped: bool) -> None:
        """One speculative round over all slots, on the static buffers and
        in place (the reference's ``one_round`` of ``spec_step`` /
        ``pld_step`` and their mixed twins): ``k`` proposals per row,
        the ``[B, k+1]`` verify through the decode tables, the per-row
        accept (capped by ``_krow`` when ``capped``), inactive rows
        advancing by 0 and keeping their last token.  After it
        ``_round_em[:, :k+1]`` holds the emitted blocks and ``_round_n``
        the counts.  Draft: k+1 one-token paged steps at ``lengths + j``
        through the draft tables (the extra one inserts d_k's K/V).
        Prompt lookup: propose from the history, then append the emitted
        block to each active row's history."""
        lengths, last, active = self._lengths, self._last_tok, self._active
        B, dev, samp = self.max_batch, self.device, self.sampling
        q_logits = None
        if self._proposer == "draft":
            self._bind_d(self._dec_dtables)
            tok, ds, qs = last, [], []
            for j in range(k + 1):
                logits, _ = self._fwd_dp(self.draft_params, tok[:, None],
                                         self._dpool(),
                                         (lengths + j)[:, None], True)
                tok, q = propose_token(logits[:, 0], samp, self._gen)
                ds.append(tok)
                qs.append(q)
            drafts = torch.stack(ds[:k], dim=1)
            if not samp.greedy:
                q_logits = torch.stack(qs[:k], dim=1)
        else:
            # history = prompt + emitted: its valid length is the row's
            # cache length plus the last token
            hist_len = torch.clamp_max(lengths + 1, self._hcap)
            drafts = ngram_propose(self._history[:, :self._hcap], hist_len,
                                   k)
        self._bind(self._dec_tables)
        cols = torch.arange(k + 1, device=dev)
        verify_in = torch.cat([last[:, None], drafts], dim=1)
        t_logits, _ = self._fwd(self.params, verify_in, self._pool(),
                                lengths[:, None] + cols, False)
        u = g = None
        if not samp.greedy:
            u, g = draw_noise(B, k, t_logits.shape[-1], self._gen, dev)
        emitted, n, new_last = verify_emit_per_row(
            t_logits, drafts, q_logits, samp, u, g,
            k_cap=self._krow if capped else None)
        n = torch.where(active, n, 0)
        if self._proposer == "prompt_lookup":
            # inactive rows' (and overflowing) writes go to the dump
            # column, so a freed slot's stale length cannot corrupt its
            # row before re-admission rewrites it
            hc = hist_len[:, None] + cols
            hc = torch.where(active[:, None] & (hc < self._hcap), hc,
                             self._hcap)
            self._history.scatter_(1, hc, emitted)
        self._round_em[:, :k + 1].copy_(emitted)
        self._round_n.copy_(n)
        self._last_tok.copy_(torch.where(active, new_last, last))
        self._lengths.add_(n)

    def _load_spec(self, active_mask: np.ndarray) -> None:
        """A speculative dispatch's inputs: the decode tables and active
        mask, and the draft's tables."""
        self._load_decode(active_mask)
        if self._proposer == "draft":
            self._dec_dtables.copy_(torch.from_numpy(self._dtables))

    def _run_rounds(self, k: int, rounds: int):
        """``rounds`` replays of the width-``k`` round, each one's block
        and counts copied into slot r of the dispatch's buffers; returns
        them on the host ([R, B, k+1], [R, B]): one sync."""
        B = self.max_batch
        em = torch.zeros((rounds, B, k + 1), dtype=torch.int64,
                         device=self.device)
        ns = torch.zeros((rounds, B), dtype=torch.int64, device=self.device)
        step = self._rounds[k]
        self.rounds_by_width[k] = self.rounds_by_width.get(k, 0) + rounds
        for r in range(rounds):
            step()
            em[r].copy_(self._round_em[:, :k + 1])
            ns[r].copy_(self._round_n)
        return em.cpu().numpy(), ns.cpu().numpy()

    def _draft_admit(self, slot: int, req: Request) -> None:
        """The draft side of an admission: the FULL prompt (prefix reuse
        is a target-side property; the draft is cheap) prefilled into a
        dense temp row through :func:`slot_attention_impl`, padded to its
        bucket, and scattered into the request's reserved draft pages;
        the pad tail's garbage is overwritten by the draft steps before
        any query attends it."""
        self._draft_prefill(req.prompt, req._pkv["dtable"])
        self._dtables[slot] = req._pkv["dtable"]

    def _draft_prefill(self, hist: np.ndarray, dtable: np.ndarray) -> None:
        """Prefill ``hist`` through the draft into a dense temp row and
        scatter it into the draft pages of ``dtable``."""
        dcfg, plen = self.draft_cfg, len(hist)
        dpad = np.zeros((1, self._bucket(plen)), np.int64)
        dpad[0, :plen] = hist
        ids = torch.from_numpy(dpad).to(self.device)
        pos = torch.arange(ids.shape[1], device=self.device)[None, :]
        if self._tp > 1:
            from ..parallel.tensor import free_tp, new_tp_cache
            row = new_tp_cache(dcfg, self.mesh, dcfg.num_layers, 1,
                               self._S, self.kv_cache_dtype)
            self._fwd_drow(self.draft_params, ids, row, pos, True)
        else:
            row = KVCache.create(dcfg, dcfg.num_layers, 1, self._S,
                                 dtype=self.kv_cache_dtype,
                                 device=self.device)
            stage_forward(self.draft_params, dcfg, self.draft_spec, ids,
                          row, pos, attn_impl=slot_attention_impl,
                          last_logits_only=True)
        write_row_to_pages(self._dpk, self._dpv, row.keys, row.values,
                           dtable, num_pages=self._dpage_sentinel,
                           ops=self._pool_ops)
        if self._tp > 1:
            free_tp(self.mesh, row.keys, row.values)

    def _seed_history(self, slot: int, hist: np.ndarray, dtable, tok: int
                      ) -> None:
        """A resumed row's proposer state from its history (prompt +
        emitted tokens but the last): the draft's pages, or the n-gram
        history row with ``tok`` after it."""
        if self._proposer == "draft":
            self._draft_prefill(hist, dtable)
            self._dtables[slot] = dtable
        else:
            n = len(hist)
            hpad = np.zeros((self._bucket(n),), np.int64)
            hpad[:n] = hist
            hpad = torch.from_numpy(hpad).to(self.device)
            self._history[slot, :hpad.shape[0]] = hpad
            self._history[slot, n] = int(tok)

    def _seed_proposer(self, slot: int, req: Request, tok: int) -> None:
        """A freshly installed row's proposer state, host-driven after its
        first token is known: the draft's pages, or the history row
        (prompt + token #1, padded to its bucket; the tail past it is
        masked by the history length until overwritten).  A fresh row's
        K_row starts at the widest bucket."""
        if self._proposer == "draft":
            self._draft_admit(slot, req)
        else:
            plen = len(req.prompt)
            hpad = np.zeros((self._bucket(plen),), np.int64)
            hpad[:plen] = req.prompt
            hpad = torch.from_numpy(hpad).to(self.device)
            self._history[slot, :hpad.shape[0]] = hpad
            self._history[slot, plen] = int(tok)
        self._spec_krow[slot] = self._spec_buckets[-1]
        self._spec_ewma[slot] = 1.0

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
        n_total = -(-(plen + req.max_new + self._slack_tokens) // bt)
        # retry gate for a blocked admission: re-attempt only once the
        # pool could have changed, so a waiting request does not re-run
        # match() (and its counters) every scheduler iteration
        state = (mgr.epoch, mgr.free_blocks)
        if getattr(req, "_pkv_blocked", None) == state:
            raise _BlocksExhausted()
        # disaggregated join: land migrated blocks and adopt them before
        # the match below, which then finds them as a prefix hit
        self._import_staged(req)
        # tier promotion rides the same seam, best-effort: pool pressure
        # skips it and the suffix prefills
        if self._kv_tier is not None:
            from .kvcache import promote_prefix
            promote_prefix(mgr, self._kv_tier, self._pk, self._pv,
                           req.prompt, profiler=self._prof,
                           ops=self._pool_ops)
        lease = mgr.match(req.prompt)
        m = lease.tokens if lease is not None else 0
        n_pref = m // bt
        private = mgr.alloc(n_total - n_pref)
        if private is None:
            if lease is not None:
                lease.release()
            req._pkv_blocked = (mgr.epoch, mgr.free_blocks)
            raise _BlocksExhausted()
        dprivate = dtable = None
        if self._proposer == "draft":
            # draft scratch pages, reserved atomically with the target's:
            # a half-reserved admission must not wedge pages while it
            # waits for the other pool
            dprivate = self._dmgr.alloc(n_total)
            if dprivate is None:
                mgr.free(private)
                if lease is not None:
                    lease.release()
                req._pkv_blocked = (mgr.epoch, mgr.free_blocks)
                raise _BlocksExhausted()
            dtable = np.full((self._table_width,), self._dpage_sentinel,
                             np.int32)
            dtable[:n_total] = dprivate
        req._pkv_blocked = None
        table = np.full((self._table_width,), self._page_sentinel, np.int32)
        if lease is not None:
            table[:n_pref] = lease.block_ids
        table[n_pref:n_total] = private
        req._pkv = {"lease": lease, "store_lease": None,
                    "private": private, "adopted": (), "n_pref": n_pref,
                    "table": table, "dprivate": dprivate, "dtable": dtable,
                    "released": False}
        # workload sketch: prefix-hit share, once per successful
        # reservation (a blocked retry must not count twice)
        self._sketch.record_prefix(m, plen)
        return m

    def _release_request_kv(self, req: Request) -> None:
        """Return a request's KV resources: release its pins (matched
        prefix + stored path), free the private pages the tree did not
        adopt and the draft's scratch pages.  Idempotent: completion, cancel, failure and the shutdown
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
        if st["dprivate"] is not None:
            self._dmgr.free(st["dprivate"])

    def _needs_stream(self, req: Request) -> bool:
        """Does this prompt need the one-at-a-time chunk stream, or can
        it admit in one dispatch?  Classified by the effective suffix (a
        prefix hit may shrink a long prompt to one dispatch); memoized on
        the request against the manager's mutation epoch."""
        C = self.prefill_chunk
        if C is None:
            return False
        if getattr(req, "_resume", None) is not None:
            # a live-migration resume never prefills
            return False
        st = getattr(req, "_staged", None)
        if st is not None and not st["imported"]:
            # a premigrated join's suffix after the adopt
            return (len(req.prompt)
                    - st["k"].shape[0] * self.kv_cache.block_tokens) > C
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
        if getattr(req, "_resume", None) is not None:
            self._admit_resume(slot, req)
            return
        start = self._reserve_pages(req)
        self._finish_admission(slot, req, start, req.prompt[start:])

    def _admit_resume(self, slot: int, req: Request) -> None:
        """Adopt a live-migration checkpoint into a free slot: scatter
        the shipped blocks into freshly allocated pages, adopt the
        whole-prompt blocks into the radix tree, and install the slot at
        the checkpointed length and last token: no prefill, decode
        resumes where the source froze.  The generator takes the
        checkpoint's state."""
        rs = req._resume
        mgr = self.kv_cache
        bt = mgr.block_tokens
        plen = len(req.prompt)
        n_total = -(-(plen + req.max_new + self._slack_tokens) // bt)
        state = (mgr.epoch, mgr.free_blocks)
        if getattr(req, "_pkv_blocked", None) == state:
            raise _BlocksExhausted()
        ids = mgr.alloc(n_total)
        if ids is None:
            req._pkv_blocked = state
            raise _BlocksExhausted()
        dids = None
        if self._proposer == "draft":
            # draft scratch, atomically with the target's pages; the
            # draft's K/V is rebuilt below from prompt + tokens
            dids = self._dmgr.alloc(n_total)
            if dids is None:
                mgr.free(ids)
                req._pkv_blocked = state
                raise _BlocksExhausted()
        req._pkv_blocked = None
        length = rs["length"]
        n_used = -(-length // bt)
        dev = staging_device(self._pk, self._pool_ops)
        adopt_blocks_into_pages(
            self._pk, self._pv, payload_to(rs["k"], dev),
            payload_to(rs["v"], dev),
            np.asarray(ids[:n_used], np.int64),
            num_pages=self._page_sentinel, ops=self._pool_ops)
        adopted, store_lease = (), None
        if plen // bt >= 1:
            adopted, store_lease = mgr.store_shared(req.prompt,
                                                    ids[:plen // bt])
        table = np.full((self._table_width,), self._page_sentinel, np.int32)
        table[:n_total] = ids
        dtable = None
        if dids is not None:
            dtable = np.full((self._table_width,), self._dpage_sentinel,
                             np.int32)
            dtable[:n_total] = dids
        req._pkv = {"lease": None, "store_lease": store_lease,
                    "private": ids, "adopted": tuple(adopted),
                    "n_pref": 0, "table": table, "dprivate": dids,
                    "dtable": dtable, "released": False}
        self._tables[slot] = table
        self._lengths[slot] = length
        self._last_tok[slot] = int(rs["last_tok"])
        if rs.get("rng") is not None:
            self._gen.set_state(torch.as_tensor(rs["rng"]))
        if self._proposer is not None:
            # the proposer's state is rebuilt from prompt + emitted
            # tokens: K/V [0, length) = prompt + tokens[:-1], and
            # tokens[-1] is the last token the next round's verify writes
            hist = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.tokens[:-1], np.int32)])
            self._seed_history(slot, hist, dtable, int(rs["last_tok"]))
            k = int(rs.get("spec_k") or 0)
            self._spec_krow[slot] = next(
                (b for b in self._spec_buckets if b >= k),
                self._spec_buckets[-1]) if k > 0 \
                else self._spec_buckets[-1]
            self._spec_ewma[slot] = (float(rs.get("spec_ewma") or 0.0)
                                     or 1.0)
        self._slots[slot] = req
        req._resume = None
        self.migration_stats["imported_requests"] += 1
        self._flight.record("migration_import", slot=slot, rid=req.rid,
                            length=length, tokens=len(req.tokens),
                            blocks=n_used)

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
                sig = _profiling.dispatch_signature(
                    "paged_chunk_mid", batch=1, chunk=C,
                    kv_dtype=self.kv_cache.kv_dtype)
                t0 = self._prof.begin(sig)
                self._paged_chunk_mid(self.params, self._pk, self._pv, head,
                                      self._upload(req._pkv["table"][None]),
                                      a["start"])
                self._prof.end(sig, t0, out=self.device,
                               hbm_bytes=C * self._kv_bytes_per_token)
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
        if self._take_rewind(req):
            self._rewind_generator()
        sig = _profiling.dispatch_signature(
            "paged_prefill", batch=1, chunk=bucket,
            kv_dtype=self.kv_cache.kv_dtype)
        t0 = self._prof.begin(sig)
        tok, lp0 = self._paged_prefill(
            torch.from_numpy(padded).to(self.device),
            self._upload(st["table"][None]), start, len(suffix))
        self._prof.end(sig, t0, out=tok,
                       hbm_bytes=len(suffix) * self._kv_bytes_per_token)
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
        if self._proposer is not None:
            self._seed_proposer(slot, req, int(tok))
        self._slots[slot] = req
        self._flight.record("batch_admit", slot=slot, prompt_len=plen,
                            max_new=req.max_new,
                            prefix_reused=(start if prefix_reused is None
                                           else prefix_reused))
        # the speculative drains score no token, so lps stay empty
        self._record_token(slot, req, int(tok),
                           float(lp0) if self._proposer is None else None)

    @staticmethod
    def _take_rewind(req: Request) -> bool:
        """Whether ``req`` is a sampled resume whose first draw is next
        (once)."""
        rewind = getattr(req, "_rng_rewind", False)
        req._rng_rewind = False
        return rewind

    def _rewind_generator(self) -> None:
        """Sampled resume: the generator back at its constructor seed,
        right before the resumed request's first draw, so the draws that
        produced its delivered tokens repeat."""
        self._gen.set_state(self._gen_seed_state)

    def _record_row_blocks(self, em_np, counts, lps_np=None) -> None:
        """Record per-row token blocks (``counts[i]`` tokens of row i),
        stopping a row the moment it finishes mid-block.  ``lps_np``: the
        tokens' logprobs (plain mode; the speculative drains pass none)."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            for j in range(int(counts[i])):
                if self._slots[i] is None:
                    break              # row hit max_new or eos mid-block
                self._record_token(
                    i, req, int(em_np[i, j]),
                    None if lps_np is None else float(lps_np[i, j]))

    def _drain_spec_blocks(self, em_np, ns_np, k_vec=None) -> None:
        """Record one speculative round's per-row blocks and acceptance
        counters, both from the slots still OCCUPIED at drain time (a
        row that finished mid-block counts in neither).  ``k_vec``: the
        mixed dispatch's per-row draft widths, which price ``drafted``."""
        self._step_count += 1
        self.spec_stats["rounds"] += 1
        live = [i for i, r in enumerate(self._slots) if r is not None]
        self.spec_stats["drafted"] += (
            self.num_draft * len(live) if k_vec is None
            else int(sum(int(k_vec[i]) for i in live)))
        self.spec_stats["accepted"] += int(
            sum(int(ns_np[i]) - 1 for i in live))
        self._record_row_blocks(em_np, ns_np)

    def _update_spec_krow(self, live0, k_vec, ns_np, num_rounds: int
                          ) -> None:
        """EWMA acceptance feedback: fold one dispatch's realized
        acceptance rate (per row live at its start: extra tokens kept
        over drafts offered) into the row's EWMA, then re-bucket K_row to
        the smallest bucket covering ``ewma * num_draft``."""
        buckets = self._spec_buckets
        alpha = self._spec_ewma_alpha
        for i in live0:
            offered = num_rounds * max(1, int(k_vec[i]))
            kept = int(ns_np[:, i].sum()) - num_rounds
            rate = min(1.0, max(0.0, kept / offered))
            self._spec_ewma[i] = ((1.0 - alpha) * self._spec_ewma[i]
                                  + alpha * rate)
            want = self._spec_ewma[i] * self.num_draft
            self._spec_krow[i] = next(
                (b for b in buckets if b >= want), buckets[-1])

    def _record_token(self, slot: int, req: Request, tok: int,
                      lp: Optional[float] = None):
        sup = getattr(req, "_suppress", None)
        if sup:
            # resume replay: the regenerated token must match the
            # journal; it counts in tokens (budget and pages) but is
            # never streamed again.  A mismatch fails the request rather
            # than stream a wrong suffix.
            expect = sup.popleft()
            if tok != expect:
                self.resume_stats["diverged"] += 1
                self._flight.record("resume_diverged", slot=slot,
                                    expect=expect, got=tok,
                                    replayed=len(req.tokens))
                self._slots[slot] = None
                self._sentinel_slot(slot)
                self._fail_request(req, RuntimeError(
                    f"resume replay diverged at replayed token "
                    f"{len(req.tokens) + 1}: journal says {expect}, "
                    f"survivor regenerated {tok} (engine config/seed or "
                    "rng schedule differs from the original replica)"))
                return
            req.tokens.append(tok)
            if lp is not None:
                req.lps.append(lp)
            if len(req.tokens) == 1:
                req.t_first = time.perf_counter()
            self.resume_stats["replayed_tokens"] += 1
            return
        if req.resumed and req.resume_pause == 0.0 and req.t_first:
            # first visible token of a resumed stream: the replay window
            # ends here
            req.resume_pause = max(1e-9, time.perf_counter() - req.t_first)
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
            # workload sketch: realized decode length at completion
            self._sketch.record_decode(len(req.tokens))
            if req.rid is not None and self._by_rid.get(req.rid) is req:
                del self._by_rid[req.rid]
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
            self._close_timeline(req)
            # the waiter wakes last: a request seen done has its pages
            # back in the pool and its accounting closed
            req.stream.put(None)
            req.done.set()

    def _fail_request(self, req: Request, err: Optional[BaseException]):
        """Finish a request with an error, or cleanly for err=None (a
        cancel), releasing its pages and pins.  The slot's table row is
        reset by the callers that own one, before they call here.  The
        waiter wakes last, as on completion: a request seen done is out
        of ``get_request``, its pages are back and its timeline closed."""
        self._release_request_kv(req)
        if req.rid is not None and self._by_rid.get(req.rid) is req:
            del self._by_rid[req.rid]
        if err is not None:
            self._flight.record("batch_fail", error=type(err).__name__,
                                tokens=len(req.tokens))
        self._close_timeline(
            req, error=(type(err).__name__ if err is not None
                        else ("cancelled" if req.cancelled else None)))
        req.error = err
        req.stream.put(None)
        req.done.set()

    def _close_timeline(self, req: Request,
                        error: Optional[str] = None) -> None:
        """Close ``req`` into the process SLO ledger exactly once
        (completion, failure and cancel all funnel here) and, with a
        trace id, record its ``engine.prefill`` / ``engine.decode``
        spans.  Adopted (migrated-in) requests are skipped: the source
        replica keeps the client, so a tenant's tokens count once across
        the fleet.  Best-effort: accounting never fails a request."""
        if req.adopted or getattr(req, "_timeline_closed", False):
            return
        req._timeline_closed = True
        t_done = req.t_done if req.t_done else time.perf_counter()
        t_first = req.t_first if req.t_first else t_done
        t_sched = req.t_sched if req.t_sched else t_first
        try:
            get_slo_ledger().close_request(
                rid=req.rid or "", tenant=req.tenant,
                trace_id=req.trace_id,
                t_submit_wall=req.t_submit_wall,
                queue_wait_s=max(0.0, t_sched - req.t_submit),
                ttft_s=max(0.0, t_first - req.t_submit),
                e2e_s=max(0.0, t_done - req.t_submit),
                tokens=len(req.tokens),
                migration_pause_s=req.migration_pause,
                migrated=req.migrated,
                resume_pause_s=req.resume_pause,
                resumed=req.resumed, replica=self.tracer.proc,
                error=error)
            if req.trace_id:
                # wall-clock starts from the submit wall time + the
                # perf_counter offsets, so no span mixes clocks
                base = req.t_submit_wall or (time.time()
                                             - (t_done - req.t_submit))
                self.tracer.record(
                    "engine.prefill", req.trace_id,
                    ts=base + max(0.0, t_sched - req.t_submit),
                    dur=max(0.0, t_first - t_sched),
                    rid=req.rid, tenant=req.tenant)
                if t_done > t_first and len(req.tokens) > 1:
                    self.tracer.record(
                        "engine.decode", req.trace_id,
                        ts=base + max(0.0, t_first - req.t_submit),
                        dur=t_done - t_first, rid=req.rid,
                        tenant=req.tenant, tokens=len(req.tokens))
        except Exception:
            pass

    def _drain_all(self, err: BaseException):
        """Fail every in-flight slot, mid-admission, backlogged and
        queued request with ``err``."""
        for i, req in enumerate(self._slots):
            if req is not None:
                self._slots[i] = None
                self._sentinel_slot(i)
                self._fail_request(req, err)
        if self._adm is not None:
            self._fail_request(self._adm["req"], err)
            self._adm = None
        for a in self._adms:
            self._fail_request(a["req"], err)
        self._adms = []
        while self._pending:
            self._fail_request(self._pending.popleft(), err)
        while self._export_q:
            box = self._export_q.popleft()
            box["err"] = err
            box["event"].set()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None and req is not _WAKE:
                self._fail_request(req, err)

    def _sweep_cancelled(self) -> None:
        """Free the slots of requests cancelled mid-flight."""
        for i, req in enumerate(self._slots):
            if req is not None and req.cancelled:
                self._slots[i] = None
                self._sentinel_slot(i)
                self._fail_request(req, None)

    def _sentinel_slot(self, slot: int) -> None:
        """Route a freed slot's future writes to the drop page: its target
        table and, with a draft model, its draft table (every round runs
        the draft's steps over all B rows)."""
        self._tables[slot] = self._page_sentinel
        if self._proposer == "draft":
            self._dtables[slot] = self._dpage_sentinel

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
        count_device_loop(type(self).__name__, steps)

    def _sample_hbm(self) -> None:
        """Feed the HBM watermark ledger one scheduler-iteration sample of
        the page pool (host-side integers, no device sync)."""
        snap = self.kv_cache.snapshot()
        self._hbm.sample("kv_page_pool",
                         snap.get("device_resident_bytes", 0)
                         + snap.get("quant_scale_bytes", 0))
        self._hbm_owners.add("kv_page_pool")
        if self._proposer == "draft":
            d = self._dmgr.snapshot()
            self._hbm.sample("draft_scratch",
                             d.get("device_resident_bytes", 0)
                             + d.get("quant_scale_bytes", 0))
            self._hbm_owners.add("draft_scratch")
        if self._kv_tier is not None:
            # host RAM, booked in the same ledger and retired with the
            # engine's other owners
            self._hbm.sample("host_tier", self._kv_tier.host_resident_bytes)
            self._hbm_owners.add("host_tier")

    def _decode_kv_bytes(self, active_mask, steps: int) -> int:
        """KV bytes one decode dispatch touched (achieved-GB/s
        attribution, sampled dispatches only: the lengths readback is a
        sync the unsampled path never pays): every active row re-reads
        its history each step and writes one token per step."""
        lens = self._lengths.cpu().numpy()[active_mask]
        return int((int(lens.sum()) + active_mask.sum())
                   * max(1, steps) * self._kv_bytes_per_token)

    def _step_active(self, rounds: int) -> None:
        """Run up to ``rounds`` lockstep decode steps over the occupied
        slots and record the emitted tokens.  The fused block may run
        fewer (every row eos'd or out of budget); the steps that ran
        drive the drain.  With a proposer each step is a speculative
        round, and all ``rounds`` run (no early exit); a row that
        finishes mid-block stops recording, its writes landing in its
        slack."""
        active_mask = np.array([s is not None for s in self._slots])
        if self._proposer is not None:
            self._load_spec(active_mask)
            em_np, ns_np = self._run_rounds(self.num_draft, rounds)
            self._count_loop(rounds)
            for r in range(rounds):
                self._drain_spec_blocks(em_np[r], ns_np[r])
            return
        self._load_decode(active_mask)
        sig = _profiling.dispatch_signature(
            "paged_multi_step" if rounds > 1 else "paged_step",
            batch=int(active_mask.sum()), chunk=rounds,
            kv_dtype=self.kv_cache.kv_dtype)
        t0 = self._prof.begin(sig)
        if rounds > 1:
            toks, lps, steps = self._paged_multi_step(
                self._eos(), self._budget_vec(), rounds)
            if t0 is not None:
                # sampled only: the KV attribution reads the lengths
                self._prof.end(sig, t0, out=toks,
                               hbm_bytes=self._decode_kv_bytes(
                                   active_mask, steps))
            self._count_loop(steps)
            self._step_count += steps
            self._record_row_blocks(toks.cpu().numpy(),
                                    np.full(len(self._slots), steps),
                                    lps.cpu().numpy())
        else:
            self._decode()
            if t0 is not None:
                self._prof.end(sig, t0, out=self._last_tok,
                               hbm_bytes=self._decode_kv_bytes(
                                   active_mask, 1))
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
        """Token #1 of each packed final ``(row, n, slot, plen, rewind)``,
        in pack order: one batch-1 draw at the row's last real position,
        the serialized final prefill's draw (a sampled resume's rewinds
        the generator first).  Returns ([F] toks, [F] lps)."""
        toks, lps = [], []
        for r, n, _, _, rewind in finals:
            if rewind:
                self._rewind_generator()
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
            if req is _WAKE:               # export_request nudge
                continue
            if req is None:                # close() sentinel
                break
            self._pending.append(req)
        # serve pending FIFO: live-migration resumes adopt straight into
        # a free slot (no prefill to pack); serviceable requests pass
        # blocked ones
        still: "deque[Request]" = deque()
        for req in self._pending:
            if req.cancelled:              # dropped while waiting
                self._fail_request(req, None)
            elif getattr(req, "_resume", None) is not None:
                if free:
                    slot = free.pop(0)
                    try:
                        self._admit_request(slot, req)
                    except _BlocksExhausted:
                        free.insert(0, slot)
                        still.append(req)
                    except BaseException as e:
                        self._fail_request(req, e)
                else:
                    still.append(req)
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
        # exports between dispatches: step-consistent snapshots
        self._service_exports()
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
        with nothing packed is an engine failure.  With a proposer a row
        is priced at ``(K_row + 1) * decode_block`` budget tokens and the
        decode half runs speculative rounds
        (:meth:`_mixed_spec_step`)."""
        B, C = self.max_batch, self.prefill_chunk
        n_seg = self._mixed_seg_cap
        live0 = [i for i, s in enumerate(self._slots) if s is not None]
        n_active = len(live0)
        k_vec = None
        if self._proposer is not None:
            # K_row drafts + the verify/bonus token per round, times the
            # fused rounds; adaptive K shrinks a collapsing acceptor
            # toward K_row = 1 so the slab can use the budget
            k_vec = (self._spec_krow.copy() if self.spec_adaptive
                     else np.full((B,), self._spec_buckets[-1], np.int32))
            room = max(0, self.mixed_token_budget - sum(
                (int(k_vec[i]) + 1) * self.decode_block for i in live0))
        else:
            room = max(0, self.mixed_token_budget
                       - n_active * self.decode_block)
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
            finals.append((r, n, slot, len(a["req"].prompt),
                           self._take_rewind(a["req"])))
            prefill_tokens += n
            r += 1
        spec = self._proposer is not None
        active_mask = np.array([s is not None for s in self._slots])
        dev = self.device
        if spec:
            # a fresh final stays out of this dispatch's rounds
            rounds = self.decode_block if live0 else 0
            k_disp = (max(int(k_vec[i]) for i in live0) if live0
                      else int(self._spec_buckets[-1]))
            prog = ("mixed_pld_step" if self._proposer == "prompt_lookup"
                    else "mixed_spec_step")
        else:
            # the remaining-token budget per row; an installed final has
            # max_new - 1 left (token #1 comes from its slab logits)
            budget_vec = np.array([(s.max_new - len(s.tokens))
                                   if s is not None else 0
                                   for s in self._slots], np.int64)
            for _, a, is_final, slot in packed:
                if is_final:
                    active_mask[slot] = True
                    budget_vec[slot] = a["req"].max_new - 1
            prog = "mixed_step"
        sig = _profiling.dispatch_signature(
            prog, batch=int(active_mask.sum()), chunk=self.decode_block,
            kv_dtype=self.kv_cache.kv_dtype)
        t0 = self._prof.begin(sig)
        seg = (torch.from_numpy(seg_ids).to(dev) if packed else None,
               self._upload(seg_tables), torch.from_numpy(seg_starts).to(dev))
        try:
            if spec:
                final_toks, em_np, ns_np = self._mixed_spec_step(
                    *seg, finals, active_mask, k_vec, k_disp, rounds)
                final_lps, steps = None, rounds
                decoded = int(ns_np[:, live0].sum()) if rounds else 0
                kv_steps, out = rounds * (k_disp + 1), self._last_tok
            else:
                final_toks, final_lps, toks, lps, steps = self._mixed_step(
                    *seg, finals, active_mask, self._eos(),
                    torch.from_numpy(budget_vec).to(dev), self.decode_block)
                decoded, kv_steps, out = n_active * steps, steps, toks
            if t0 is not None:
                # sampled only: packed prefill writes + every active
                # row's per-step history read
                self._prof.end(sig, t0, out=out, hbm_bytes=(
                    prefill_tokens * self._kv_bytes_per_token
                    + self._decode_kv_bytes(active_mask, kv_steps)))
        except BaseException as e:
            if not packed:
                raise
            self._fail_packed(packed, e)
            return
        cs = self.chunk_stats
        cs["mixed_dispatches"] += 1
        cs["mixed_prefill_tokens"] += prefill_tokens
        cs["mixed_budget_tokens"] += self.mixed_token_budget
        cs["mixed_slab_forwards"] += bool(packed)
        # finals first: slot install, radix adoption, token #1
        if finals:
            self._install_finals(
                packed, final_toks.cpu().numpy(),
                None if final_lps is None else final_lps.cpu().numpy())
        cs["mixed_packed_tokens"] += prefill_tokens + decoded
        if steps > 0:
            self._count_loop(steps)
            if spec:
                for r in range(steps):
                    self._drain_spec_blocks(em_np[r], ns_np[r], k_vec=k_vec)
                if self.spec_adaptive:
                    self._update_spec_krow(live0, k_vec, ns_np, steps)
            else:
                self._step_count += steps
                self._record_row_blocks(toks.cpu().numpy(),
                                        np.full(B, steps), lps.cpu().numpy())
            if self._adms:
                cs["interleaved_steps"] += 1

    def _fail_packed(self, packed: list, err: BaseException) -> None:
        """A mixed dispatch failed with packed segments: fail the packed
        requests only, their installed slots' tables back to sentinel."""
        failed = []
        for _, a, is_final, slot in packed:
            if not any(a["req"] is f for f in failed):
                failed.append(a["req"])
            if is_final:
                self._sentinel_slot(slot)
        self._adms = [a for a in self._adms
                      if not any(a["req"] is f for f in failed)]
        for req in failed:
            self._fail_request(req, err)

    def _install_finals(self, packed: list, final_toks, final_lps) -> None:
        """The dispatch's finals in pack order: slot install, radix
        adoption (only now: the tree must never serve pages whose K/V is
        not written), the proposer's seeding, token #1."""
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
            if self._proposer is not None:
                # during the dispatch its draft table was all-sentinel
                # and its history untouched: nothing stale survives
                self._seed_proposer(slot, req, int(final_toks[i]))
            self._slots[slot] = req
            self._flight.record("batch_admit", slot=slot,
                                prompt_len=plen, max_new=req.max_new,
                                prefix_reused=a["m"])
            self._record_token(slot, req, int(final_toks[i]),
                               None if final_lps is None
                               else float(final_lps[i]))

    def _mixed_spec_step(self, seg_ids: Optional[torch.Tensor],
                         seg_tables: torch.Tensor, seg_starts: torch.Tensor,
                         finals: list, active_mask: np.ndarray,
                         k_vec: np.ndarray, k_disp: int, rounds: int):
        """One mixed SPECULATIVE dispatch (the reference's
        ``mixed_spec_step`` / ``mixed_pld_step``): the slab and its
        finals as :meth:`_mixed_step` runs them, except that a fresh
        final sets only its row's length and last token and stays out of
        this dispatch's rounds (its proposer seeds host-side after, the
        serialized admission's timing); then ``rounds`` rounds over the
        rows of ``active_mask``, at the dispatch-wide width ``k_disp`` =
        the widest live K_row, each row's acceptance capped at its own
        K_row.  The generator draws the finals' batch-1 draws in pack
        order, then the rounds'.  On failure the row state is as before
        the call.  Returns (final toks [F] or None, the rounds' blocks
        [R, B, k_disp+1] and counts [R, B] on the host, or None)."""
        lengths0, last0 = self._lengths.clone(), self._last_tok.clone()
        final_toks = em_np = ns_np = None
        try:
            if seg_ids is not None:
                logits, _ = self._slab_body(self.params, self._pool(),
                                            seg_ids, seg_tables, seg_starts)
            if finals:
                final_toks, _ = self._slab_finals(logits, finals)
                idx = torch.tensor([f[2] for f in finals],
                                   device=self.device)
                self._lengths[idx] = torch.tensor([f[3] for f in finals],
                                                  device=self.device)
                self._last_tok[idx] = final_toks
            if rounds:
                self._load_spec(active_mask)
                self._krow.copy_(torch.from_numpy(k_vec.astype(np.int64)))
                em_np, ns_np = self._run_rounds(k_disp, rounds)
        except BaseException:
            self._lengths.copy_(lengths0)
            self._last_tok.copy_(last0)
            raise
        return final_toks, em_np, ns_np

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
            postmortem.trigger(
                "scheduler_crash",
                detail={"error": f"{type(e).__name__}: {e}",
                        "active_slots": sum(1 for s in self._slots
                                            if s is not None),
                        "steps": self._step_count})
            with self._submit_lock:
                self._running = False
                self._drain_all(e)

    def _loop_body(self):
        if self.mixed_token_budget > 0:
            # one token-budget dispatch per iteration; the serialized
            # loop below is the bit-identity reference
            while self._running:
                self.anomaly.observe(self.stats)
                self._sample_hbm()
                self._mixed_iteration()
            self._drain_all(
                RuntimeError("engine closed while request in flight"))
            return
        while self._running:
            # the anomaly watch (throttled; stats() is built only when an
            # observation is due) and one watermark sample an iteration
            self.anomaly.observe(self.stats)
            self._sample_hbm()
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
                if req is _WAKE:           # export_request nudge
                    continue
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
            # exports between dispatches: step-consistent snapshots
            self._service_exports()
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
