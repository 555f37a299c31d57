"""The repo's standard metric set, registered at import time.

A copy of ``distributed_inference_demo_tpu/telemetry/catalog.py``: the
same ``dwt_*`` series (names, help text, types, labels), registered on
the port's own :data:`metrics.REGISTRY`.  The host-memory reader of the
reference's ``monitor/probes.py`` is copied here (:func:`memory_info`),
since ``monitor/`` is not ported yet.

One place owns every Prometheus series name, its help text, and the
mapping from the existing stats surfaces (``runtime/stats.StageStats``
snapshots, ``runtime/batching`` scheduler counters, ``monitor/probes``
measurements, HTTP handler events) onto those series.  Naming convention
``dwt_<subsystem>_<name>_<unit>`` (+ ``_total`` on counters) is enforced
by ``tools/check_metrics_names.py``, which walks :data:`metrics.REGISTRY`
after importing this module.

``scrape(backend)`` is the one entry point the HTTP handlers call: it
refreshes snapshot-bridged series from the backend and renders the
registry.
"""

from __future__ import annotations

from .metrics import (LATENCY_BUCKETS_S, REGISTRY, counter, gauge,
                      histogram)
# the per-tenant SLO/goodput series (dwt_slo_*) register on slo's import
# — pulled in here so "import catalog" keeps meaning "the full standard
# set is registered" (the metric-name lint and /metrics both rely on it)
from . import slo  # noqa: E402  (registers dwt_slo_* series)

# -- stage (pipeline role) series, bridged from StageStats snapshots -------

_STAGE_LABELS = ("role", "device")

STAGE_STEPS = counter(
    "dwt_stage_steps_total",
    "Pipeline compute steps executed by this stage (prefill or decode "
    "chunk)", _STAGE_LABELS)
STAGE_RECV_WAIT = counter(
    "dwt_stage_recv_wait_seconds_total",
    "Seconds this stage spent blocked waiting for inbound ring messages",
    _STAGE_LABELS)
STAGE_COMPUTE = counter(
    "dwt_stage_compute_seconds_total",
    "Seconds of stage compute (deserialize + forward + serialize)",
    _STAGE_LABELS)
STAGE_SEND = counter(
    "dwt_stage_send_seconds_total",
    "Seconds spent in transport send calls", _STAGE_LABELS)
STAGE_RECV_BYTES = counter(
    "dwt_stage_recv_bytes_total",
    "Bytes received from the ring by this stage", _STAGE_LABELS)
STAGE_SENT_BYTES = counter(
    "dwt_stage_sent_bytes_total",
    "Bytes sent to the ring by this stage", _STAGE_LABELS)
STAGE_RECV_MSGS = counter(
    "dwt_stage_recv_messages_total",
    "Ring messages received by this stage", _STAGE_LABELS)
STAGE_SENT_MSGS = counter(
    "dwt_stage_sent_messages_total",
    "Ring messages sent by this stage", _STAGE_LABELS)
STAGE_UPTIME = gauge(
    "dwt_stage_uptime_seconds",
    "Seconds since this stage's stats were created or reset",
    _STAGE_LABELS)

_STAGE_PCT = {}
for _phase, _help in (("compute", "per-step stage compute latency"),
                      ("ring_rtt", "header hidden-out to token-back ring "
                                   "round trip")):
    for _q in (50, 95, 99):
        _STAGE_PCT[(_phase, _q)] = gauge(
            f"dwt_stage_{_phase}_p{_q}_seconds",
            f"p{_q} of {_help} (bounded reservoir)", _STAGE_LABELS)


def update_stage_series(snapshots) -> None:
    """Bridge StageStats ``snapshot()`` dicts (one per pipeline stage,
    as returned by ``PipelineHeader.collect_stats`` / ``/stats``) onto
    the ``dwt_stage_*`` series."""
    for s in snapshots:
        if not isinstance(s, dict) or "role" not in s:
            continue
        lab = {"role": s["role"], "device": s.get("device_id", "")}
        STAGE_STEPS.set_cumulative(s.get("steps", 0), **lab)
        STAGE_RECV_WAIT.set_cumulative(s.get("recv_wait_s", 0.0), **lab)
        STAGE_COMPUTE.set_cumulative(s.get("compute_s", 0.0), **lab)
        STAGE_SEND.set_cumulative(s.get("send_s", 0.0), **lab)
        STAGE_RECV_BYTES.set_cumulative(s.get("bytes_in", 0), **lab)
        STAGE_SENT_BYTES.set_cumulative(s.get("bytes_out", 0), **lab)
        STAGE_RECV_MSGS.set_cumulative(s.get("messages_in", 0), **lab)
        STAGE_SENT_MSGS.set_cumulative(s.get("messages_out", 0), **lab)
        STAGE_UPTIME.set(s.get("uptime_s", 0.0), **lab)
        for (phase, q), g in _STAGE_PCT.items():
            v = s.get(f"{phase}_p{q}_ms")
            # absent key = empty reservoir (fresh or just reset): the
            # gauge must say "no data" (NaN), not keep reporting the
            # pre-reset (e.g. compile-warmup) latency forever
            g.set(v / 1e3 if v is not None else float("nan"), **lab)


# -- batching / speculative series, bridged from scheduler counters --------

BATCH_QUEUE_DEPTH = gauge(
    "dwt_batching_queue_depth_requests",
    "Requests admitted to the scheduler but not yet holding a slot "
    "(submit queue + pending)")
BATCH_ACTIVE = gauge(
    "dwt_batching_active_slots",
    "Slots currently decoding a request")
BATCH_CAPACITY = gauge(
    "dwt_batching_capacity_slots",
    "Total decode slots in the continuous-batching pool")
BATCH_STEPS = counter(
    "dwt_batching_steps_total",
    "Lockstep decode steps (or speculative rounds) executed by the slot "
    "scheduler")
BATCH_COMPLETED = counter(
    "dwt_batching_completed_requests_total",
    "Requests fully served by the slot scheduler")
# (the deprecated dwt_batching_prefix_* aliases of the dwt_kvcache_*
# series are removed; dashboards migrate by recording rule,
# docs/DESIGN.md §10)
_BATCH_PCT = {
    (name, q): gauge(
        f"dwt_batching_{name}_p{q}_seconds",
        f"p{q} {desc} over the last completed requests")
    for name, desc in (("ttft", "time to first token"),
                       ("e2e", "request end-to-end latency"),
                       ("per_token", "per-output-token latency"))
    for q in (50, 95)}
BATCH_MIXED_DISPATCHES = counter(
    "dwt_batching_mixed_dispatches_total",
    "Mixed prefill+decode dispatches executed under the token budget "
    "(docs/DESIGN.md §19; each packs the fused decode block plus zero "
    "or more prefill chunk segments into one program)")
BATCH_MIXED_PREFILL_TOKENS = counter(
    "dwt_batching_mixed_prefill_tokens_total",
    "Prompt tokens prefilled inside mixed dispatches (piggybacked on "
    "the decode step instead of a serialized admission dispatch)")
BATCH_TOKEN_BUDGET_UTILIZATION = gauge(
    "dwt_batching_token_budget_utilization",
    "Packed tokens (prefill segments + decode-loop steps x active "
    "rows) over budgeted tokens across mixed dispatches; NaN until "
    "the first mixed dispatch")
# spec-in-the-batch series (docs/DESIGN.md §22): the scheduler-side view
# of speculation — drafted/accepted feed the acceptance ratio, and the
# per-bucket K_row occupancy gauge is the observable adaptive-K signal
# (a low-acceptance workload walks active rows toward bucket "1")
BATCH_DRAFT_TOKENS = counter(
    "dwt_batching_draft_tokens_total",
    "Draft tokens the slot scheduler offered to the verifier "
    "(speculative rows, serialized or mixed dispatch; adaptive K "
    "prices each row by what it actually offered)")
BATCH_ACCEPTED_TOKENS = counter(
    "dwt_batching_accepted_tokens_total",
    "Draft tokens the verifier accepted on scheduler rows (excl. the "
    "bonus/resample token)")
BATCH_DRAFT_LEN = gauge(
    "dwt_batching_draft_len",
    "Active decode rows currently assigned this adaptive draft-length "
    "bucket (K_row; docs/DESIGN.md §22)", ("bucket",))
BATCH_SPEC_ACCEPT_RATIO = gauge(
    "dwt_batching_spec_acceptance_ratio",
    "accepted/drafted over the scheduler's speculative rows (NaN until "
    "the first draft)")
BATCH_RESUMED = counter(
    "dwt_batching_resumed_requests_total",
    "Requests admitted through the gateway-failover resume path "
    "(docs/DESIGN.md §23): the delivered prefix re-derived through "
    "normal paged admission on a survivor replica, verified "
    "token-by-token, then streamed from the cut point")
BATCH_RESUME_REPLAYED = counter(
    "dwt_batching_resume_replayed_tokens_total",
    "Delivered tokens re-derived and verify-swallowed (never "
    "re-streamed) during resume replays")
BATCH_RESUME_DIVERGED = counter(
    "dwt_batching_resume_diverged_requests_total",
    "Resume replays that regenerated a token differing from the "
    "journal (foreign engine config/seed, or concurrent streams "
    "reordering the rng spend) — failed loudly instead of streaming "
    "a wrong suffix")

# -- block KV cache (runtime/kvcache), bridged from manager snapshots ------

KVCACHE_HITS = counter(
    "dwt_kvcache_hits_total",
    "Prompt lookups that matched at least one whole cached KV block")
KVCACHE_MISSES = counter(
    "dwt_kvcache_misses_total",
    "Prompt lookups (>= one block long) that matched nothing")
KVCACHE_PARTIAL_HIT_TOKENS = counter(
    "dwt_kvcache_partial_hit_tokens_total",
    "Prompt tokens whose prefill was skipped via matched KV blocks "
    "(every hit is a partial-prefix hit: reuse is capped below the "
    "prompt length so the suffix forward is never empty)")
KVCACHE_STORED_BLOCKS = counter(
    "dwt_kvcache_stored_blocks_total",
    "KV blocks admitted into the block pool at prefill time")
KVCACHE_EVICTED_BLOCKS = counter(
    "dwt_kvcache_evicted_blocks_total",
    "KV blocks reclaimed by LRU leaf eviction under pool pressure")
KVCACHE_RESIDENT_BYTES = gauge(
    "dwt_kvcache_resident_bytes",
    "Host bytes held by in-use KV blocks (K + V)")
KVCACHE_CAPACITY_BYTES = gauge(
    "dwt_kvcache_capacity_bytes",
    "Preallocated byte budget of the KV block pool")
KVCACHE_USED_BLOCKS = gauge(
    "dwt_kvcache_used_blocks",
    "KV blocks currently referenced by the radix tree (the prefix "
    "cache's share; compare dwt_kvcache_blocks_in_use for all owners)")
KVCACHE_NODES = gauge(
    "dwt_kvcache_tree_nodes",
    "Radix-tree nodes (excluding the root): distinct shared-prefix "
    "branch points plus leaves")
KVCACHE_DEVICE_RESIDENT_BYTES = gauge(
    "dwt_kvcache_device_resident_bytes",
    "Device HBM held by in-use KV blocks (paged layout: pages allocated "
    "to block tables or the radix tree; 0 on the host-pool dense "
    "layout)")
KVCACHE_BLOCKS_IN_USE = gauge(
    "dwt_kvcache_blocks_in_use",
    "KV blocks currently allocated, all owners: radix-tree cache plus "
    "(paged layout) in-flight requests' private blocks")
KVCACHE_H2D_BYTES = counter(
    "dwt_kvcache_h2d_bytes_total",
    "Bytes copied host-to-device to seed caches from prefix hits "
    "(dense layout's per-hit gather; stays 0 on the paged path, where "
    "hits are device block-table references)")
KVCACHE_PAGE_DTYPE = gauge(
    "dwt_kvcache_page_dtype_info",
    "Page width of the paged KV pool as an info gauge: the series with "
    "the active --kv-dtype label (bf16 / int8 / int4) reads 1, the "
    "others 0 (docs/DESIGN.md §17)", ("dtype",))
KVCACHE_QUANT_SCALE_BYTES = gauge(
    "dwt_kvcache_quant_scale_bytes",
    "Device bytes held by quantization scale (and int4 zero-point) "
    "sidecars of in-use pages — the accounting overhead the narrow "
    "page width pays; 0 on the bf16 layout")

# -- capacity tier below the device pool (docs/DESIGN.md §21) --------------
# demotions gather evicted radix leaves to a host-RAM ring (optionally
# spilling to an mmap'd disk segment); a radix miss whose prefix sits
# demoted promotes back through the staged-adopt seam.  Gauges carry a
# tier label (host / disk); promote H2D bytes ALSO count into
# dwt_kvcache_h2d_bytes_total — the honest-bytes invariant.

KVCACHE_TIER_RESIDENT_BYTES = gauge(
    "dwt_kvcache_tier_resident_bytes",
    "Bytes of demoted KV blocks resident per capacity tier (host ring "
    "/ disk segment); 0 when tiering is off (--kv-host-tier-bytes "
    "unset)", ("tier",))
KVCACHE_TIER_RESIDENT_BLOCKS = gauge(
    "dwt_kvcache_tier_resident_blocks",
    "Demoted KV blocks resident per capacity tier", ("tier",))
KVCACHE_TIER_CAPACITY_BYTES = gauge(
    "dwt_kvcache_tier_capacity_bytes",
    "Configured byte budget per capacity tier (--kv-host-tier-bytes / "
    "--kv-disk-tier-bytes)", ("tier",))
KVCACHE_TIER_DEMOTED_BLOCKS = counter(
    "dwt_kvcache_tier_demoted_blocks_total",
    "KV blocks demoted out of the device pool into the host ring by "
    "LRU leaf eviction (admitted after in-tier dedup)")
KVCACHE_TIER_DEMOTED_BYTES = counter(
    "dwt_kvcache_tier_demoted_bytes_total",
    "Bytes demoted into the host ring (quantized payload + sidecars, "
    "at page width — NOT dequantized)")
KVCACHE_TIER_PROMOTED_BLOCKS = counter(
    "dwt_kvcache_tier_promoted_blocks_total",
    "Demoted KV blocks promoted back into device pages on a tier hit "
    "(move semantics: the tier copy is consumed)")
KVCACHE_TIER_PROMOTED_BYTES = counter(
    "dwt_kvcache_tier_promoted_bytes_total",
    "Bytes promoted back to the device (also counted into "
    "dwt_kvcache_h2d_bytes_total: promotion is the one H2D path the "
    "paged layout has)")
KVCACHE_TIER_DROPPED_BLOCKS = counter(
    "dwt_kvcache_tier_dropped_blocks_total",
    "Demoted blocks dropped at the bottom of the hierarchy (host "
    "overflow with no disk tier, or disk overflow) — the tier is a "
    "cache, dropping is correct, but a high rate means the budgets "
    "are undersized for the prefix working set")
KVCACHE_TIER_SPILLED_BLOCKS = counter(
    "dwt_kvcache_tier_spilled_blocks_total",
    "Blocks spilled host ring -> disk segment under host-budget "
    "pressure (LRU position preserved; payload leaves RAM)")
KVCACHE_TIER_HITS = counter(
    "dwt_kvcache_tier_hits_total",
    "Tier lookups that promoted at least one block, per tier the "
    "payload was read from", ("tier",))

# demote is a device gather + host copy (sub-ms to ms); promote adds
# the staged-adopt scatter dispatch.  Both sit well below the request
# buckets, so they share the dispatch-scale profile buckets.
_TIER_BUCKETS_S = (0.0002, 0.0005, 0.001, 0.002, 0.004, 0.008,
                   0.016, 0.032, 0.064, 0.125, 0.25, 0.5, 1.0, 4.0)
KVCACHE_TIER_DEMOTE_SECONDS = histogram(
    "dwt_kvcache_tier_demote_seconds",
    "Wall time of one demotion (device gather of the evicted leaf + "
    "host-ring insert + budget eviction)", buckets=_TIER_BUCKETS_S)
KVCACHE_TIER_PROMOTE_SECONDS = histogram(
    "dwt_kvcache_tier_promote_seconds",
    "Wall time of one promotion (tier read + staged adopt scatter + "
    "radix re-insert)", buckets=_TIER_BUCKETS_S)


def update_kvcache_tier_series(tier: dict) -> None:
    """Bridge a ``TieredKVStore.snapshot()`` fragment (attached under
    ``snapshot()["tier"]`` by the pool owner) onto the
    ``dwt_kvcache_tier_*`` series."""
    for t in ("host", "disk"):
        KVCACHE_TIER_RESIDENT_BYTES.set(
            tier.get(f"{t}_resident_bytes", 0), tier=t)
        KVCACHE_TIER_RESIDENT_BLOCKS.set(
            tier.get(f"{t}_blocks", 0), tier=t)
        KVCACHE_TIER_CAPACITY_BYTES.set(
            tier.get(f"{t}_capacity_bytes", 0), tier=t)
        KVCACHE_TIER_HITS.set_cumulative(
            tier.get(f"{t}_hits", 0), tier=t)
    KVCACHE_TIER_DEMOTED_BLOCKS.set_cumulative(
        tier.get("demoted_blocks", 0))
    KVCACHE_TIER_DEMOTED_BYTES.set_cumulative(
        tier.get("demoted_bytes", 0))
    KVCACHE_TIER_PROMOTED_BLOCKS.set_cumulative(
        tier.get("promoted_blocks", 0))
    KVCACHE_TIER_PROMOTED_BYTES.set_cumulative(
        tier.get("promoted_bytes", 0))
    KVCACHE_TIER_DROPPED_BLOCKS.set_cumulative(
        tier.get("dropped_blocks", 0))
    KVCACHE_TIER_SPILLED_BLOCKS.set_cumulative(
        tier.get("spilled_blocks", 0))


def update_kvcache_series(kv: dict) -> None:
    """Bridge a ``KVCacheManager.snapshot()`` dict onto the
    ``dwt_kvcache_*`` series."""
    KVCACHE_HITS.set_cumulative(kv.get("hits", 0))
    KVCACHE_MISSES.set_cumulative(kv.get("misses", 0))
    KVCACHE_PARTIAL_HIT_TOKENS.set_cumulative(
        kv.get("partial_hit_tokens", 0))
    KVCACHE_STORED_BLOCKS.set_cumulative(kv.get("stored_blocks", 0))
    KVCACHE_EVICTED_BLOCKS.set_cumulative(kv.get("evicted_blocks", 0))
    KVCACHE_RESIDENT_BYTES.set(kv.get("resident_bytes", 0))
    KVCACHE_CAPACITY_BYTES.set(kv.get("capacity_bytes", 0))
    # used_blocks = the TREE's share (dense snapshots lack tree_blocks
    # because there blocks_used IS tree-owned); blocks_in_use = all
    # owners.  The gap between the two gauges is in-flight requests'
    # private pages — the §11 runbook's leak alert (blocks_in_use >
    # used_blocks while idle) depends on them being bridged from
    # DIFFERENT snapshot keys on the paged layout.
    KVCACHE_USED_BLOCKS.set(kv.get("tree_blocks",
                                   kv.get("blocks_used", 0)))
    KVCACHE_NODES.set(kv.get("nodes", 0))
    KVCACHE_DEVICE_RESIDENT_BYTES.set(kv.get("device_resident_bytes", 0))
    KVCACHE_BLOCKS_IN_USE.set(kv.get("blocks_used", 0))
    KVCACHE_H2D_BYTES.set_cumulative(kv.get("h2d_bytes", 0))
    page_dtype = kv.get("page_dtype")
    if page_dtype is not None:
        from ..ops.quant import KV_DTYPES
        for d in KV_DTYPES:
            KVCACHE_PAGE_DTYPE.set(1 if d == page_dtype else 0, dtype=d)
        KVCACHE_QUANT_SCALE_BYTES.set(kv.get("quant_scale_bytes", 0))
    tier = kv.get("tier")
    if tier:
        update_kvcache_tier_series(tier)


SPEC_ROUNDS = counter(
    "dwt_speculative_rounds_total",
    "Draft/verify rounds executed (speculative or prompt-lookup)")
SPEC_DRAFTED = counter(
    "dwt_speculative_drafted_tokens_total",
    "Draft tokens proposed to the verifier")
SPEC_ACCEPTED = counter(
    "dwt_speculative_accepted_tokens_total",
    "Draft tokens accepted by the verifier (excl. bonus/resample)")
SPEC_ACCEPT_RATIO = gauge(
    "dwt_speculative_accept_ratio",
    "accepted/drafted over the counters' lifetime (NaN until the first "
    "draft)")


def update_batching_series(stats: dict) -> None:
    """Bridge ``ContinuousBatchingEngine.stats()`` (or any dict with the
    same keys) onto the ``dwt_batching_*`` / ``dwt_speculative_*`` /
    ``dwt_kvcache_*`` series (a bare ``{"kvcache": ...}`` fragment — the
    plain engines' ``scrape_stats`` — bridges the kvcache section
    alone)."""
    if "slots" in stats:
        BATCH_CAPACITY.set(stats["slots"])
    if "queue_depth" in stats:
        BATCH_QUEUE_DEPTH.set(stats["queue_depth"])
    if "active_slots" in stats:
        BATCH_ACTIVE.set(stats["active_slots"])
    if "steps" in stats:
        BATCH_STEPS.set_cumulative(stats["steps"])
    lat = stats.get("latency") or {}
    if "completed" in lat:
        BATCH_COMPLETED.set_cumulative(lat["completed"])
    for (name, q), g in _BATCH_PCT.items():
        v = lat.get(f"{name}_p{q}_ms")
        # NaN on empty/reset reservoirs, as in update_stage_series
        g.set(v / 1e3 if v is not None else float("nan"))
    mx = stats.get("mixed") or {}
    if mx:
        BATCH_MIXED_DISPATCHES.set_cumulative(mx.get("dispatches", 0))
        BATCH_MIXED_PREFILL_TOKENS.set_cumulative(
            mx.get("prefill_tokens", 0))
        u = mx.get("budget_utilization")
        BATCH_TOKEN_BUDGET_UTILIZATION.set(
            u if u is not None else float("nan"))
    rs = stats.get("resumed") or {}
    if rs:
        BATCH_RESUMED.set_cumulative(rs.get("requests", 0))
        BATCH_RESUME_REPLAYED.set_cumulative(
            rs.get("replayed_tokens", 0))
        BATCH_RESUME_DIVERGED.set_cumulative(rs.get("diverged", 0))
    kv = stats.get("kvcache") or {}
    if kv:
        update_kvcache_series(kv)
    sp = stats.get("speculative") or {}
    if sp:
        SPEC_ROUNDS.set_cumulative(sp.get("rounds", 0))
        if "drafted" in sp:
            SPEC_DRAFTED.set_cumulative(sp["drafted"])
            BATCH_DRAFT_TOKENS.set_cumulative(sp["drafted"])
        if "accepted" in sp:
            SPEC_ACCEPTED.set_cumulative(sp["accepted"])
            BATCH_ACCEPTED_TOKENS.set_cumulative(sp["accepted"])
        ar = sp.get("acceptance_rate")
        if ar is not None:
            SPEC_ACCEPT_RATIO.set(ar)
        BATCH_SPEC_ACCEPT_RATIO.set(
            ar if ar is not None else float("nan"))
        for b, nrows in (sp.get("k_row_buckets") or {}).items():
            BATCH_DRAFT_LEN.set(nrows, bucket=str(b))


# -- engine device-loop series (event-driven, docs/DESIGN.md §13) ----------
# dispatches/token ≈ 1/K is the headline invariant: the device-resident
# decode loop touches the host once per K-token block (or earlier on an
# all-rows-done exit), so a ratio drifting toward 1 means the fused loop
# stopped engaging (stream_block/decode_block misconfigured, or a code
# path fell back to per-token dispatch)

ENGINE_HOST_DISPATCHES = counter(
    "dwt_engine_host_dispatches_total",
    "Decode-loop programs dispatched from the host, by engine "
    "(one per K-token device-loop block on the fused paths; one per "
    "token on the per-token reference path)", ("engine",))
ENGINE_DEVICE_LOOP_STEPS = counter(
    "dwt_engine_device_loop_steps_total",
    "Decode steps actually executed inside device-resident loops, by "
    "engine (early exit means steps < K for a block whose rows all "
    "finished; divide dwt_engine_host_dispatches_total by this for "
    "dispatches per token)", ("engine",))


# -- HTTP serving series (event-driven, not snapshot-bridged) --------------

HTTP_REQUESTS = counter(
    "dwt_http_requests_total",
    "HTTP requests answered, by route and status code",
    ("route", "code"))
HTTP_REQUEST_SECONDS = histogram(
    "dwt_http_request_seconds",
    "Wall-clock latency of successful blocking inference requests",
    ("route",), buckets=LATENCY_BUCKETS_S)
HTTP_GENERATED_TOKENS = counter(
    "dwt_http_generated_tokens_total",
    "Tokens returned by successful /generate requests")


# -- transport reliability / fault injection series ------------------------
# event-driven from comm/transport.py + comm/faults.py (docs/DESIGN.md §12
# runbook: which counter spiking means what)

TRANSPORT_SEND_RETRIES = counter(
    "dwt_transport_send_retries_total",
    "Transport send attempts beyond the first (bounded retry with "
    "exponential backoff + jitter; a sustained rate means a slow or "
    "flapping peer)")
TRANSPORT_RECONNECTS = counter(
    "dwt_transport_reconnects_total",
    "Outbound sockets torn down and re-dialed after a hard send error")
TRANSPORT_CORRUPT_FRAMES = counter(
    "dwt_transport_corrupt_frames_total",
    "Inbound frames dropped on wire-checksum mismatch (each is a frame "
    "that would otherwise have decoded garbage into the pipeline)")
FAULT_INJECTED = counter(
    "dwt_fault_injected_faults_total",
    "Faults injected by an active chaos fault plan, by kind (drop, "
    "delay, duplicate, reorder, corrupt, partition, partition_drop, "
    "crash_after).  Nonzero outside a chaos run is an incident",
    ("kind",))


# -- disaggregated prefill/decode series (docs/DESIGN.md §15) --------------
# event-driven from runtime/disagg.py: the prefill worker counts what it
# migrates, the decode worker what it adopts, the coordinator what it
# reschedules.  migrated vs adopted pages diverging means migrations are
# completing on the wire but failing to join (staging drops, manifest
# mismatches); rescheduled > 0 names prefill-worker deaths.

DISAGG_MIGRATED_PAGES = counter(
    "dwt_disagg_migrated_pages_total",
    "KV pages a prefill worker streamed to a decode worker (whole "
    "prompt blocks; counted once per completed, acknowledged "
    "migration)")
DISAGG_MIGRATED_BYTES = counter(
    "dwt_disagg_migrated_bytes_total",
    "Wire bytes of page-payload frames in completed migrations "
    "(CRC-framed K/V block runs + metadata)")
DISAGG_ADOPTED_PAGES = counter(
    "dwt_disagg_adopted_pages_total",
    "Migrated pages the decode worker landed in its pool and the radix "
    "tree adopted (device scatter + ownership transfer; the join side "
    "of dwt_disagg_migrated_pages_total)")
DISAGG_JOINED = counter(
    "dwt_disagg_joined_requests_total",
    "Disaggregated requests joined into the decode worker's "
    "continuous-batching drain after a complete migration")
DISAGG_RESCHEDULED = counter(
    "dwt_disagg_rescheduled_requests_total",
    "Handoffs resent to a different prefill worker after the original "
    "died or failed mid-migration (each bumps the request's attempt; "
    "stale-attempt frames are discarded by the decode worker)")
DISAGG_RETRANSMITTED = counter(
    "dwt_disagg_retransmitted_frames_total",
    "Page frames retransmitted after a receiver nack (go-back-n over "
    "dropped or CRC-rejected frames; a sustained rate means a lossy "
    "migration path)")
DISAGG_DROPPED_FRAMES = counter(
    "dwt_disagg_dropped_frames_total",
    "Migration frames the decode worker discarded: duplicates and "
    "reorder holes ((rid, attempt, seq) dedup), stale attempts, and "
    "frames for already-joined requests — each a retry made idempotent")
DISAGG_MIGRATION_SECONDS = histogram(
    "dwt_disagg_migration_seconds",
    "Prefill-worker wall time from handoff start to migration "
    "acknowledged (chunked prefill + page streaming + ack)",
    buckets=LATENCY_BUCKETS_S)
DISAGG_HANDOFF_QUEUE = gauge(
    "dwt_disagg_handoff_queue_depth_requests",
    "Requests submitted to the coordinator that have not yet produced "
    "their first decode-side token (prefilling, migrating, or waiting "
    "for a prefill worker)")
DISAGG_INFLIGHT = gauge(
    "dwt_disagg_inflight_requests",
    "Disaggregated requests submitted and not yet finished, all "
    "phases (handoff + migration + decode)")


# -- replicated serving gateway series (docs/DESIGN.md §16) ----------------
# event-driven from runtime/gateway/: the gateway process holds no
# engine backend, so nothing here is snapshot-bridged — every series is
# incremented at the moment the routing/proxy decision happens.

GATEWAY_PREFIX_ROUTED = counter(
    "dwt_gateway_prefix_routed_requests_total",
    "Requests routed by the prefix-aware policy: the chosen replica's "
    "routing-history index held the longest matching token prefix at "
    "or above the min-length threshold")
GATEWAY_HASHED = counter(
    "dwt_gateway_hashed_requests_total",
    "Requests routed by the consistent-hash-with-bounded-load "
    "fallback (no replica's index matched enough prefix, or routing "
    "keys were unavailable)")
GATEWAY_TIER_ROUTED = counter(
    "dwt_gateway_tier_routed_requests_total",
    "Requests routed by the host-tier second chance: no replica's "
    "device-tier index matched enough prefix, but a replica's "
    "reported demoted-prefix digest (docs/DESIGN.md §21) did — the "
    "replica promotes from its host ring instead of re-prefilling")
GATEWAY_RETRIED = counter(
    "dwt_gateway_retried_requests_total",
    "Requests re-proxied to an alternate replica after the first "
    "choice failed BEFORE its first streamed token (past first token "
    "the gateway never retries: the client already saw output)")
GATEWAY_SHED = counter(
    "dwt_gateway_shed_requests_total",
    "Requests the gateway answered 503/429: every replica down, every "
    "candidate overloaded, or a replica's Retry-After propagated "
    "through federated admission")
# §23 zero-loss streams: a replica dying MID-stream no longer ends the
# request — the gateway journals delivered lines and re-POSTs the
# stream to a survivor with a resume payload (attempts bounded by
# --resume-limit; exhaustion falls back to the error-line contract)
GATEWAY_RESUME_ATTEMPTS = counter(
    "dwt_gateway_resume_attempts_total",
    "Mid-stream failover resume attempts: a journaled stream's replica "
    "died after first token and the gateway re-POSTed the request to "
    "a survivor with the delivered-token journal (docs/DESIGN.md §23)")
GATEWAY_RESUME_SUCCEEDED = counter(
    "dwt_gateway_resume_succeeded_total",
    "Resume attempts that streamed the remainder to completion on a "
    "survivor (the client saw delivered prefix + resumed suffix with "
    "no repeats, gaps, or torn lines)")
GATEWAY_RESUME_EXHAUSTED = counter(
    "dwt_gateway_resume_exhausted_requests_total",
    "Mid-stream deaths whose resume attempts were exhausted (or no "
    "eligible survivor existed): degraded to the documented error-line "
    "fallback")
GATEWAY_RESUME_TTF_SECONDS = histogram(
    "dwt_gateway_resume_ttf_seconds",
    "Time from detecting a mid-stream replica death to the first "
    "resumed token forwarded from the survivor (routing + re-POST + "
    "replay window)",
    buckets=LATENCY_BUCKETS_S)
GATEWAY_REPLICA_FAILURES = counter(
    "dwt_gateway_replica_failures_total",
    "Replica failures recorded by the registry, by bounded failure "
    "reason: probe (health prober), proxy (pre-first-token proxy "
    "death), mid-stream (died after first streamed token), resume "
    "(failed while serving a failover resume), other",
    ("reason",))
GATEWAY_REPLICA_DOWN = counter(
    "dwt_gateway_replica_down_total",
    "Replica up->down transitions: health probes (or proxy failures) "
    "breached the sustain threshold and the registry evicted the "
    "replica from routing")
GATEWAY_REPLICA_UP = counter(
    "dwt_gateway_replica_up_total",
    "Replica down->up transitions: a probe succeeded after the "
    "readmission cooldown and the registry restored the replica")
GATEWAY_UP_REPLICAS = gauge(
    "dwt_gateway_up_replicas",
    "Replicas currently admitted to routing (registered minus "
    "evicted)")
GATEWAY_DRAINING = gauge(
    "dwt_gateway_draining_replicas",
    "Replicas marked draining by an operator or the migration "
    "controller: excluded from NEW routing decisions (no eviction "
    "strike — health is orthogonal) while in-flight proxies keep "
    "streaming.  Stuck nonzero means a drain is not converging")
GATEWAY_PREFIX_HIT_RATIO = gauge(
    "dwt_gateway_prefix_hit_ratio",
    "Per-replica estimate of the fraction of routed requests whose "
    "prefix the replica's cache already held (gateway-side estimate "
    "from its routing-history index; reconcile against the replica's "
    "own dwt_kvcache_hits_total)", ("replica",))
GATEWAY_INDEX_ENTRIES = gauge(
    "dwt_gateway_index_entries",
    "Token-prefix routing-history index entries per replica (bounded; "
    "reconciled against replica-reported dwt_kvcache_* stats)",
    ("replica",))
GATEWAY_QUEUE_DEPTH = gauge(
    "dwt_gateway_queue_depth_requests",
    "Last replica-reported admission queue depth (from /stats), per "
    "replica — the bounded-load signal for the hash fallback",
    ("replica",))
GATEWAY_PROXY_TTFT_SECONDS = histogram(
    "dwt_gateway_proxy_ttft_seconds",
    "Gateway-observed time from accepting /generate to the first "
    "byte proxied back from the replica (includes routing, replica "
    "queueing, and prefill)",
    buckets=LATENCY_BUCKETS_S)
GATEWAY_FLEET_SCRAPES = counter(
    "dwt_gateway_fleet_scrapes_total",
    "Successful per-replica /metrics pulls performed by the "
    "GET /metrics/fleet federation endpoint (cache refreshes, not "
    "client requests — a debounced request serves the cached text "
    "without counting here)", ("replica",))
GATEWAY_FLEET_SCRAPE_FAILURES = counter(
    "dwt_gateway_fleet_failed_scrapes_total",
    "Failed per-replica /metrics pulls during fleet federation; the "
    "endpoint serves that replica's last good text until the bounded "
    "staleness window expires, then drops its section with an "
    "explanatory comment", ("replica",))
GATEWAY_FLEET_SCRAPE_AGE = gauge(
    "dwt_gateway_fleet_scrape_age_seconds",
    "Age of each replica's federated /metrics section at the last "
    "GET /metrics/fleet render — bounded by the staleness window; a "
    "replica pinned at the bound is scraping dead", ("replica",))


# -- live decode-to-decode migration series (docs/DESIGN.md §18) -----------
# event-driven from runtime/migration.py: the source counts what it
# exports and replays, the target what it imports and aborts.  exported
# vs imported diverging means handoffs complete on the wire but fail to
# admit (capacity, dtype mismatch) — pair with failed_migrations in
# /debugz.  replayed_steps > 1 per migration means the freeze window is
# too wide (raise DWT_MIGRATION_FRAME_BLOCKS or check target load).

MIGRATION_EXPORTED = counter(
    "dwt_migration_exported_requests_total",
    "Mid-flight requests a source replica froze, shipped, and handed "
    "off to a target replica (counted once per acknowledged handoff; "
    "the source keeps relaying the stream to its client)")
MIGRATION_IMPORTED = counter(
    "dwt_migration_imported_requests_total",
    "Mid-flight requests a target replica admitted from staged pages "
    "+ state and resumed decoding (the import side of "
    "dwt_migration_exported_requests_total)")
MIGRATION_ABORTED = counter(
    "dwt_migration_aborted_requests_total",
    "Staged migrations the target discarded on a source abort (pgx "
    "frame), staging-cap eviction, or supersession by a newer attempt "
    "— staging bytes are freed and late frames of the attempt drop")
MIGRATION_REPLAYED = counter(
    "dwt_migration_replayed_steps_total",
    "Decode steps the target re-emitted that the source had already "
    "streamed (the at-most-one-step overlap of the atomic handoff; "
    "deduped by absolute step index, never forwarded twice)")
MIGRATION_MOVED_PAGES = counter(
    "dwt_migration_moved_pages_total",
    "KV pages shipped in acknowledged live migrations (phase-1 "
    "snapshot plus phase-2 delta blocks)")
MIGRATION_MOVED_BYTES = counter(
    "dwt_migration_moved_bytes_total",
    "Wire bytes of page-payload frames in acknowledged live "
    "migrations (CRC-framed K/V block runs + metadata)")
MIGRATION_HANDOFF_SECONDS = histogram(
    "dwt_migration_handoff_seconds",
    "Target-side wall time from first staged frame to the request "
    "resuming decode (staging + adopt scatter + admission)",
    buckets=LATENCY_BUCKETS_S)
MIGRATION_INFLIGHT = gauge(
    "dwt_migration_inflight_requests",
    "Live migrations currently between phase-1 start and handoff "
    "ack on the source replica (stuck nonzero means a wedged "
    "target or a partitioned migration path)")


# -- flight recorder / anomaly series --------------------------------------

FLIGHT_EVENTS = counter(
    "dwt_flight_events_total",
    "Events recorded into the process flight-recorder ring "
    "(monotone: overwritten ring entries stay counted)")
FLIGHT_BUFFER = gauge(
    "dwt_flight_buffer_events",
    "Events currently held in the flight-recorder ring")
ANOMALY_EVENTS = counter(
    "dwt_anomaly_events_total",
    "Anomalies flagged by the online detectors, by kind "
    "(straggler_hop, slo_ttft, slo_tpot, queue_saturation, "
    "accept_collapse, pipeline_stall, recompile_storm)", ("kind",))
ANOMALY_LAST = gauge(
    "dwt_anomaly_last_seconds",
    "Epoch seconds of the most recent anomaly of each kind", ("kind",))
ANOMALY_POSTMORTEMS = counter(
    "dwt_anomaly_postmortem_bundles_total",
    "Postmortem bundles written (anomaly triggers, ring stalls, and the "
    "crash handler)")


def update_flight_series() -> None:
    """Bridge the process flight recorder's occupancy onto the
    ``dwt_flight_*`` series (cheap: two locked reads)."""
    from .flightrecorder import get_flight_recorder
    fr = get_flight_recorder()
    FLIGHT_EVENTS.set_cumulative(fr.total)
    FLIGHT_BUFFER.set(len(fr))


# -- cost observatory series (docs/DESIGN.md §20) --------------------------
# fed by telemetry/profiling.py: the sampled dispatch timer observes
# dwt_profile_dispatch_seconds directly at sample time (the slow path —
# it just blocked on the device anyway); everything snapshot-shaped
# (dispatch counts, compile ledger, HBM watermarks) bridges at scrape
# via update_profiling_series so the hot path never touches the
# registry.

# dispatch wall times run far below the request-latency buckets: a
# fused decode step is ~100 µs–10 ms, a prefill chunk tens of ms.
PROFILE_BUCKETS_S = (0.0002, 0.0005, 0.001, 0.002, 0.004, 0.008,
                     0.016, 0.032, 0.064, 0.125, 0.25, 0.5, 1.0, 4.0)

PROFILE_DISPATCH_SECONDS = histogram(
    "dwt_profile_dispatch_seconds",
    "Sampled per-dispatch wall time (block_until_ready) of each jitted "
    "program class, keyed by dispatch signature "
    "program|b<batch-bucket>|c<chunk-or-K>|<kv_dtype> — every "
    "DWT_PROFILE_SAMPLE_N-th dispatch per signature is timed",
    ("signature",), buckets=PROFILE_BUCKETS_S)
PROFILE_SAMPLES = counter(
    "dwt_profile_samples_total",
    "Dispatches the sampled profiler actually timed, per signature "
    "(≈ dispatches / DWT_PROFILE_SAMPLE_N)", ("signature",))
PROFILE_DISPATCHES = counter(
    "dwt_profile_dispatches_total",
    "Total dispatches seen per dispatch signature (counted whenever "
    "sampling is enabled; exactly 0 with DWT_PROFILE_SAMPLE_N=0 — the "
    "off-path touches nothing)", ("signature",))
PROFILE_ACHIEVED_BPS = gauge(
    "dwt_profile_achieved_bytes_per_second",
    "Achieved HBM bandwidth attribution of the last sampled dispatch "
    "per signature, from the KV byte math in ops/quant.py (a lower "
    "bound: weights and activations ride on top)", ("signature",))
PROFILE_ROOFLINE_FRAC = gauge(
    "dwt_profile_roofline_ratio",
    "Achieved-bandwidth attribution over the ROOFLINE_LEDGER.json "
    "ceiling (DWT_ROOFLINE_GBS overrides), per signature",
    ("signature",))

COMPILE_EVENTS = counter(
    "dwt_compile_events_total",
    "XLA compiles observed per jitted program (jit-cache growth across "
    "a tracked call); a program compiling past its variant budget is "
    "the recompile_storm anomaly", ("program",))
COMPILE_SECONDS = counter(
    "dwt_compile_seconds_total",
    "Wall seconds spent in calls that grew a program's jit cache "
    "(trace + lower + compile dominate such calls)", ("program",))
COMPILE_CACHE_ENTRIES = gauge(
    "dwt_compile_cache_entries",
    "Live jit-cache entries per tracked program at last compile",
    ("program",))
COMPILE_VARIANT_BUDGET = gauge(
    "dwt_compile_variant_budget_entries",
    "Documented compiled-variant budget per tracked program (e.g. "
    "mixed_step's two-variant invariant, docs/DESIGN.md §19); only "
    "budgeted programs feed the recompile_storm detector", ("program",))

HBM_OWNER_BYTES = gauge(
    "dwt_hbm_owner_bytes",
    "Current resident bytes per pool owner (kv_page_pool, "
    "kv_host_pool, draft_scratch, stage_pool, migration_staged, "
    "host_tier — the §21 demoted-prefix ring rides the same ledger "
    "even though its bytes live in host RAM), sampled at scheduler "
    "iterations", ("owner",))
HBM_WATERMARK_BYTES = gauge(
    "dwt_hbm_watermark_bytes",
    "High-water-mark resident bytes per pool owner since process start "
    "or the owner's engine close — how big the pool could have been",
    ("owner",))


def update_profiling_series() -> None:
    """Bridge the cost observatory's snapshot-shaped ledgers onto the
    ``dwt_profile_*`` / ``dwt_compile_*`` / ``dwt_hbm_*`` series (cheap:
    three locked dict copies; runs at scrape time only)."""
    from . import profiling
    for sig, n in profiling.get_profiler().dispatch_counts().items():
        PROFILE_DISPATCHES.set_cumulative(n, signature=sig)
    for prog, e in profiling.get_compile_tracker().snapshot().items():
        COMPILE_EVENTS.set_cumulative(e["compiles"], program=prog)
        COMPILE_SECONDS.set_cumulative(e["compile_seconds"],
                                       program=prog)
        COMPILE_CACHE_ENTRIES.set(e["cache_entries"], program=prog)
        if e["variant_budget"] is not None:
            COMPILE_VARIANT_BUDGET.set(e["variant_budget"],
                                       program=prog)
    for owner, w in profiling.get_hbm_watermarks().watermarks().items():
        HBM_OWNER_BYTES.set(w["bytes"], owner=owner)
        HBM_WATERMARK_BYTES.set(w["watermark_bytes"], owner=owner)


# -- monitor series (probes.py measurements) -------------------------------

MONITOR_MEMORY = gauge(
    "dwt_monitor_host_memory_bytes",
    "Host memory from /proc/meminfo, by kind (total/available)",
    ("kind",))
MONITOR_BANDWIDTH = gauge(
    "dwt_monitor_peer_bandwidth_bytes_per_second",
    "Last measured p2p flood bandwidth to a peer (monitor round)",
    ("peer",))
MONITOR_LATENCY = gauge(
    "dwt_monitor_peer_latency_seconds",
    "Last measured TCP connect RTT to a peer (monitor round)",
    ("peer",))
MONITOR_FLOPS = gauge(
    "dwt_monitor_compute_flops_per_second",
    "Measured matmul throughput of the local accelerator (flops probe)")


def memory_info() -> dict:
    """Total/available host memory in bytes, from ``/proc/meminfo`` (a
    copy of the reference's ``monitor.probes.memory_info``)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:  # non-Linux fallback
        pass
    return {"total": total, "available": avail}


def update_monitor_series() -> None:
    """Refresh the host-memory gauges (cheap: one /proc read).  Peer
    bandwidth/latency/flops update when the monitor agent measures
    (:func:`record_monitor_round`)."""
    mem = memory_info()
    MONITOR_MEMORY.set(mem.get("total", 0), kind="total")
    MONITOR_MEMORY.set(mem.get("available", 0), kind="available")


def record_monitor_round(report: dict) -> None:
    """Feed one MonitorAgent ``measure_round`` report into the gauges."""
    for peer, v in (report.get("bandwidth") or {}).items():
        MONITOR_BANDWIDTH.set(v, peer=peer)
    for peer, v in (report.get("latency") or {}).items():
        MONITOR_LATENCY.set(v, peer=peer)
    if report.get("flops"):
        MONITOR_FLOPS.set(report["flops"])


# -- the scrape entry point ------------------------------------------------

def scrape(backend=None) -> str:
    """Refresh snapshot-bridged series from ``backend`` (anything with a
    ``stats()`` dict — a HeaderBackend, a ContinuousBatchingEngine, a
    PipelineWorker's StageStats via ``render_worker``) and render the
    registry.  A failing backend degrades to whatever already rendered —
    a scrape must never 500 because the pipeline is mid-request.

    Backends that poll remote stages prefer ``scrape_stats()`` (bounded
    timeout) over ``stats()`` so a scheduled Prometheus scrape cannot
    stall on a dead stage."""
    update_monitor_series()
    update_flight_series()
    update_profiling_series()
    slo.update_slo_series()
    fn = getattr(backend, "scrape_stats", None) or getattr(
        backend, "stats", None)
    if fn is not None:
        try:
            snap = fn()
        except Exception:
            snap = None
        if isinstance(snap, dict):
            stages = snap.get("stages")
            if isinstance(stages, list):
                update_stage_series(stages)
            else:
                update_batching_series(snap)
    return REGISTRY.render()


def render_worker(stage_stats, device_id: str = "") -> str:
    """Scrape provider for a standalone stage-worker process: bridge its
    StageStats and render (``worker_main --metrics-port``)."""
    update_monitor_series()
    update_flight_series()
    update_profiling_series()
    snap = dict(stage_stats.snapshot(), device_id=device_id)
    update_stage_series([snap])
    return REGISTRY.render()
