"""The cost observatory: per-dispatch profiling, compile accounting,
HBM watermarks, and workload sketches (docs/DESIGN.md §20).

The auto-planner (ROADMAP item 3) needs *measured* artifacts at
dispatch granularity — what each jitted program class actually costs,
how often XLA recompiles, how big the pools really got, and what the
live workload looks like.  This module is the measurement half: four
stitched parts sharing one module-level observatory so every engine,
worker and HTTP surface in the process reports into the same ledger.

1. :class:`DispatchProfiler` — a sampled timer around each dispatch
   class, keyed by a stable *dispatch signature*
   (``program|b<batch-bucket>|c<chunk-or-K>|<kv_dtype>``).  Sampling
   (``DWT_PROFILE_SAMPLE_N``, default every 64th dispatch per
   signature; ``0`` disables) keeps the off-path free: an unsampled
   dispatch is one dict increment and one modulo — ZERO added device
   syncs, no rng spend, no numeric change.  A sampled dispatch
   synchronizes the CUDA device its outputs live on before it reads
   the clock (the reference blocks on the jax outputs), so a step
   replayed from a CUDA graph is timed at its device completion, not
   at its launch; on the CPU there is nothing to wait for.  It records
   wall time plus an achieved-bytes/s attribution computed from the
   one-owner KV byte math in ``ops/quant.py``, reconciled against the
   card's HBM rate (:func:`roofline_ceiling_gbs`).

2. :class:`CompileTracker` — the per-program compile ledger.  The
   port's counterpart of a compile is a CUDA graph capture
   (``runtime/cuda_graph.StepGraphs.capture`` books each one under
   the reference's program name: compiles, capture seconds, graphs
   held, documented variant budget).  The ``stats()["compile"]``
   fragment feeds ``anomaly.py``'s ``recompile_storm`` detector: a
   program captured past its budget (e.g. ``paged_multi_step``'s and
   ``mixed_step``'s two variants) becomes a named anomaly +
   postmortem bundle instead of a silent latency cliff.

3. :class:`HbmWatermarks` — high-water-mark ledger per pool owner
   (``kv_page_pool``, ``kv_host_pool``, ``draft_scratch``,
   ``stage_pool``, ``migration_staged``), sampled at scheduler
   iterations.  "How big could the pool have been" is answered from
   ``dwt_hbm_*`` telemetry instead of OOM bisection.  Watermarks are
   monotone until :meth:`HbmWatermarks.reset` (engine close resets its
   own owners).

4. :class:`WorkloadSketchRecorder` — streaming fixed-bucket histogram
   sketches of the live workload (prompt length, interarrival,
   prefix-hit share, tenant mix, decode lengths).  No RNG reservoir:
   every sketch is a pure fold over the request trace, so the JSON
   artifact (``GET /sketch``, ``tools/sketch.py``) is byte-identical
   for identical traces.  The schema (``SKETCH_SCHEMA_VERSION``) is
   the planner's workload-input contract — ``planner/planner.py`` pins
   the same version and ``tools/check_sketch_schema.py`` lints the
   agreement.

Metric emission is lazy (``catalog`` imported inside the slow paths)
so this module stays importable without pulling the full telemetry
surface, and pure-Python snapshots stay testable without a registry.

The port of ``distributed_inference_demo_tpu/telemetry/profiling.py``;
it differs where the card differs from the TPU: the timer's sync, the
bandwidth ceiling, and captures counted as compiles.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ._env import env_float, env_int

# -- knobs ------------------------------------------------------------------

#: default: time every 64th dispatch per signature (0 disables).
DEFAULT_SAMPLE_N = 64

#: pinned with ``planner.SKETCH_SCHEMA_VERSION`` by
#: ``tools/check_sketch_schema.py`` — bump BOTH together.
SKETCH_SCHEMA_VERSION = 1

#: top-level keys every sketch artifact carries (the planner's parse
#: contract; pinned with ``planner.SKETCH_REQUIRED_KEYS`` by the lint).
SKETCH_REQUIRED_KEYS = ("schema_version", "window_s", "requests",
                        "tenants", "prompt_tokens", "decode_tokens",
                        "interarrival_s", "prefix_hit")


def profile_sample_n() -> int:
    """``DWT_PROFILE_SAMPLE_N`` (>=0; 0 = profiling off-path entirely)."""
    return max(0, env_int("DWT_PROFILE_SAMPLE_N", DEFAULT_SAMPLE_N))


# -- dispatch signatures ----------------------------------------------------

def batch_bucket(n: int) -> int:
    """Next power of two ≥ n — signatures must not fork per exact batch
    size (slots vary by ±1 constantly; the cost regime doesn't)."""
    n = max(1, int(n))
    b = 1
    while b < n:
        b <<= 1
    return b


def dispatch_signature(program: str, batch: int = 1, chunk: int = 0,
                       kv_dtype: str = "bf16") -> str:
    """The stable key every observatory artifact joins on:
    ``program|b<batch-bucket>|c<chunk-or-K>|<kv_dtype>``.

    ``chunk`` is the program's second shape knob — prefill chunk
    length, fused rounds K, or draft length — whatever forks a compiled
    variant.  Identical call shapes MUST map to identical signatures
    (pinned by ``tests/test_profiling.py``)."""
    return (f"{program}|b{batch_bucket(batch)}|c{max(0, int(chunk))}"
            f"|{kv_dtype}")


def parse_signature(sig: str) -> dict:
    """Inverse of :func:`dispatch_signature` (tools-side: merge keys)."""
    parts = sig.split("|")
    if len(parts) != 4 or not parts[1].startswith("b") \
            or not parts[2].startswith("c"):
        raise ValueError(f"not a dispatch signature: {sig!r}")
    return {"program": parts[0], "batch_bucket": int(parts[1][1:]),
            "chunk": int(parts[2][1:]), "kv_dtype": parts[3]}


# -- roofline reconciliation ------------------------------------------------

#: HBM GB/s by ``torch.cuda.get_device_name()``: the card's data-sheet
#: memory rate (the H100 SXM's 3.35 TB/s, the figure PERF.md divides by)
CARD_HBM_GBS = {"NVIDIA H100 80GB HBM3": 3350.0}

_ROOFLINE_CACHE: List[Optional[float]] = []


def roofline_ceiling_gbs() -> Optional[float]:
    """The HBM GB/s ceiling achieved-bandwidth attributions reconcile
    against: ``DWT_ROOFLINE_GBS`` env override, else the card's own
    figure (:data:`CARD_HBM_GBS`, keyed by the current CUDA device's
    name), else None (no frac emitted): on the CPU, or on a card the
    table does not name.  Cached after the first lookup."""
    env = env_float("DWT_ROOFLINE_GBS", 0.0)
    if env > 0:
        return env
    if _ROOFLINE_CACHE:
        return _ROOFLINE_CACHE[0]
    ceiling: Optional[float] = None
    try:
        import torch
        if torch.cuda.is_available():
            ceiling = CARD_HBM_GBS.get(torch.cuda.get_device_name())
    except Exception:
        ceiling = None
    _ROOFLINE_CACHE.append(ceiling)
    return ceiling


def kv_dispatch_bytes(tokens: int, layers: int, kv_heads: int,
                      head_dim: int, kv_dtype: Optional[str],
                      base_dtype) -> int:
    """HBM bytes the KV pages contribute to one dispatch touching
    ``tokens`` (written or read), through the one-owner per-(token,
    head) byte math in ``ops/quant.py`` — K and V both counted.  An
    *attribution*, not a meter: weights and activations ride on top,
    so per-signature achieved-bytes/s is a lower bound."""
    from ..ops.quant import kv_token_head_bytes
    return (max(0, int(tokens)) * max(1, int(layers))
            * max(1, int(kv_heads)) * 2
            * kv_token_head_bytes(head_dim, kv_dtype, base_dtype))


# -- 1. dispatch profiler ---------------------------------------------------

class _SigStats:
    """Per-signature accumulator: exact dispatch count, sampled-timing
    sums, and a last-256 duration window for deterministic percentiles
    (no RNG reservoir)."""

    __slots__ = ("dispatches", "samples", "total_s", "durations",
                 "bytes_total", "last_gbs")

    def __init__(self) -> None:
        self.dispatches = 0
        self.samples = 0
        self.total_s = 0.0
        self.durations: deque = deque(maxlen=256)
        self.bytes_total = 0
        self.last_gbs = 0.0


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def _cuda_device(out):
    """The CUDA device of the first CUDA tensor in ``out`` (a tensor, a
    ``torch.device``, or a list/tuple/dict of them, or an object with
    tensor leaves such as ``QuantizedKVPages``), else None."""
    import torch
    if isinstance(out, torch.device):
        return out if out.type == "cuda" else None
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if isinstance(out, dict):
        out = list(out.values())
    elif not isinstance(out, (list, tuple)):
        out = [getattr(out, "data", None)]
    for leaf in out:
        dev = _cuda_device(leaf) if leaf is not None else None
        if dev is not None:
            return dev
    return None


class DispatchProfiler:
    """Sampled device-completion timer keyed by dispatch signature.

    Hot-path contract: :meth:`begin` on an UNSAMPLED dispatch is one
    dict increment + one modulo and returns ``None``; :meth:`end` with
    ``t0 is None`` returns immediately.  No sync, no allocation, no
    metric-registry lock ever touches the unsampled path.  With
    ``sample_n == 0`` even the dispatch counting is skipped — the
    observatory is then bit-for-bit absent from the engine's behavior.
    """

    def __init__(self, sample_n: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.sample_n = (profile_sample_n() if sample_n is None
                         else max(0, int(sample_n)))
        self._clock = clock
        self._lock = threading.Lock()
        self._stats: Dict[str, _SigStats] = {}
        self._counts: Dict[str, int] = {}

    # hot path ---------------------------------------------------------
    def begin(self, sig: str) -> Optional[float]:
        """Start-of-dispatch: returns a t0 only when THIS dispatch is
        sampled (every ``sample_n``-th per signature), else None."""
        n = self.sample_n
        if n <= 0:
            return None
        c = self._counts.get(sig, 0) + 1
        self._counts[sig] = c
        if c % n:
            return None
        return self._clock()

    def end(self, sig: str, t0: Optional[float], out=None,
            hbm_bytes: int = 0) -> Optional[float]:
        """End-of-dispatch: no-op unless :meth:`begin` sampled it.
        Synchronizes the CUDA device ``out`` lives on (a tensor, a
        ``torch.device``, or a container of them) so the timer measures
        device completion, records the duration, and attributes
        achieved bytes/s when the call site passed an ``hbm_bytes``
        estimate.  CPU outputs need no wait."""
        if t0 is None:
            return None
        if out is not None:
            dev = _cuda_device(out)
            if dev is not None:
                import torch
                torch.cuda.synchronize(dev)
        dt = max(1e-9, self._clock() - t0)
        with self._lock:
            s = self._stats.setdefault(sig, _SigStats())
            s.samples += 1
            s.total_s += dt
            s.durations.append(dt)
            if hbm_bytes > 0:
                s.bytes_total += int(hbm_bytes)
                s.last_gbs = hbm_bytes / dt / 1e9
        self._observe_metric(sig, dt, hbm_bytes)
        return dt

    # slow path --------------------------------------------------------
    def _observe_metric(self, sig: str, dt: float,
                        hbm_bytes: int) -> None:
        try:
            from . import catalog
            catalog.PROFILE_DISPATCH_SECONDS.observe(dt, signature=sig)
            catalog.PROFILE_SAMPLES.inc(signature=sig)
            if hbm_bytes > 0:
                bps = hbm_bytes / dt
                catalog.PROFILE_ACHIEVED_BPS.set(round(bps, 1),
                                                 signature=sig)
                ceil = roofline_ceiling_gbs()
                if ceil:
                    catalog.PROFILE_ROOFLINE_FRAC.set(
                        round(bps / (ceil * 1e9), 4), signature=sig)
        except Exception:
            pass

    def snapshot(self) -> dict:
        """Deterministic per-signature summary (sorted keys, rounded
        floats) — what ``/debugz``, bench extras and the probe tools
        all export."""
        ceil = roofline_ceiling_gbs()
        out: Dict[str, dict] = {}
        with self._lock:
            for sig in sorted(self._stats):
                s = self._stats[sig]
                durs = sorted(s.durations)
                entry = {
                    "dispatches": self._counts.get(sig, 0),
                    "samples": s.samples,
                    "p50_ms": round(_percentile(durs, 0.50) * 1e3, 4),
                    "p95_ms": round(_percentile(durs, 0.95) * 1e3, 4),
                    "mean_ms": round(s.total_s / s.samples * 1e3, 4)
                    if s.samples else 0.0,
                }
                if s.bytes_total:
                    entry["achieved_gbs"] = round(
                        s.bytes_total / s.total_s / 1e9, 3)
                    if ceil:
                        entry["roofline_frac"] = round(
                            entry["achieved_gbs"] / ceil, 4)
                out[sig] = entry
        return out

    def dispatch_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counts.items()))

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._counts.clear()


# -- 2. compile observability -----------------------------------------------

class CompileTracker:
    """Per-program compile ledger.  ``variant_budget`` documents how
    many compiled variants a program is ALLOWED (``paged_multi_step``
    and ``mixed_step``: two); the anomaly layer turns budget overruns
    into ``recompile_storm``.  Registering the same program name again
    (a second engine in-process) accumulates into the same entry.  A
    compile here is a CUDA graph capture, booked by
    ``runtime/cuda_graph.StepGraphs.capture`` through
    :meth:`note_compile`; ``cache_entries`` is the graphs the capturing
    engine holds for the program."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: Dict[str, dict] = {}

    def register(self, program: str,
                 variant_budget: Optional[int] = None) -> None:
        """Name a program the ledger reports (with zero compiles until
        its first capture) and document its variant budget."""
        with self._lock:
            e = self._programs.setdefault(program, {
                "compiles": 0, "compile_seconds": 0.0,
                "variant_budget": None, "cache_entries": 0})
            if variant_budget is not None:
                e["variant_budget"] = int(variant_budget)

    def note_compile(self, program: str, n: int = 1,
                     seconds: float = 0.0,
                     cache_entries: Optional[int] = None) -> None:
        with self._lock:
            e = self._programs.setdefault(program, {
                "compiles": 0, "compile_seconds": 0.0,
                "variant_budget": None, "cache_entries": 0})
            e["compiles"] += max(1, int(n))
            e["compile_seconds"] += max(0.0, float(seconds))
            if cache_entries is not None:
                e["cache_entries"] = int(cache_entries)

    def snapshot(self) -> dict:
        """Deterministic ``{program: {compiles, compile_seconds,
        variant_budget, cache_entries}}`` — the ``stats()["compile"]``
        fragment the anomaly detector reads."""
        with self._lock:
            return {p: {"compiles": e["compiles"],
                        "compile_seconds": round(e["compile_seconds"], 4),
                        "variant_budget": e["variant_budget"],
                        "cache_entries": e["cache_entries"]}
                    for p, e in sorted(self._programs.items())}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()


# -- 3. HBM watermark ledger ------------------------------------------------

class HbmWatermarks:
    """High-water-mark bytes per pool owner.  ``sample`` is called at
    scheduler iterations with the owner's CURRENT resident bytes; the
    watermark only ever grows until :meth:`reset` (monotone — pinned by
    tests), so a pool's worst case survives the quiet period after the
    burst that caused it.

    Owners: ``kv_page_pool``, ``kv_host_pool``, ``draft_scratch``,
    ``stage_pool``, ``migration_staged``, and (despite the ledger's
    name) ``host_tier`` — the §21 demoted-prefix ring's host-RAM bytes
    ride the same postmortem surface and the same reset-on-close."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._current: Dict[str, int] = {}
        self._hwm: Dict[str, int] = {}

    def sample(self, owner: str, nbytes: int) -> None:
        cur = max(0, int(nbytes))
        with self._lock:
            self._current[owner] = cur
            if cur > self._hwm.get(owner, 0):
                self._hwm[owner] = cur

    def watermarks(self) -> dict:
        with self._lock:
            return {o: {"bytes": self._current.get(o, 0),
                        "watermark_bytes": self._hwm[o]}
                    for o in sorted(self._hwm)}

    def reset(self, owner: Optional[str] = None) -> None:
        """Drop one owner's ledger (engine close resets the owners it
        fed) or, with no argument, everything."""
        with self._lock:
            if owner is None:
                self._current.clear()
                self._hwm.clear()
            else:
                self._current.pop(owner, None)
                self._hwm.pop(owner, None)


# -- 4. workload sketch recorder --------------------------------------------

PROMPT_TOKEN_EDGES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
DECODE_TOKEN_EDGES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
INTERARRIVAL_EDGES_S = (0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 15.0)


class _Hist:
    """Fixed-edge streaming histogram: deterministic, mergeable.
    ``counts[i]`` = values ≤ ``edges[i]``; the last bin is overflow."""

    __slots__ = ("edges", "counts", "total", "count", "max")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = tuple(edges)
        self.counts = [0] * (len(edges) + 1)
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, v: float) -> None:
        v = max(0.0, float(v))
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.total += v
        self.count += 1
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-quantile (the
        planner's conservative read; overflow reports the max seen)."""
        if not self.count:
            return 0.0
        target = p * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return (float(self.edges[i]) if i < len(self.edges)
                        else self.max)
        return self.max

    def to_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": round(self.total, 6), "count": self.count,
                "max": round(self.max, 6)}

    def merge_dict(self, d: dict) -> None:
        if tuple(d.get("edges", ())) != self.edges:
            raise ValueError("sketch histogram edges disagree")
        for i, c in enumerate(d.get("counts", ())):
            self.counts[i] += int(c)
        self.total += float(d.get("sum", 0.0))
        self.count += int(d.get("count", 0))
        self.max = max(self.max, float(d.get("max", 0.0)))


class WorkloadSketchRecorder:
    """Streaming workload sketch.  Every record method takes explicit
    values (and an explicit ``now`` for interarrival) — no internal
    clock, no RNG — so an identical request trace folds to a
    byte-identical artifact (pinned by tests)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self.requests = 0
        self.tenants: Dict[str, int] = {}
        self.prompt_tokens = _Hist(PROMPT_TOKEN_EDGES)
        self.decode_tokens = _Hist(DECODE_TOKEN_EDGES)
        self.interarrival_s = _Hist(INTERARRIVAL_EDGES_S)
        self.prefix_matched = 0
        self.prefix_prompt = 0
        self._last_arrival: Optional[float] = None
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record_request(self, prompt_tokens: int,
                       tenant: str = "default",
                       now: Optional[float] = None) -> None:
        with self._lock:
            self.requests += 1
            self.tenants[tenant] = self.tenants.get(tenant, 0) + 1
            self.prompt_tokens.add(prompt_tokens)
            if now is not None:
                if self._last_arrival is not None:
                    self.interarrival_s.add(now - self._last_arrival)
                self._last_arrival = now
                self._t_first = (now if self._t_first is None
                                 else self._t_first)
                self._t_last = now

    def record_prefix(self, matched_tokens: int,
                      prompt_tokens: int) -> None:
        with self._lock:
            self.prefix_matched += max(0, int(matched_tokens))
            self.prefix_prompt += max(0, int(prompt_tokens))

    def record_decode(self, decode_tokens: int) -> None:
        with self._lock:
            self.decode_tokens.add(decode_tokens)

    def snapshot(self) -> dict:
        """The sketch artifact, schema ``SKETCH_SCHEMA_VERSION`` — the
        planner's workload input."""
        with self._lock:
            share = (round(self.prefix_matched / self.prefix_prompt, 6)
                     if self.prefix_prompt else 0.0)
            window = (round(self._t_last - self._t_first, 6)
                      if self._t_first is not None else 0.0)
            return {
                "schema_version": SKETCH_SCHEMA_VERSION,
                "window_s": window,
                "requests": self.requests,
                "tenants": dict(sorted(self.tenants.items())),
                "prompt_tokens": self.prompt_tokens.to_dict(),
                "decode_tokens": self.decode_tokens.to_dict(),
                "interarrival_s": self.interarrival_s.to_dict(),
                "prefix_hit": {"matched_tokens": self.prefix_matched,
                               "prompt_tokens": self.prefix_prompt,
                               "share": share},
            }

    def to_json(self) -> str:
        """Canonical bytes: sorted keys, minimal separators, rounded
        floats — the determinism contract ``GET /sketch`` serves."""
        return render_sketch(self.snapshot())

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()


def render_sketch(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def merge_sketches(sections: List[Tuple[str, dict]]) -> dict:
    """Merge per-replica sketch artifacts into one fleet sketch —
    deterministic (sections sorted by replica id; histograms summed
    bin-wise; the fleet interarrival histogram is the per-replica SUM,
    an approximation the artifact labels honestly).  Skips sections
    whose schema version disagrees (counted in ``dropped``)."""
    acc = WorkloadSketchRecorder()
    replicas: List[str] = []
    dropped: List[str] = []
    for rid, obj in sorted(sections, key=lambda kv: kv[0]):
        if not isinstance(obj, dict) or \
                obj.get("schema_version") != SKETCH_SCHEMA_VERSION:
            dropped.append(rid)
            continue
        replicas.append(rid)
        acc.requests += int(obj.get("requests", 0))
        for t, n in (obj.get("tenants") or {}).items():
            acc.tenants[t] = acc.tenants.get(t, 0) + int(n)
        for name in ("prompt_tokens", "decode_tokens", "interarrival_s"):
            frag = obj.get(name)
            if isinstance(frag, dict):
                getattr(acc, name).merge_dict(frag)
        ph = obj.get("prefix_hit") or {}
        acc.prefix_matched += int(ph.get("matched_tokens", 0))
        acc.prefix_prompt += int(ph.get("prompt_tokens", 0))
    out = acc.snapshot()
    out["window_s"] = max((float(o.get("window_s", 0.0))
                           for _, o in sections
                           if isinstance(o, dict)), default=0.0)
    out["replicas"] = replicas
    if dropped:
        out["dropped_replicas"] = sorted(dropped)
    return out


# -- the process-wide observatory -------------------------------------------

_LOCK = threading.Lock()
_PROFILER: Optional[DispatchProfiler] = None
_COMPILES: Optional[CompileTracker] = None
_HBM: Optional[HbmWatermarks] = None
_SKETCH: Optional[WorkloadSketchRecorder] = None


def get_profiler() -> DispatchProfiler:
    global _PROFILER
    if _PROFILER is None:
        with _LOCK:
            if _PROFILER is None:
                _PROFILER = DispatchProfiler()
    return _PROFILER


def get_compile_tracker() -> CompileTracker:
    global _COMPILES
    if _COMPILES is None:
        with _LOCK:
            if _COMPILES is None:
                _COMPILES = CompileTracker()
    return _COMPILES


def get_hbm_watermarks() -> HbmWatermarks:
    global _HBM
    if _HBM is None:
        with _LOCK:
            if _HBM is None:
                _HBM = HbmWatermarks()
    return _HBM


def get_sketch() -> WorkloadSketchRecorder:
    global _SKETCH
    if _SKETCH is None:
        with _LOCK:
            if _SKETCH is None:
                _SKETCH = WorkloadSketchRecorder()
    return _SKETCH


def reset_observatory() -> None:
    """Rebuild every singleton from the current env (tests; also the
    hook a long-lived process can use to re-arm after a config flip)."""
    global _PROFILER, _COMPILES, _HBM, _SKETCH
    with _LOCK:
        _PROFILER = DispatchProfiler()
        _COMPILES = CompileTracker()
        _HBM = HbmWatermarks()
        _SKETCH = WorkloadSketchRecorder()
    _ROOFLINE_CACHE.clear()


def observatory_state() -> dict:
    """The ``/debugz`` section: every ledger's deterministic snapshot."""
    return {
        "sample_n": get_profiler().sample_n,
        "profile": get_profiler().snapshot(),
        "compile": get_compile_tracker().snapshot(),
        "hbm": get_hbm_watermarks().watermarks(),
        "sketch_requests": get_sketch().requests,
    }
