"""``serve --sp N``: long-context sequence-parallel serving backend.

Counterpart of ``distributed_inference_demo_tpu/runtime/sp_backend.py``:
the ring-attention and Ulysses programs (``parallel/sequence.py``,
``parallel/ulysses.py``) behind the HTTP surface every serve mode uses.

- Each distinct ``max_new_tokens`` gets its own generate fn, LRU-bounded
  as the reference bounds its compiled variants (here nothing compiles;
  the bound keeps ``/stats`` the reference's).
- Prompts must arrive padded to a multiple of sp: a bad length is an
  HTTP 400 (``validate_sp_prompt``'s ValueError), never a silent fix-up.
- One request runs at a time (a lock): the sp mesh owns every rank, and
  two requests' collectives must not interleave.
- The line behind that lock is bounded and visible: ``/stats`` reports
  ``queue_depth`` / ``busy``, and a request arriving past
  ``max_queue_depth`` waiting requests gets 429 + Retry-After
  (``SchedulerOverloaded``; ``DWT_SP_QUEUE_DEPTH`` / ``serve
  --sp-queue-depth``, default 8; 0 = unbounded).

Sampling draws from a ``torch.Generator`` seeded by the request's seed
on every rank (the reference splits a JAX key): greedy tokens equal the
reference's, sampled ones are equally distributed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..models.base import ModelConfig
from ..ops.sampling import SamplingParams
from ..parallel.sequence import (make_sp_generate_fn, make_sp_stream_fns,
                                 replicate_params, validate_sp_prompt)
from ..parallel.ulysses import (make_ulysses_generate_fn,
                                make_ulysses_stream_fns)
from .engine import GenerationResult
from .overload import SchedulerOverloaded

STRATEGIES = ("ring", "ulysses")


class SequenceParallelBackend:
    """Engine-like backend over a local sp mesh for InferenceHTTPServer."""

    def __init__(self, cfg: ModelConfig, params, mesh, *, max_seq: int,
                 strategy: str = "ring",
                 sampling: Optional[SamplingParams] = None,
                 kv_cache_dtype: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 kv_layout: Optional[str] = None):
        """``params``: the full tree (sent to every rank once, here) or
        ``parallel.sequence.replicate_params``' result.
        ``max_queue_depth``: how many requests may wait behind the one
        running; one more is rejected with 429 + Retry-After.  ``None``
        defers to ``DWT_SP_QUEUE_DEPTH`` (default 8); 0 = unbounded.
        ``kv_layout``: accepted for the paged contract and shown on
        ``/stats``; the sp cache is per-request scratch either way.  A
        misconfiguration (``max_seq % sp``, Ulysses head divisibility)
        raises here, before any server starts."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown sp strategy {strategy!r}; "
                             f"known: {STRATEGIES}")
        from .kvcache import resolve_kv_layout
        self.kv_layout = resolve_kv_layout(kv_layout)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.max_seq = max_seq
        self.strategy = strategy
        self.sampling = sampling
        self.kv_cache_dtype = kv_cache_dtype
        self.eos_id = eos_id
        self.sp = int(mesh.shape["sp"])
        self._fns: "OrderedDict" = OrderedDict()
        self._stream_pair = None
        self._lock = threading.Lock()
        # counters and the fn cache get their own lock: /stats answers
        # while a request holds the device lock
        self._stats_lock = threading.Lock()
        self._served = 0
        self._decode_seconds = 0.0
        self._tokens_out = 0
        if max_queue_depth is None:
            from ..telemetry._env import env_int
            max_queue_depth = env_int("DWT_SP_QUEUE_DEPTH", 8)
        self.max_queue_depth = max(0, int(max_queue_depth))
        self._active = 0
        self._build(1)
        self.params = (params if getattr(params, "handle", None) is not None
                       else replicate_params(params, cfg, mesh))

    def _build(self, num_new: int):
        make = (make_sp_generate_fn if self.strategy == "ring"
                else make_ulysses_generate_fn)
        return make(self.cfg, self.mesh, max_seq=self.max_seq,
                    num_new_tokens=num_new, sampling=self.sampling,
                    kv_cache_dtype=self.kv_cache_dtype)

    # each distinct max_new_tokens is its own fn; LRU-bounded
    MAX_COMPILED_VARIANTS = 8

    def _fn(self, num_new: int):
        # called with _lock held; the dict mutates under _stats_lock
        with self._stats_lock:
            fn = self._fns.get(num_new)
            if fn is not None:
                self._fns.move_to_end(num_new)
                return fn
        fn = self._build(num_new)
        with self._stats_lock:
            self._fns[num_new] = fn
            while len(self._fns) > self.MAX_COMPILED_VARIANTS:
                self._fns.popitem(last=False)
        return fn

    def _admit(self):
        """Bounded admission to the one-request-at-a-time queue: past
        ``max_queue_depth`` waiting requests, reject with 429 +
        Retry-After (from this backend's measured seconds a request).
        Callers pair this with ``_leave`` in a finally."""
        with self._stats_lock:
            if (self.max_queue_depth
                    and self._active >= 1 + self.max_queue_depth):
                per_req = (self._decode_seconds / self._served
                           if self._served else 30.0)
                retry = min(600.0, max(1.0, per_req * self._active))
                raise SchedulerOverloaded(
                    f"sp queue full: {self._active - 1} request(s) "
                    f"already waiting behind the running one (bound "
                    f"{self.max_queue_depth}); retry later",
                    retry_after_s=retry, http_code=429)
            self._active += 1

    def _leave(self):
        with self._stats_lock:
            self._active -= 1

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 seed: int = 0) -> GenerationResult:
        ids = np.asarray(prompt_ids, dtype=np.int32)
        num_new = int(max_new_tokens)
        # ValueError renders as HTTP 400 with the rule spelled out
        validate_sp_prompt(ids.shape[1], self.sp, self.max_seq, num_new)
        self._admit()
        try:
            return self._generate_admitted(ids, num_new, seed)
        finally:
            self._leave()

    def _generate_admitted(self, ids: np.ndarray, num_new: int,
                           seed: int) -> GenerationResult:
        if self.eos_id is not None:
            # eos early stop rides the step-split programs: rows past
            # their eos pad with eos, and decode stops once every row
            # finished; the stream records the stats
            box = [0.0]
            steps = list(self._stream(ids, num_new, seed, box))
            toks = np.full((ids.shape[0], num_new), self.eos_id, np.int32)
            toks[:, :len(steps)] = np.stack(steps, axis=1)
            return GenerationResult(tokens=toks, prompt_len=ids.shape[1],
                                    num_new=num_new, seconds=box[0])
        with self._lock:
            fn = self._fn(num_new)
            t0 = time.perf_counter()
            toks = fn(self.params, ids, seed).cpu().numpy().astype(np.int32)
            dt = time.perf_counter() - t0
        with self._stats_lock:
            self._served += 1
            self._decode_seconds += dt
            self._tokens_out += int(toks.size)
        return GenerationResult(tokens=toks, prompt_len=ids.shape[1],
                                num_new=num_new, seconds=dt)

    # tokens per streaming decode dispatch
    STREAM_BLOCK = 8

    def _stream_fns(self):
        """The step-split pair, built once; one pair serves every
        ``max_new_tokens``."""
        if self._stream_pair is None:
            make = (make_sp_stream_fns if self.strategy == "ring"
                    else make_ulysses_stream_fns)
            self._stream_pair = make(
                self.cfg, self.mesh, max_seq=self.max_seq,
                block=self.STREAM_BLOCK, sampling=self.sampling,
                kv_cache_dtype=self.kv_cache_dtype)
        return self._stream_pair

    def generate_stream(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        seed: int = 0):
        """Incremental sp streaming: the prefill yields token #1, then
        each ``STREAM_BLOCK``-token decode dispatch yields as it lands.
        The device lock is taken per dispatch and released before every
        yield.  Validation errors and the bounded-queue rejection surface
        on the first ``next()`` (a clean 400 / 429)."""
        yield from self._stream(np.asarray(prompt_ids, np.int32),
                                int(max_new_tokens), seed, [0.0],
                                admit=True)

    def _stream(self, ids: np.ndarray, num_new: int, seed: int,
                device_s_box: list, admit: bool = False):
        """generate_stream's body; ``device_s_box[0]`` accumulates the
        dispatch seconds (lock waits excluded)."""
        validate_sp_prompt(ids.shape[1], self.sp, self.max_seq, num_new)
        if admit:
            self._admit()
        emitted, device_s = 0, 0.0
        fns = state = None
        try:
            eos = self.eos_id
            done = np.zeros((ids.shape[0],), bool)

            def mask_row_eos(tok):
                """The engines' row-wise eos rule, between dispatches:
                finished rows pad with eos; returns (tok, all done)."""
                nonlocal done
                if eos is None:
                    return tok, False
                tok = np.where(done, eos, tok)
                done = done | (tok == eos)
                return tok, bool(done.all())

            with self._lock:
                fns = self._stream_fns()
                t0 = time.perf_counter()
                state, tok = fns.prefill_fn(self.params, ids, seed)
                tok = tok.cpu().numpy().astype(np.int32)
                device_s += time.perf_counter() - t0
                device_s_box[0] = device_s
            tok, stop = mask_row_eos(tok)
            yield tok                               # token #1
            emitted = 1
            while emitted < num_new and not stop:
                with self._lock:
                    t0 = time.perf_counter()
                    toks = fns.decode_fn(self.params, state)
                    toks = toks.cpu().numpy().astype(np.int32)
                    device_s += time.perf_counter() - t0
                    device_s_box[0] = device_s
                take = min(toks.shape[1], num_new - emitted)
                for j in range(take):
                    tok, stop = mask_row_eos(toks[:, j])
                    yield tok
                    emitted += 1
                    if stop:
                        break
        finally:
            device_s_box[0] = device_s
            if state is not None:
                with self._lock:
                    fns.drop(state)
            if admit:
                self._leave()
            if emitted:
                with self._stats_lock:
                    self._served += 1
                    self._decode_seconds += device_s
                    self._tokens_out += emitted * ids.shape[0]

    def stats(self) -> dict:
        # _stats_lock only: /stats answers while a request runs
        with self._stats_lock:
            return {
                "mode": "sequence_parallel",
                "strategy": self.strategy,
                "sp": self.sp,
                "max_seq": self.max_seq,
                "kv_layout": self.kv_layout,
                "requests_served": self._served,
                "tokens_out": self._tokens_out,
                "seconds_generating": round(self._decode_seconds, 3),
                "compiled_max_new_variants": sorted(self._fns),
                "queue_depth": max(0, self._active - 1),
                "busy": self._lock.locked(),
                "queue_bound": self.max_queue_depth,
            }

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._served = 0
            self._decode_seconds = 0.0
            self._tokens_out = 0
