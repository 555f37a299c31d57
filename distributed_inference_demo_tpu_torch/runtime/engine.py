"""Single-stage inference engine: prefill + decode loop.

Counterpart of ``distributed_inference_demo_tpu/runtime/engine.py``'s
``InferenceEngine``, with the same observable contract:

- whole-prompt prefill, or chunked prefill with the left-shifted aligned
  last window and the length rewind (:func:`run_chunked_prefill`);
- the decode loop: up to ``limit`` sample+forward steps, eos padding,
  stop-id matching, early exit once every row is done, ``steps_computed``,
  raw log-softmax logprobs, one generator draw per sampled step;
- ``generate`` / ``generate_stream`` (``stream_block`` 1 or K) /
  ``classify``, and the ``loop_stats`` dispatch accounting;
- the block KV prefix cache (``kv_cache_blocks``, ``kv_block_tokens``,
  ``kv_dtype``; ``runtime/kvcache/backend.py``) around the batch-1
  prefill of ``generate`` and ``generate_stream``, and the float8
  ``kv_cache_dtype`` storage cast.

The reference's decode loop is one jitted program.  Here the host runs
the loop, and each decode step is the counterpart of the compiled
program: on the card a CUDA graph captured once per batch size and
replayed (``runtime/cuda_graph.py``), on the CPU
the same step run eagerly.  The step reads and writes a static decode
state (:class:`DecodeState`): the KV cache, whose length is a device
scalar, the logits, the token, done and logprob rows.  Prefill runs
eagerly into that state.  "One dispatch" of ``loop_stats`` is one call
of the decode loop, as in the reference.
"""

import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..models.decoder import stage_forward
from ..ops.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from ..ops.flash_attention import make_flash_attn_impl
from ..ops.quant import resolve_kv_cache_dtype
from ..ops.sampling import (SamplingParams, match_stop_ids, pad_stop_ids,
                            sample_logits)
from .cuda_graph import StepGraph, StepGraphs
from .kvcache import make_kv_backend, resolve_kv_layout

ATTN_BACKENDS = ("auto", "flash", "plain")


def resolve_stream_block(stream_block) -> int:
    """The streaming decode-block size K: ``None`` defers to the
    ``DWT_STREAM_BLOCK`` env knob, default 1 (the per-token path)."""
    if stream_block is None:
        stream_block = os.environ.get("DWT_STREAM_BLOCK", "").strip() or 1
    stream_block = int(stream_block)
    if stream_block < 1:
        raise ValueError(f"stream_block must be >= 1, got {stream_block}")
    return stream_block


def check_capacity(max_seq: int, prompt_len: int, max_new_tokens: int):
    """Host-side KV capacity bound: prompt + new tokens <= max_seq."""
    need = prompt_len + max_new_tokens
    if need > max_seq:
        raise ValueError(
            f"prompt ({prompt_len}) + new tokens ({max_new_tokens}) = "
            f"{need} exceeds KV-cache capacity {max_seq}")


@dataclass
class GenerationResult:
    tokens: np.ndarray          # [batch, max_new_tokens] int32
    prompt_len: int
    num_new: int
    seconds: float = 0.0
    # raw log-softmax log-probabilities of the emitted tokens, or None
    logprobs: Optional[np.ndarray] = None
    # decode steps actually run: an eos/stop early exit can make this
    # < num_new, and token columns past it are padding
    steps_computed: Optional[int] = None

    @property
    def tokens_per_second(self) -> float:
        steps = (self.steps_computed if self.steps_computed is not None
                 else self.num_new)
        total = self.tokens.shape[0] * steps
        return total / self.seconds if self.seconds > 0 else float("nan")


def resolve_attn_backend(attn_backend: str, device_type: str,
                         head_dim: int) -> str:
    """The attention backend an engine runs: "auto" is the CUDA flash
    kernel on CUDA and plain attention on the CPU.  The kernel hook never
    gives way to plain attention on the card: a head dim the kernel does
    not take raises, and plain attention there is an explicit choice."""
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attn_backend {attn_backend!r}; "
                         f"expected one of {ATTN_BACKENDS}")
    if attn_backend == "auto":
        attn_backend = "flash" if device_type == "cuda" else "plain"
    if attn_backend == "flash":
        if device_type != "cuda":
            raise ValueError(
                "attn_backend='flash' launches the CUDA kernel; on the "
                "CPU use 'auto' or 'plain'")
        if head_dim not in FLASH_HEAD_DIMS:
            raise ValueError(
                f"the CUDA flash kernel takes head_dim in {FLASH_HEAD_DIMS}, "
                f"not {head_dim}; ask for plain attention on the card with "
                "attn_backend='plain' (--attn-backend plain)")
    return attn_backend


def resolve_cache_dtype_backend(kv_cache_dtype, attn_backend: str):
    """The reduced-precision-cache rule, as the reference's: a float8
    cache takes plain attention (the flash kernel reads no float8
    cache), so "auto" resolves to "plain" and an explicit "flash"
    raises.  Returns ``(torch.dtype | None, attn_backend)``; decided at
    construction and shown in the engine's ``attn_backend``."""
    dt = resolve_kv_cache_dtype(kv_cache_dtype)
    if dt is not None:
        if attn_backend not in ("auto", "plain"):
            raise ValueError(
                f"attn_backend={attn_backend!r} is incompatible with "
                "kv_cache_dtype (the flash kernel reads no reduced-"
                "precision cache); use 'auto' or 'plain'")
        attn_backend = "plain"
    return dt, attn_backend


def validate_prefill_chunk(prefill_chunk, max_seq: int):
    if prefill_chunk is not None and not (1 <= prefill_chunk <= max_seq):
        raise ValueError(
            f"prefill_chunk must be in [1, max_seq={max_seq}]")
    return prefill_chunk


def make_paged_chunk_programs(fwd_p, bind_tables):
    """``(chunk_mid, slab_body)``: the prefill programs over a PAGED
    forward seam (``parallel.tensor.make_paged_forward_seam``), as the
    reference's factory makes them.  Chunks write their K/V straight into
    the page pool through the block tables, in place, before attending
    (the paged attention hook writes first), so causal masking keeps a
    segment's queries on its own prior pages plus its in-chunk keys.

    ``chunk_mid`` is the serialized admission's non-final chunk (logits
    dropped); ``slab_body`` is the mixed dispatch's ``[n_seg, C]`` slab
    of segments at per-row starts (logits at every position)."""

    def chunk_mid(params, pk, pv, ids, tables, start: int) -> None:
        """One chunk ``ids`` [b, s] at global offset ``start``, written
        through ``tables`` [b, W] (device int32) into the pools
        ``pk``/``pv``."""
        bind_tables(tables)
        b, s = ids.shape
        pos = (start + torch.arange(s, device=ids.device)).expand(b, s)
        fwd_p(params, ids, KVCache(pk, pv, 0), pos, True)

    def slab_body(params, cache: KVCache, ids, tables, starts):
        """Row r of ``ids`` [n, s] at positions ``starts[r] + arange(s)``
        (``starts`` [n], device) through ``tables[r]``; returns the logits
        at every position [n, s, V] and the cache (written in place)."""
        bind_tables(tables)
        s = ids.shape[1]
        pos = starts.long()[:, None] + torch.arange(s, device=ids.device)
        return fwd_p(params, ids, cache, pos, False)

    return chunk_mid, slab_body


def run_chunked_prefill(ids: torch.Tensor, cache: KVCache, C: int,
                        max_seq: int, chunk_mid, chunk_last=None,
                        start: int = 0):
    """The chunked-prefill loop (the reference's semantics).

    The prompt is zero-padded to a chunk multiple and runs chunk by
    chunk.  The final chunk is left-shifted when the padded length would
    spill past ``max_seq`` (the aligned last window): the overlapped real
    tokens are recomputed and rewritten at their own positions, so no pad
    slot is written past ``max_seq``.  The cache length is rewound to the
    true prompt length afterwards, so decode's first insert overwrites the
    first pad slot.  ``chunk_last=None`` runs the final chunk through
    ``chunk_mid`` and returns ``(None, cache)``.  ``start`` > 0: ``ids``
    are the tokens from position ``start`` on and the cache already holds
    columns ``[0, start)``."""
    b, plen = ids.shape
    cap = max_seq - start          # columns available at/after start
    cache = KVCache(cache.keys, cache.values, start)
    if cap < C:
        # no room for a whole padded chunk: one unpadded dispatch
        if chunk_last is None:
            cache = chunk_mid(ids, cache, start)
            last = None
        else:
            last, cache = chunk_last(ids, cache, start, plen - 1)
        return last, KVCache(cache.keys, cache.values, start + plen)
    n_chunks = -(-plen // C)
    padded = torch.zeros((b, n_chunks * C), dtype=ids.dtype,
                         device=ids.device)
    padded[:, :plen] = ids
    for i in range(n_chunks - 1):
        cache = chunk_mid(padded[:, i * C:(i + 1) * C], cache,
                          start + i * C)
    tail_start = min((n_chunks - 1) * C, cap - C)
    # the left shift applies to the cache write offset too, so that a
    # column's index is its position
    cache = KVCache(cache.keys, cache.values, start + tail_start)
    tail = padded[:, tail_start:tail_start + C]
    if chunk_last is None:
        cache = chunk_mid(tail, cache, start + tail_start)
        last = None
    else:
        last, cache = chunk_last(tail, cache, start + tail_start,
                                 plen - 1 - tail_start)
    return last, KVCache(cache.keys, cache.values, start + plen)


class DecodeState:
    """The static decode state of one batch size: what a decode step
    reads and writes in place, at addresses that stay fixed for the
    engine's life, so that a captured CUDA graph can replay the step.
    ``cache.length`` is a 0-d int64 device tensor; ``logits`` [b, V] are
    the next step's input; ``tok``, ``done`` and ``lp`` [b] the last
    step's emitted token, finished rows and raw logprob; ``eos`` the
    call's eos id (-1 = none).  ``step`` runs one decode step on it (a
    replayed graph on the card)."""

    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int, device,
                 cache_dtype=None):
        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.cache = KVCache.create(cfg, cfg.num_layers, batch, max_seq,
                                    dtype=cache_dtype, device=device)
        self.cache.length = zeros()
        self.logits = zeros(batch, cfg.vocab_size, dtype=cfg.dtype)
        self.tok = zeros(batch)
        self.done = zeros(batch, dtype=torch.bool)
        self.lp = zeros(batch, dtype=torch.float32)
        self.eos = zeros()
        self.step: Optional[StepGraph] = None

    def begin(self, logits: torch.Tensor, length: int, eos: int) -> None:
        """Start a decode from a prefill: its last logits, the prompt
        length, no row done."""
        self.logits.copy_(logits)
        self.cache.length.fill_(length)
        self.done.zero_()
        self.eos.fill_(eos)


class InferenceEngine:
    """KV-cached generation over a full model on one device."""

    def __init__(self, cfg: ModelConfig, params: StageParams,
                 max_seq: Optional[int] = None,
                 sampling: SamplingParams = SamplingParams(),
                 eos_id: Optional[int] = None,
                 attn_backend: str = "auto",
                 kv_cache_dtype: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_cache_blocks: Optional[int] = None,
                 kv_block_tokens: Optional[int] = None,
                 kv_layout: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 stop_token_ids=None,
                 stream_block: Optional[int] = None,
                 device=None, cuda_graph: bool = True):
        """``attn_backend``: "auto" (the CUDA flash kernel hook on CUDA,
        plain attention on the CPU), "flash" (the kernel hook; CUDA
        only), or "plain" (``ops.attention`` only); see
        :func:`resolve_attn_backend`.  ``self.attn_backend`` holds the
        resolved choice.

        ``device``: where the engine runs, CUDA unless "cpu" is asked
        for; ``params`` must already live there.

        ``cuda_graph`` (port-only): on the card each decode step replays
        a captured CUDA graph; False runs the same fixed-shape step
        eagerly (the comparison for the graph).  A capture that fails
        raises.  On the CPU the step always runs eagerly.

        ``kv_cache_blocks`` / ``kv_block_tokens`` (None: the
        ``DWT_KVCACHE_*`` knobs; default off): the block KV prefix cache,
        a device page pool behind ``runtime/kvcache/backend.py``.  A
        batch-1 ``generate`` / ``generate_stream`` prompt that shares
        whole leading blocks with an earlier one seeds its cache from
        them, in place, and prefills only the suffix; every such prefill
        stores its full blocks.  ``kv_dtype`` ("bf16", "int8", "int4";
        None: ``DWT_KV_DTYPE``) is the pool's page width: the working
        cache stays full width, stores quantize and seeds dequantize.
        ``kv_cache_dtype`` "float8_e4m3fn" stores the working cache (and
        the pool's pages) as float8, cast as the reference rounds, read
        in f32; it takes plain attention
        (:func:`resolve_cache_dtype_backend`) and does not compose with
        ``kv_dtype`` int8/int4.  The tier knobs
        (``DWT_KV_HOST_TIER_BYTES``) raise.  ``kv_layout`` takes the
        reference's only value, "paged".  Other arguments as in the
        reference."""
        self.kv_layout = resolve_kv_layout(kv_layout)
        self.device = resolve_device(device)
        p_dev = params.embed["tokens"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq or cfg.max_seq_len
        self.sampling = sampling
        self.eos_id = eos_id
        self.spec = StageSpec(0, 1, 0, cfg.num_layers)
        self.prefill_chunk = validate_prefill_chunk(prefill_chunk,
                                                    self.max_seq)
        self.stream_block = resolve_stream_block(stream_block)
        self._stop_ids = pad_stop_ids(stop_token_ids, device=self.device)
        self._has_stop_ids = bool(stop_token_ids)
        self.loop_stats = {"host_dispatches": 0, "device_loop_steps": 0}
        self.cuda_graph = bool(cuda_graph)
        # one generator, seeded per call; one static decode state per
        # batch size; the lock keeps concurrent calls off the shared state
        self._gen = torch.Generator(device=self.device)
        self._graphs = StepGraphs(self.device, self._gen, self.cuda_graph)
        self._states = {}
        self._lock = threading.Lock()

        self.kv_cache_dtype, attn_backend = resolve_cache_dtype_backend(
            kv_cache_dtype, attn_backend)
        self.attn_backend = resolve_attn_backend(
            attn_backend, self.device.type, cfg.head_dim)
        self._attn_impl = (make_flash_attn_impl()
                           if self.attn_backend == "flash" else None)
        self.kv_cache = make_kv_backend(
            cfg, kv_cache_blocks, kv_block_tokens, layout=self.kv_layout,
            dtype=self.kv_cache_dtype, kv_dtype=kv_dtype, default_blocks=0,
            device=self.device)

    # -- forward programs ----------------------------------------------

    def _fwd(self, ids, cache, pos, last_logits_only):
        return stage_forward(self.params, self.cfg, self.spec, ids, cache,
                             pos, attn_impl=self._attn_impl,
                             last_logits_only=last_logits_only)

    def _positions(self, b: int, s: int, start: int) -> torch.Tensor:
        return (start + torch.arange(s, device=self.device)).expand(b, s)

    def _prefill(self, ids, cache):
        """Whole prompt in one forward; LM head on the last position."""
        b, s = ids.shape
        logits, cache = self._fwd(ids, cache, self._positions(b, s, 0), True)
        return logits[:, -1], cache

    def _chunk_mid(self, ids, cache, start):
        """One non-final prompt chunk: extend the cache, drop logits."""
        b, s = ids.shape
        _, cache = self._fwd(ids, cache, self._positions(b, s, start), True)
        return cache

    def _chunk_last(self, ids, cache, start, gather_idx):
        """Final (possibly pad-tailed) chunk: logits at the prompt's true
        last position."""
        b, s = ids.shape
        logits, cache = self._fwd(ids, cache, self._positions(b, s, start),
                                  False)
        return logits[:, gather_idx], cache

    def _run_prefill(self, ids, cache, start: int = 0):
        """Whole-prompt or chunked prefill -> (last_logits [b, V], cache).
        ``start`` > 0 is the seeded suffix: ``ids`` is still the whole
        prompt, the cache's columns ``[0, start)`` already hold its
        prefix's K/V, and only ``ids[:, start:]`` runs, chunked, or in
        one final-chunk forward (the reference's ``run_seeded_prefill``)."""
        if start:
            suffix = ids[:, start:]
            if self.prefill_chunk is not None:
                return run_chunked_prefill(suffix, cache, self.prefill_chunk,
                                           self.max_seq, self._chunk_mid,
                                           self._chunk_last, start=start)
            last, cache = self._chunk_last(
                suffix, KVCache(cache.keys, cache.values, start), start,
                suffix.shape[1] - 1)
            return last, KVCache(cache.keys, cache.values, ids.shape[1])
        if self.prefill_chunk is None:
            return self._prefill(ids, cache)
        return run_chunked_prefill(ids, cache, self.prefill_chunk,
                                   self.max_seq, self._chunk_mid,
                                   self._chunk_last)

    # -- block KV cache (runtime/kvcache) seams ------------------------

    def _kv_seed(self, ids, cache: KVCache):
        """(start, cache): seed the cache from the longest cached block
        prefix of a batch-1 prompt, in place, or (0, cache) on a miss
        (or with the pool off)."""
        if self.kv_cache is None:
            return 0, cache
        return self.kv_cache.seed(ids, cache)

    def _kv_store(self, ids, cache: KVCache) -> None:
        """Store the prefilled batch-1 prompt's full blocks; it reads the
        cache after the prefill, before the first decode step (the same
        stream orders the two)."""
        if self.kv_cache is not None:
            self.kv_cache.store(ids, cache)

    def _seeded_prefill(self, prompt: np.ndarray, ids, st: "DecodeState"):
        """Seed, prefill the rest and store, into ``st``'s cache:
        ``prompt`` is the host copy of ``ids``, which the radix tree
        reads without a device sync.  Returns (start, last logits)."""
        start, cache = self._kv_seed(
            prompt, KVCache(st.cache.keys, st.cache.values, 0))
        logits, cache = self._run_prefill(ids, cache, start)
        self._kv_store(prompt, cache)
        return start, logits

    # -- decode --------------------------------------------------------

    def _eos(self) -> int:
        """eos_id read at call time (-1 = disabled)."""
        return self.eos_id if self.eos_id is not None else -1

    def _decode_step(self, st: DecodeState) -> None:
        """One decode step on the static state ``st``, in place, shared by
        the loop and the per-token stream (so the two are bit-identical
        by construction): sample, eos-pad finished rows, match stop ids,
        score the emitted token, forward it at the device length.  No
        shape and no host value depends on the length or the call."""
        b = st.tok.shape[0]
        tok = sample_logits(st.logits, self._gen, self.sampling)
        tok = torch.where(st.done & (st.eos >= 0), st.eos, tok)
        done = (st.done | (tok == st.eos)
                | match_stop_ids(tok, self._stop_ids))
        lp = torch.gather(torch.log_softmax(st.logits.float(), dim=-1), -1,
                          tok[:, None])[:, 0]
        out, _ = self._fwd(tok[:, None], st.cache,
                           st.cache.length.expand(b, 1), False)
        st.tok.copy_(tok)
        st.done.copy_(done)
        st.lp.copy_(lp)
        st.logits.copy_(out[:, 0])
        st.cache.length.add_(1)

    def _state(self, batch: int) -> DecodeState:
        """The static decode state of ``batch`` rows, made at first use
        with its step captured (the sampling setting is fixed at
        construction); the warm-up step writes the fresh state at length
        0, before any prefill fills it."""
        st = self._states.get(batch)
        if st is None:
            st = DecodeState(self.cfg, batch, self.max_seq, self.device,
                             self.kv_cache_dtype)
            st.step = self._graphs.capture(lambda: self._decode_step(st))
            self._states[batch] = st
        return st

    @property
    def graph_replays(self) -> int:
        """Decode steps replayed from a captured graph, over all states."""
        return self._graphs.replays

    def _start(self, prompt: np.ndarray, ids, seed: int):
        """The call's state, its generator seeded, the prompt prefilled
        into the state through the prefix cache.  Returns (state, eos)."""
        st = self._state(ids.shape[0])
        self._gen.manual_seed(int(seed))
        eos = self._eos()
        _, logits = self._seeded_prefill(prompt, ids, st)
        st.begin(logits, ids.shape[1], eos)
        return st, eos

    def _decode_loop(self, st: DecodeState, eos: int, limit: int,
                     num_steps: int, with_logprobs: bool = False):
        """Up to ``limit`` steps, stopping early once every row is done.
        Returns (toks [b, num_steps], lps [b, num_steps], steps_ran);
        columns >= steps_ran are eos padding (token 0 without an eos)."""
        b = st.tok.shape[0]
        toks = torch.full((b, num_steps), eos if eos >= 0 else 0,
                          dtype=torch.int64, device=self.device)
        lps = torch.zeros((b, num_steps), dtype=torch.float32,
                          device=self.device)
        # rows can only finish through eos or a stop id; without either,
        # skip the per-step host sync that reads `done`
        can_finish = eos >= 0 or self._has_stop_ids
        j = 0
        while j < limit and not (can_finish and bool(st.done.all())):
            st.step()
            toks[:, j] = st.tok
            if with_logprobs:
                lps[:, j] = st.lp
            j += 1
        return toks, lps, j

    def _count_loop(self, steps: int) -> None:
        """One decode-loop call ran ``steps`` steps."""
        self.loop_stats["host_dispatches"] += 1
        self.loop_stats["device_loop_steps"] += steps

    def _ids(self, prompt_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64)
        if ids.ndim != 2:
            raise ValueError("prompt_ids must be [batch, prompt_len]")
        return ids.to(self.device)

    def new_cache(self, batch: int) -> KVCache:
        return KVCache.create(self.cfg, self.cfg.num_layers, batch,
                              self.max_seq, dtype=self.kv_cache_dtype,
                              device=self.device)

    # -- public surface ------------------------------------------------

    def prefill_logits(self, prompt_ids) -> np.ndarray:
        """Last-position logits [batch, vocab] (f32) after prefill."""
        ids = self._ids(prompt_ids)
        check_capacity(self.max_seq, ids.shape[1], 0)
        with self._lock:
            st = self._state(ids.shape[0])
            logits, _ = self._run_prefill(
                ids, KVCache(st.cache.keys, st.cache.values, 0))
            return logits.float().cpu().numpy()

    def generate(self, prompt_ids, max_new_tokens: int, seed: int = 0,
                 logprobs: bool = False) -> GenerationResult:
        """Batch generation through the decode loop.  ``seconds`` covers
        prefill and decode, ending when the tokens are on the host; a
        batch size's first call captures its decode step before."""
        ids = self._ids(prompt_ids)
        b, plen = ids.shape
        check_capacity(self.max_seq, plen, max_new_tokens)
        with self._lock:
            self._state(b)      # a new batch size captures here, untimed
            t0 = time.perf_counter()
            st, eos = self._start(np.asarray(prompt_ids), ids, seed)
            toks, lps, steps = self._decode_loop(
                st, eos, max_new_tokens, max_new_tokens, logprobs)
            toks = toks.cpu().numpy().astype(np.int32)
            lps_np = lps.cpu().numpy() if logprobs else None
            self._count_loop(steps)
        return GenerationResult(tokens=toks, prompt_len=plen,
                                num_new=max_new_tokens,
                                seconds=time.perf_counter() - t0,
                                logprobs=lps_np, steps_computed=steps)

    def classify(self, prompt_ids, label_token_ids) -> np.ndarray:
        """Argmax of the last-position logits restricted to
        ``label_token_ids`` (one verbalizer token per class) -> [batch]
        int32 label indices."""
        label_ids = np.asarray(label_token_ids, np.int64)
        if label_ids.ndim != 1 or label_ids.size < 2:
            raise ValueError("label_token_ids must be >= 2 token ids")
        if (label_ids < 0).any() or (label_ids >= self.cfg.vocab_size).any():
            raise ValueError(
                f"label_token_ids out of range [0, {self.cfg.vocab_size})")
        sub = self.prefill_logits(prompt_ids)[:, label_ids]
        return np.argmax(sub, axis=-1).astype(np.int32)

    def generate_stream(self, prompt_ids, max_new_tokens: int,
                        seed: int = 0,
                        logprobs: bool = False) -> Iterator[np.ndarray]:
        """Yield one [batch] token array per step; with ``logprobs=True``
        ([batch] tokens, [batch] logprobs) pairs.  With ``stream_block``
        K > 1 each decode-loop call produces up to K tokens, and the
        stream ends as soon as every row is done."""
        ids = self._ids(prompt_ids)
        check_capacity(self.max_seq, ids.shape[1], max_new_tokens)
        with self._lock:
            st, eos = self._start(np.asarray(prompt_ids), ids, seed)
            K = self.stream_block
            if K > 1:
                remaining = max_new_tokens
                while remaining > 0:
                    toks, lps, steps = self._decode_loop(
                        st, eos, min(K, remaining), K, logprobs)
                    self._count_loop(steps)
                    if steps == 0:  # all rows were already done on entry
                        return
                    tok_np = toks.cpu().numpy().astype(np.int32)
                    lp_np = lps.cpu().numpy() if logprobs else None
                    for j in range(steps):
                        yield ((tok_np[:, j], lp_np[:, j]) if logprobs
                               else tok_np[:, j])
                    remaining -= steps
                    if bool(st.done.all()):
                        return
                return
            can_finish = eos >= 0 or self._has_stop_ids
            for _ in range(max_new_tokens):
                st.step()
                self._count_loop(1)
                # copies: on the CPU .numpy() views the static buffers
                tok_np = st.tok.cpu().numpy().astype(np.int32)
                yield ((tok_np, st.lp.cpu().numpy().copy()) if logprobs
                       else tok_np)
                if can_finish and bool(st.done.all()):
                    return
