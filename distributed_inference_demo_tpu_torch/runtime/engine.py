"""Single-stage inference engine: prefill + decode loop.

Counterpart of ``distributed_inference_demo_tpu/runtime/engine.py``'s
``InferenceEngine``, with the same observable contract:

- whole-prompt prefill, or chunked prefill with the left-shifted aligned
  last window and the length rewind (:func:`run_chunked_prefill`);
- the decode loop: up to ``limit`` sample+forward steps, eos padding,
  stop-id matching, early exit once every row is done, ``steps_computed``,
  raw log-softmax logprobs, one generator draw per sampled step;
- ``generate`` / ``generate_stream`` (``stream_block`` 1 or K) /
  ``classify``, and the ``loop_stats`` dispatch accounting.

PyTorch runs eagerly, so the reference's jitted programs become methods;
"one dispatch" of ``loop_stats`` is one call of the decode loop.  The
KV cache is written in place and its length is a Python int.
"""

import os
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
from ..ops.quant import require_float_weights
from ..ops.sampling import (SamplingParams, match_stop_ids, pad_stop_ids,
                            sample_logits)

KVCACHE_LATER = ("this engine's block KV prefix cache, reduced-precision "
                 "caches and quantized pages are ported in a later slice "
                 "(ROADMAP A5, A2)")
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
                 device=None):
        """``attn_backend``: "auto" (the CUDA flash kernel hook on CUDA,
        plain attention on the CPU), "flash" (the kernel hook; CUDA
        only), or "plain" (``ops.attention`` only); see
        :func:`resolve_attn_backend`.  ``self.attn_backend`` holds the
        resolved choice.

        ``device``: where the engine runs, CUDA unless "cpu" is asked
        for; ``params`` must already live there.

        ``kv_cache_blocks`` > 0, ``kv_block_tokens``, ``kv_cache_dtype``
        and ``kv_dtype`` are refused until the slice that ports the
        KV-cache pool; ``kv_layout`` takes the reference's only value,
        "paged", which with zero blocks changes nothing.  Other arguments
        as in the reference."""
        require_float_weights(cfg)
        if (kv_cache_blocks or kv_block_tokens is not None or kv_cache_dtype
                or kv_dtype):
            raise NotImplementedError(KVCACHE_LATER)
        if (kv_layout or "paged") != "paged":
            raise ValueError(f"unknown kv layout {kv_layout!r}; expected "
                             "'paged'")
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

        self.attn_backend = resolve_attn_backend(
            attn_backend, self.device.type, cfg.head_dim)
        self._attn_impl = (make_flash_attn_impl()
                           if self.attn_backend == "flash" else None)

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

    def _run_prefill(self, ids, cache):
        """Whole-prompt or chunked prefill -> (last_logits [b, V], cache)."""
        if self.prefill_chunk is None:
            return self._prefill(ids, cache)
        return run_chunked_prefill(ids, cache, self.prefill_chunk,
                                   self.max_seq, self._chunk_mid,
                                   self._chunk_last)

    # -- decode --------------------------------------------------------

    def _eos(self) -> int:
        """eos_id read at call time (-1 = disabled)."""
        return self.eos_id if self.eos_id is not None else -1

    def _step(self, logits, cache, gen, eos: int, done, with_logprobs):
        """One decode step, shared by the loop and the per-token stream
        (so the two are bit-identical by construction): sample, eos-pad
        finished rows, match stop ids, score the emitted token, forward
        it.  Returns (tok, lp or None, next_logits, cache, done)."""
        b = logits.shape[0]
        tok = sample_logits(logits, gen, self.sampling)
        if eos >= 0:
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            done = done | (tok == eos)
        done = done | match_stop_ids(tok, self._stop_ids)
        lp = None
        if with_logprobs:
            lp = torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                              tok[:, None])[:, 0]
        pos = torch.full((b, 1), cache.length, dtype=torch.int64,
                         device=self.device)
        out, cache = self._fwd(tok[:, None], cache, pos, False)
        return tok, lp, out[:, 0], cache, done

    def _decode_loop(self, logits, cache, gen, eos, done, limit: int,
                     num_steps: int, with_logprobs: bool = False):
        """Up to ``limit`` steps, stopping early once every row is done.
        Returns (toks [b, num_steps], lps [b, num_steps], next_logits,
        cache, done, steps_ran); columns >= steps_ran are eos padding
        (token 0 without an eos)."""
        b = logits.shape[0]
        toks = torch.full((b, num_steps), eos if eos >= 0 else 0,
                          dtype=torch.int64, device=self.device)
        lps = torch.zeros((b, num_steps), dtype=torch.float32,
                          device=self.device)
        # rows can only finish through eos or a stop id; without either,
        # skip the per-step host sync that reads `done`
        can_finish = eos >= 0 or self._has_stop_ids
        j = 0
        while j < limit and not (can_finish and bool(done.all())):
            tok, lp, logits, cache, done = self._step(
                logits, cache, gen, eos, done, with_logprobs)
            toks[:, j] = tok
            if lp is not None:
                lps[:, j] = lp
            j += 1
        return toks, lps, logits, cache, done, j

    def _count_loop(self, steps: int) -> None:
        """One decode-loop call ran ``steps`` steps."""
        self.loop_stats["host_dispatches"] += 1
        self.loop_stats["device_loop_steps"] += steps

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _ids(self, prompt_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64)
        if ids.ndim != 2:
            raise ValueError("prompt_ids must be [batch, prompt_len]")
        return ids.to(self.device)

    def new_cache(self, batch: int) -> KVCache:
        return KVCache.create(self.cfg, self.cfg.num_layers, batch,
                              self.max_seq, device=self.device)

    # -- public surface ------------------------------------------------

    def prefill_logits(self, prompt_ids) -> np.ndarray:
        """Last-position logits [batch, vocab] (f32) after prefill."""
        ids = self._ids(prompt_ids)
        check_capacity(self.max_seq, ids.shape[1], 0)
        logits, _ = self._run_prefill(ids, self.new_cache(ids.shape[0]))
        return logits.float().cpu().numpy()

    def generate(self, prompt_ids, max_new_tokens: int, seed: int = 0,
                 logprobs: bool = False) -> GenerationResult:
        """Batch generation through the decode loop.  ``seconds`` covers
        prefill and decode, ending when the tokens are on the host."""
        ids = self._ids(prompt_ids)
        b, plen = ids.shape
        check_capacity(self.max_seq, plen, max_new_tokens)
        gen = self._generator(seed)
        t0 = time.perf_counter()
        cache = self.new_cache(b)
        last_logits, cache = self._run_prefill(ids, cache)
        toks, lps, _, _, _, steps = self._decode_loop(
            last_logits, cache, gen, self._eos(),
            torch.zeros(b, dtype=torch.bool, device=self.device),
            max_new_tokens, max_new_tokens, logprobs)
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
        b, plen = ids.shape
        check_capacity(self.max_seq, plen, max_new_tokens)
        cache = self.new_cache(b)
        gen = self._generator(seed)
        logits, cache = self._run_prefill(ids, cache)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        K = self.stream_block
        if K > 1:
            remaining = max_new_tokens
            while remaining > 0:
                toks, lps, logits, cache, done, steps = self._decode_loop(
                    logits, cache, gen, self._eos(), done,
                    min(K, remaining), K, logprobs)
                self._count_loop(steps)
                if steps == 0:      # all rows were already done on entry
                    return
                tok_np = toks.cpu().numpy().astype(np.int32)
                lp_np = lps.cpu().numpy() if logprobs else None
                for j in range(steps):
                    yield ((tok_np[:, j], lp_np[:, j]) if logprobs
                           else tok_np[:, j])
                remaining -= steps
                if bool(done.all()):
                    return
            return
        for _ in range(max_new_tokens):
            tok, lp, logits, cache, done = self._step(
                logits, cache, gen, self._eos(), done, logprobs)
            self._count_loop(1)
            tok_np = tok.cpu().numpy().astype(np.int32)
            yield (tok_np, lp.cpu().numpy()) if logprobs else tok_np
            if ((self.eos_id is not None or self._has_stop_ids)
                    and bool(done.all())):
                return
