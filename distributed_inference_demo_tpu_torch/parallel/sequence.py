"""Sequence/context parallelism: long-context generation over ``sp``.

Counterpart of ``distributed_inference_demo_tpu/parallel/sequence.py``.
The prompt is sharded into contiguous chunks over the ``sp`` axis,
prefill runs ring attention (``ops/ring_attention.py``) so no rank holds
the whole sequence, and the cache stays sharded by sequence for the
whole generation: decode merges per-shard partial attention with an
exact log-sum-exp reduction instead of moving K/V.

Decode-token placement is stateless round-robin: the d-th decoded
token's K/V lands on rank ``d % sp`` at slot ``chunk + d // sp``, and the
``kv_pos`` map (-1 = empty) drives causal masking.  The decoder block is
the shared ``stage_forward`` with an ``attn_impl`` hook.

Rank 0 drives (``parallel/mesh.py``).  A generation is one command run
on every rank; the step-split stream programs keep each rank's decode
state (its cache shard, ``kv_pos``, the lengths, the last token, its
generator) in the mesh's object table between commands.  Every rank
samples the same token from the same replicated logits with a generator
seeded alike (greedy: argmax), as the reference's ranks do with one rng.
"""

from typing import Optional

import torch

from ..models.base import KVCache, ModelConfig, StageSpec
from ..models.decoder import stage_forward
from ..ops.attention import update_kv_cache
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import cast_kv
from ..ops.ring_attention import ring_self_attention, sp_decode_attention
from ..ops.sampling import SamplingParams, sample_logits


def _final_logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head on [b, l, H] (stage_forward's tail, applied
    to just the selected last position)."""
    if cfg.attn_layernorm:
        h = layer_norm(h, params.final_norm["w"], params.final_norm["b"],
                       cfg.norm_eps)
    else:
        h = rms_norm(h, params.final_norm["w"], cfg.norm_eps)
    head = (params.embed["tokens"].T if cfg.tie_embeddings
            else params.lm_head["w"])
    return torch.einsum("blh,hv->blv", h, head)


def _sample_first_token(params, cfg, hidden, group, gen, sampling):
    """The global last prompt token lives on the last rank: its hidden
    row reaches every rank by an all-reduce, the head runs once on that
    position, and token #1 is sampled."""
    last = group.rank == group.size - 1
    h = (hidden[:, -1:, :].float() if last
         else torch.zeros_like(hidden[:, -1:, :], dtype=torch.float32))
    h = group.all_reduce(h.contiguous()).to(cfg.dtype)
    logits = _final_logits(params, cfg, h)[:, 0, :]
    return sample_logits(logits, gen, sampling)


def validate_sp_prompt(plen: int, sp: int, max_seq: int,
                       num_new_tokens: int) -> None:
    """The sp prompt-shape rule, shared by the generate fns' call-time
    check and any caller that wants to fail fast (cli ``generate --sp``)."""
    if plen % sp:
        raise ValueError(
            f"prompt_len={plen} not divisible by sp={sp}; pad first")
    if plen + num_new_tokens > max_seq:
        raise ValueError(
            f"prompt {plen} + new {num_new_tokens} > max_seq {max_seq}")


def _resolve_kv_dtype(kv_cache_dtype):
    from ..runtime.engine import resolve_cache_dtype_backend
    dt, _ = resolve_cache_dtype_backend(kv_cache_dtype, "plain")
    return dt


class RingCore:
    """The ring-sp math on one rank (the reference's ``_make_ring_cores``):
    ``prefill`` makes this rank's decode state and samples token #1,
    ``step`` decodes one token."""

    def __init__(self, cfg: ModelConfig, max_seq: int, sp: int,
                 sampling: SamplingParams, kv_dtype):
        self.cfg, self.sampling, self.kv_dtype = cfg, sampling, kv_dtype
        self.s_loc = max_seq // sp
        self.spec = StageSpec(0, 1, 0, cfg.num_layers)

    def prefill(self, mesh, params, ids, gen) -> dict:
        cfg, kv_dtype = self.cfg, self.kv_dtype
        group = mesh.group("sp")
        n, idx = group.size, group.rank
        b, S = ids.shape
        chunk = S // n
        dev = mesh.device

        def prefill_attn(q, k, v, kc, vc, pos, cache_start, slopes):
            update_kv_cache(kc, vc, k, v, 0)
            if kv_dtype is not None:
                # attention reads what the cache stores
                k = cast_kv(k, kv_dtype).to(cfg.dtype)
                v = cast_kv(v, kv_dtype).to(cfg.dtype)
            return ring_self_attention(q, k, v, group, slopes=slopes), kc, vc

        shape = (cfg.num_layers, b, cfg.num_kv_heads, self.s_loc,
                 cfg.head_dim)
        cache_dtype = kv_dtype or cfg.dtype
        keys = torch.zeros(shape, dtype=cache_dtype, device=dev)
        values = torch.zeros(shape, dtype=cache_dtype, device=dev)
        positions = (idx * chunk
                     + torch.arange(chunk, device=dev)).expand(b, chunk)
        # not the last stage: hidden states come back, and the head runs
        # once on the selected last position
        body_spec = StageSpec(0, 2, 0, cfg.num_layers)
        hidden, _ = stage_forward(params, cfg, body_spec,
                                  ids[:, idx * chunk:(idx + 1) * chunk],
                                  KVCache(keys, values, 0), positions,
                                  attn_impl=prefill_attn)
        ar = torch.arange(self.s_loc, device=dev)
        kv_pos = torch.where(ar < chunk, idx * chunk + ar,
                             torch.full_like(ar, -1))
        tok = _sample_first_token(params, cfg, hidden, group, gen,
                                  self.sampling)
        return {"keys": keys, "values": values, "kv_pos": kv_pos,
                "plen": S, "length": S, "tok": tok, "gen": gen}

    def step(self, mesh, params, st: dict) -> torch.Tensor:
        cfg = self.cfg
        group = mesh.group("sp")
        n, idx = group.size, group.rank
        plen, length, tok = st["plen"], st["length"], st["tok"]
        b = tok.shape[0]
        chunk = plen // n
        d = length - plen
        owner = idx == d % n
        slot = chunk + d // n
        if owner:
            st["kv_pos"][slot] = length
        kv_pos = st["kv_pos"]
        pos = torch.full((b, 1), length, dtype=torch.int64,
                         device=tok.device)

        def dec_attn(q, k, v, kc, vc, pos_, cache_start, slopes):
            if owner:
                kc[:, :, slot] = cast_kv(k[:, 0], kc.dtype)
                vc[:, :, slot] = cast_kv(v[:, 0], vc.dtype)
            return (sp_decode_attention(q, kc, vc, kv_pos, pos_, group,
                                        slopes=slopes), kc, vc)

        logits, _ = stage_forward(params, cfg, self.spec, tok[:, None],
                                  KVCache(st["keys"], st["values"], length),
                                  pos, attn_impl=dec_attn)
        nxt = sample_logits(logits[:, -1, :], st["gen"], self.sampling)
        st["length"], st["tok"] = length + 1, nxt
        return nxt


def _core(strategy: str, cfg, max_seq, sp, sampling, kv_dtype):
    if strategy == "ring":
        return RingCore(cfg, max_seq, sp, sampling, kv_dtype)
    from .ulysses import UlyssesCore
    return UlyssesCore(cfg, max_seq, sp, sampling, kv_dtype)


def _generator(mesh, seed: int) -> torch.Generator:
    return torch.Generator(device=mesh.device).manual_seed(int(seed))


def _sp_generate(mesh, core, params_h, ids, seed, num_new):
    """Command: a whole generation on every rank -> [b, num_new]."""
    params = mesh.objects[params_h]
    st = core.prefill(mesh, params, ids, _generator(mesh, seed))
    toks = [st["tok"]]
    for _ in range(num_new - 1):
        toks.append(core.step(mesh, params, st))
    return torch.stack(toks, dim=1)


def _sp_prefill(mesh, core, params_h, ids, seed, state_h):
    """Command: prefill, the decode state kept under ``state_h``;
    returns token #1."""
    st = core.prefill(mesh, mesh.objects[params_h], ids,
                      _generator(mesh, seed))
    mesh.objects[state_h] = st
    return st["tok"]


def _sp_decode(mesh, core, params_h, state_h, block):
    """Command: ``block`` decode steps on the kept state -> [b, block]."""
    st, params = mesh.objects[state_h], mesh.objects[params_h]
    return torch.stack([core.step(mesh, params, st) for _ in range(block)],
                       dim=1)


def _sp_drop(mesh, state_h):
    """Command: free a stream's decode state."""
    mesh.objects.pop(state_h, None)


def replicate_params(params, cfg: ModelConfig, mesh):
    """Every rank's full copy of ``params`` (sp ranks run on whole
    weights); returns rank 0's ``ShardedParams``."""
    from .sharding import stage_param_spec_tree
    from .tensor import distribute_params
    return distribute_params(params, cfg, mesh,
                             stage_param_spec_tree(params, cfg,
                                                   use_tp=False))


def _check_sp(mesh, max_seq: int) -> int:
    sp = mesh.shape["sp"]
    if max_seq % sp:
        raise ValueError(f"max_seq={max_seq} not divisible by sp={sp}")
    return sp


def _as_params(params, cfg, mesh):
    """Replicated params for ``mesh``: a full tree is sent to every rank
    once (cached on the mesh by the tree's identity)."""
    if getattr(params, "handle", None) is not None:
        return params
    cache = mesh.objects.setdefault("_replicated", {})
    got = cache.get(id(params))
    if got is None or got[0] is not params:
        got = cache[id(params)] = (params,
                                   replicate_params(params, cfg, mesh))
    return got[1]


def _make_generate_fn(strategy, cfg, mesh, max_seq, num_new_tokens,
                      sampling, kv_cache_dtype):
    sp = _check_sp(mesh, max_seq)
    core = _core(strategy, cfg, max_seq, sp,
                 sampling or SamplingParams(greedy=True),
                 _resolve_kv_dtype(kv_cache_dtype))

    def fn(params, prompt_ids, seed=0):
        ids = torch.as_tensor(prompt_ids, dtype=torch.int64)
        validate_sp_prompt(ids.shape[1], sp, max_seq, num_new_tokens)
        p = _as_params(params, cfg, mesh)
        return mesh.spmd(_sp_generate, core, p.handle, ids, int(seed),
                         num_new_tokens)

    return fn


def make_sp_generate_fn(cfg: ModelConfig, mesh, *, max_seq: int,
                        num_new_tokens: int,
                        sampling: Optional[SamplingParams] = None,
                        kv_cache_dtype=None):
    """``fn(params, prompt_ids, seed) -> tokens`` [b, num_new_tokens]:
    ring-attention prefill + sp-sharded-cache decode over ``mesh``'s sp
    axis.  ``params`` is a full tree (sent to every rank once) or
    :func:`replicate_params`' result.  Requires ``prompt_len % sp ==
    0``, ``prompt_len + num_new_tokens <= max_seq`` and ``max_seq % sp
    == 0``; greedy when ``sampling`` is None.  ``kv_cache_dtype``
    ("float8_e4m3fn"): the sharded cache's storage; prefill attends the
    K/V rounded through it, as decode reads it back."""
    return _make_generate_fn("ring", cfg, mesh, max_seq, num_new_tokens,
                             sampling, kv_cache_dtype)


class StreamFns:
    """``(prefill_fn, decode_fn)`` over one strategy's core: the
    step-split programs of incremental serving.

    - ``prefill_fn(params, prompt_ids, seed) -> (state, tok)``: prefill,
      token #1; every rank keeps its decode state under ``state``.
    - ``decode_fn(params, state) -> toks [b, block]``: ``block`` steps.
    - ``drop(state)``: free the state on every rank.

    Greedy streams equal the fused fn's tokens.  A final partial block
    may decode past ``max_new``; the caller takes what it needs and
    drops the state."""

    def __init__(self, strategy, cfg, mesh, max_seq, block, sampling,
                 kv_cache_dtype):
        if block < 1:
            raise ValueError("block must be >= 1")
        self.cfg, self.mesh, self.block = cfg, mesh, block
        self.max_seq = max_seq
        self.sp = _check_sp(mesh, max_seq)
        self.core = _core(strategy, cfg, max_seq, self.sp,
                          sampling or SamplingParams(greedy=True),
                          _resolve_kv_dtype(kv_cache_dtype))

    def prefill_fn(self, params, prompt_ids, seed=0):
        ids = torch.as_tensor(prompt_ids, dtype=torch.int64)
        p = _as_params(params, self.cfg, self.mesh)
        state = self.mesh.new_handle()
        tok = self.mesh.spmd(_sp_prefill, self.core, p.handle, ids,
                             int(seed), state)
        return state, tok

    def decode_fn(self, params, state):
        p = _as_params(params, self.cfg, self.mesh)
        return self.mesh.spmd(_sp_decode, self.core, p.handle, state,
                              self.block)

    def drop(self, state) -> None:
        if not self.mesh.closed:
            self.mesh.spmd(_sp_drop, state)


def make_sp_stream_fns(cfg: ModelConfig, mesh, *, max_seq: int, block: int,
                       sampling: Optional[SamplingParams] = None,
                       kv_cache_dtype=None) -> StreamFns:
    """The step-split ring-sp programs (:class:`StreamFns`)."""
    return StreamFns("ring", cfg, mesh, max_seq, block, sampling,
                     kv_cache_dtype)


def _ring_attention(mesh, q, k, v, slopes):
    """Command: each rank's contiguous chunk of q/k/v through
    ``ring_self_attention``; the outputs gathered in sequence order."""
    g = mesh.group("sp")
    c = q.shape[1] // g.size
    part = slice(g.rank * c, (g.rank + 1) * c)
    out = ring_self_attention(q[:, part], k[:, part], v[:, part], g,
                              slopes=slopes)
    return g.all_gather(out.contiguous(), dim=1)


def run_ring_attention(mesh, q, k, v, slopes=None):
    """Causal self-attention of whole-sequence q [b, S, nh, hd] and k/v
    [b, S, nkv, hd] over the mesh's sp ranks, each holding a contiguous
    chunk (the reference's ``shard_map`` over ``P(None, "sp")``)."""
    return mesh.spmd(_ring_attention, q, k, v, slopes)


def _sp_decode_attention(mesh, q, k, v, kv_pos, q_positions, slopes):
    """Command: each rank's slot range of a sequence-sharded cache through
    ``sp_decode_attention``; every rank gets the merged output."""
    g = mesh.group("sp")
    s = k.shape[2] // g.size
    part = slice(g.rank * s, (g.rank + 1) * s)
    return sp_decode_attention(q, k[:, :, part], v[:, :, part],
                               kv_pos[part], q_positions, g, slopes=slopes)


def run_sp_decode_attention(mesh, q, k, v, kv_pos, q_positions,
                            slopes=None):
    """Decode attention of q [b, lq, nh, hd] over a head-major cache
    [b, nkv, S, hd] whose slots (``kv_pos`` [S], -1 empty) are split in
    equal ranges over the mesh's sp ranks."""
    return mesh.spmd(_sp_decode_attention, q, k, v, kv_pos, q_positions,
                     slopes)
