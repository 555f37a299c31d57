"""One decoder implementation for every model family of the catalog.

Counterpart of ``distributed_inference_demo_tpu/models/decoder.py``.  One
``stage_forward`` covers, as flag branches of the same block:

- **llama** (TinyLlama-1.1B, Llama-3-8B): RMSNorm, RoPE, GQA, SwiGLU;
- **qwen2**: the llama block with q/k/v biases;
- **gemma**: sqrt(H) embedding scale, GeGLU (tanh), decoupled head_dim;
- **bloom**: LayerNorm with bias, ALiBi, embedding LayerNorm, GELU MLP;
- **mixtral**: the llama block with a top-k routed MoE MLP, computed as
  the reference computes it: every expert on every token, combined by a
  dense routing matrix that is zero off the top k.

Int8 and int4 weights (``-int8`` / ``-int4`` configs) go through
``ops.quant.dense``, expert stacks one expert at a time.  The reference's
``lax.scan`` over the stacked layers becomes a Python loop that writes
each layer's cache plane in place; with no cache (the training form,
``parallel/pipeline.py``) each layer keeps its own K/V and nothing is
written in place, so autograd runs through it.

Under tensor parallelism (``tp``, a ``parallel.mesh.AxisGroup``: this
rank's slice of the weights, ``parallel/sharding.py``) the block sums
its partial products with an all-reduce after ``wo`` and ``w_down``,
adds biases once after the reduction, slices ALiBi slopes by rank, takes
its slice of the MoE routing matrix, and all-gathers vocab-parallel
logits at the sampling boundary, as the reference's ``tp_axis`` branch.
``ep`` selects the expert-parallel dispatch (:func:`_moe_mlp_ep`).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import (alibi_slopes, attention, attention_at,
                             prepare_kv_chunk, update_kv_cache)
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import (QuantizedArray, QuantizedArray4, dense,
                         int4_group_for, quantize_array, quantize_array4)
from ..ops.rope import apply_rope
from .base import KVCache, ModelConfig, StageParams, StageSpec


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype, device, scale=None):
    """Normal(0, scale) weights, scale = fan_in ** -0.5 unless given (the
    reference's rule; threefry's numbers are not reproduced).  Stacked
    tensors are filled one matrix (the last two axes) at a time, so the
    f32 transient is one matrix's, and a layer slice of a stack draws
    what the stack draws for that layer."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else float(fan_in) ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out.view(-1, *shape[-2:]) if len(shape) >= 3 else [out]
    for part in parts:
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * scale)
    return out


def _init_quantized(gen: torch.Generator, shape, dtype, device, mode: str):
    """Init + quantize (int8 or int4) one layer slice at a time: each
    layer is drawn by :func:`_dense_init` and quantized, so the codes are
    those of the float init's weights, and peak memory is the quantized
    footprint plus one layer's float transient, never the whole tensor
    at float width."""
    L, fan_in = shape[0], shape[-2]
    q = sc = None
    for i in range(L):
        w = _dense_init(gen, shape[1:], dtype, device)
        qa = (quantize_array4(w) if mode == "int4"
              else quantize_array(w, stacked=False))
        if q is None:
            q = torch.empty((L, *qa.q.shape), dtype=qa.q.dtype,
                            device=device)
            sc = torch.empty((L, *qa.scale.shape), dtype=qa.scale.dtype,
                             device=device)
        q[i].copy_(qa.q)
        sc[i].copy_(qa.scale)
        del w, qa     # this layer's float transient goes before the next
    if mode == "int4":
        return QuantizedArray4(q=q, scale=sc, group=int4_group_for(fan_in))
    return QuantizedArray(q=q, scale=sc)


def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      num_layers: int, device, quantize=False) -> dict:
    """Stacked per-layer weights, leading dim = num_layers (the
    reference's names and shapes).  With ``quantize`` (True = "int8", or
    "int8" / "int4"), each big matmul operand is drawn and quantized one
    layer at a time (:func:`_init_quantized`)."""
    H, nh, nkv, hd = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
    I, L, dt = cfg.intermediate_size, num_layers, cfg.dtype
    mode = "int8" if quantize is True else quantize

    def big(shape):
        if mode:
            return _init_quantized(gen, shape, dt, device, mode)
        return _dense_init(gen, shape, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    p = {
        "attn_norm_w": ones(L, H),
        "wq": big((L, H, nh * hd)),
        "wk": big((L, H, nkv * hd)),
        "wv": big((L, H, nkv * hd)),
        "wo": big((L, nh * hd, H)),
        "mlp_norm_w": ones(L, H),
    }
    if cfg.attn_layernorm:  # bloom: LayerNorm has bias; linears have bias
        p["attn_norm_b"] = zeros(L, H)
        p["mlp_norm_b"] = zeros(L, H)
        p["bo"] = zeros(L, H)
    if cfg.attn_layernorm or cfg.attn_qkv_bias:  # + qwen2: qkv-only bias
        p["bq"] = zeros(L, nh * hd)
        p["bk"] = zeros(L, nkv * hd)
        p["bv"] = zeros(L, nkv * hd)
    if cfg.num_experts > 0:  # mixtral: E experts, a router over them
        E = cfg.num_experts
        p["router"] = _dense_init(gen, (L, H, E), dt, device)
        p["w_gate"] = big((L, E, H, I))
        p["w_up"] = big((L, E, H, I))
        p["w_down"] = big((L, E, I, H))
    elif cfg.family == "bloom":  # dense 4H GELU MLP with bias
        p["w_up"] = big((L, H, I))
        p["b_up"] = zeros(L, I)
        p["w_down"] = big((L, I, H))
        p["b_down"] = zeros(L, H)
    else:  # gated MLP (SwiGLU / GeGLU)
        p["w_gate"] = big((L, H, I))
        p["w_up"] = big((L, H, I))
        p["w_down"] = big((L, I, H))
    return p


def init_full_params(generator: torch.Generator, cfg: ModelConfig,
                     device=None, quantize=False) -> StageParams:
    """Random-init full model as a single StageParams (stage 0 of 1), with
    the reference's shapes and scale rules, on ``device`` (CUDA unless
    the CPU is asked for).  ``generator`` must live on that device.

    ``quantize=True`` resolves to the config's own mode (int8 or int4),
    as in the reference; the float tree otherwise, whatever the config.
    The quantized weights are the codes of the float init's weights from
    the same generator state.  ``device="meta"`` gives the tree's
    skeleton (shapes, dtypes, quantized leaves) with nothing
    materialised."""
    if quantize is True and cfg.quantization in ("int8", "int4"):
        quantize = cfg.quantization
    if device is None or torch.device(device).type != "meta":
        device = resolve_device(device)
    dt = cfg.dtype
    H = cfg.hidden_size
    embed = {"tokens": _dense_init(generator, (cfg.vocab_size, H), dt,
                                   device, scale=0.02)}
    if cfg.family == "bloom":  # bloom applies LayerNorm right after embedding
        embed["norm_w"] = torch.ones(H, dtype=dt, device=device)
        embed["norm_b"] = torch.zeros(H, dtype=dt, device=device)
    final_norm = {"w": torch.ones(H, dtype=dt, device=device)}
    if cfg.attn_layernorm:
        final_norm["b"] = torch.zeros(H, dtype=dt, device=device)
    layers = init_layer_params(generator, cfg, cfg.num_layers, device,
                               quantize=quantize)
    if cfg.tie_embeddings:
        lm_head = {}  # reuse embed["tokens"]
    else:
        lm_head = {"w": _dense_init(generator, (H, cfg.vocab_size), dt,
                                    device)}
    return StageParams(layers=layers, embed=embed, final_norm=final_norm,
                       lm_head=lm_head)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(params: StageParams, cfg: ModelConfig,
                 ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> [b, s, H] through the embedding pipeline (table lookup,
    gemma's scale, bloom's embedding LayerNorm)."""
    x = params.embed["tokens"][ids]
    if cfg.embed_scale:
        # the normalizer is cast to the activation dtype first (HF
        # semantics, as in the reference)
        x = x * float(torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype))
    if "norm_w" in params.embed:
        x = layer_norm(x, params.embed["norm_w"], params.embed["norm_b"],
                       cfg.norm_eps)
    return x


def _mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor, tp=None,
         ep=None) -> torch.Tensor:
    """MLP block.  Under ``tp``, w_gate/w_up arrive column-sliced and
    w_down row-sliced: the partial products are summed with an
    all-reduce; biases are added once, after it."""
    if cfg.num_experts > 0:
        if ep is not None:
            return _moe_mlp_ep(cfg, lp, x, ep)
        return _moe_mlp(cfg, lp, x, tp)
    if cfg.family == "bloom":
        # b_up arrives column-sliced with w_up's local columns
        h = dense(x, lp["w_up"], "bsh,hi->bsi") + lp["b_up"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        out = dense(h, lp["w_down"], "bsi,ih->bsh")
        if tp is not None:
            out = tp.all_reduce(out)
        return out + lp["b_down"]
    gate = dense(x, lp["w_gate"], "bsh,hi->bsi").float()
    up = dense(x, lp["w_up"], "bsh,hi->bsi")
    act = (F.gelu(gate, approximate="tanh") if cfg.mlp_act == "gelu_tanh"
           else F.silu(gate))
    h = (act * up.float()).to(x.dtype)
    out = dense(h, lp["w_down"], "bsi,ih->bsh")
    if tp is not None:
        out = tp.all_reduce(out)
    return out


def moe_route(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The dense [..., E] f32 routing matrix of f32 router ``logits``: a
    softmax over the top ``k``, zero elsewhere.  The top k come from a
    stable descending sort, so equal logits pick the lower expert index,
    as ``lax.top_k`` does (``torch.topk`` promises no order on ties)."""
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(topv[..., :k], dim=-1)
    return torch.zeros_like(logits).scatter(-1, topi[..., :k], weights)


def _moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor,
             tp=None) -> torch.Tensor:
    """Top-k routed MoE (mixtral), as the reference computes it: router
    logits in x's dtype, then f32; the dense routing matrix of
    :func:`moe_route`; all E experts on every token (SiLU and the gate
    product in f32, cast to x's dtype); the combine in x's dtype.
    Nothing here has a data-dependent shape, so a decode step through it
    is one CUDA graph.  Under ``tp`` this rank holds E/tp experts: it
    takes its slice of the routing matrix, and the partial outputs are
    all-reduced."""
    logits = torch.einsum("bsh,he->bse", x, lp["router"]).float()
    route = moe_route(logits, cfg.experts_per_token)
    if tp is not None:
        e_local = lp["w_gate"].shape[0]
        route = route[..., tp.rank * e_local:(tp.rank + 1) * e_local]
    gate = dense(x, lp["w_gate"], "bsh,ehi->besi")
    up = dense(x, lp["w_up"], "bsh,ehi->besi")
    h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    out = dense(h, lp["w_down"], "besi,eih->besh")           # [b, E, s, H]
    out = torch.einsum("besh,bse->bsh", out, route.to(x.dtype))
    if tp is not None:
        out = tp.all_reduce(out)
    return out


def _expert_each(x: torch.Tensor, w) -> torch.Tensor:
    """``einsum("eck,ekn->ecn")``: each expert's rows through its own
    weight.  A quantized stack takes one dense product per expert (the
    dense kernel on the card), a float stack one ``bmm``."""
    if not isinstance(w, (QuantizedArray, QuantizedArray4)):
        return torch.bmm(x, w)
    from ..ops.quant import expert_weight
    return torch.stack([dense(x[e], expert_weight(w, e), "ck,kn->cn")
                        for e in range(x.shape[0])])


def _moe_mlp_ep(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                ep) -> torch.Tensor:
    """Expert-parallel MoE: GShard capacity dispatch and two all-to-alls
    over ``ep`` (the reference's ``_moe_mlp_ep``).  This rank holds E/n
    experts' weights and its own tokens; each token's top-k experts take
    it into per-expert capacity slots (``C = ceil(T*k/E *
    moe_capacity_factor)``; over-capacity tokens drop, zero output), one
    all-to-all ships the slot buffers to the expert owners, the experts
    run batched, and a second brings the outputs home for the weighted
    combine.  Dispatch and combine are one-hot einsums, as the
    reference's."""
    b, s, H = x.shape
    T = b * s
    E, k = cfg.num_experts, cfg.experts_per_token
    n = ep.size
    e_loc = lp["w_gate"].shape[0]
    if e_loc * n != E:
        raise ValueError(f"{e_loc} local experts x ep={n} != {E}")
    xt = x.reshape(T, H)

    logits = dense(xt, lp["router"], "th,he->te").float()
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]                   # [T, k]
    weights = torch.softmax(topv, dim=-1)

    C = int(math.ceil(T * k / E * cfg.moe_capacity_factor))
    onehot = F.one_hot(topi, E).to(torch.int32)             # [T, k, E]
    flat = onehot.reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0) - 1                     # slot per expert
    keep = (flat > 0) & (pos < C)
    slot = torch.where(keep, pos, torch.full_like(pos, C))  # C -> dropped
    disp = F.one_hot(slot.long(), C + 1)[..., :C].float()   # [T*k, E, C]
    disp_t = disp.reshape(T, k, E, C).sum(1)                # [T, E, C]
    comb = (disp * weights.reshape(T * k)[:, None, None]
            ).reshape(T, k, E, C).sum(1)                    # [T, E, C]

    expert_in = torch.einsum("tec,th->ech", disp_t, xt.float())  # [E, C, H]
    ein = ep.all_to_all(expert_in.reshape(n, e_loc, C, H).contiguous())
    h_in = ein.transpose(0, 1).reshape(e_loc, n * C, H).to(x.dtype)

    gate = _expert_each(h_in, lp["w_gate"])
    up = _expert_each(h_in, lp["w_up"])
    hh = (F.silu(gate.float()) * up.float()).to(x.dtype)
    out = _expert_each(hh, lp["w_down"])                    # [e_loc, n*C, H]

    out = out.reshape(e_loc, n, C, H).transpose(0, 1).contiguous()
    out = ep.all_to_all(out)
    expert_out = out.reshape(E, C, H).float()
    y = torch.einsum("tec,ech->th", comb, expert_out)
    return y.reshape(b, s, H).to(x.dtype)


def _default_attn(q, k, v, k_cache, v_cache, positions, cache_start, slopes):
    """Default attention path: insert the chunk into the cache (in place),
    attend to the cache.  ``attn_impl`` hooks share this signature.  A
    ``cache_start`` held as a device tensor takes the fixed-shape form
    (``ops.attention.attention_at``), the one a CUDA graph replays."""
    if torch.is_tensor(cache_start):
        return (attention_at(q, k, v, k_cache, v_cache, positions,
                             cache_start, slopes), k_cache, v_cache)
    k_cache, v_cache = update_kv_cache(k_cache, v_cache, k, v, cache_start)
    out = attention(q, k_cache, v_cache, positions,
                    int(cache_start) + q.shape[1], slopes)
    return out, k_cache, v_cache


def _own_kv_attn(q, k, v, k_cache, v_cache, positions, cache_start, slopes):
    """The training form's attention hook: the chunk attends to its own
    K/V, a cache of exactly the chunk from position 0 (the reference's
    per-layer zeros with the chunk written at 0, ``cache_in_carry=False``).
    It is built out of place and held by this layer alone, so nothing
    autograd saved is written afterwards."""
    k, v = prepare_kv_chunk(k, v, k.dtype, v.dtype)
    out = attention(q, k.transpose(1, 2), v.transpose(1, 2), positions,
                    q.shape[1], slopes)
    return out, None, None


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
           k_cache: torch.Tensor, v_cache: torch.Tensor,
           positions: torch.Tensor, cache_start,
           slopes: Optional[torch.Tensor], attn_impl=None, tp=None,
           ep=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder block. x: [b, s, H]. Returns (x', k_cache, v_cache).
    Head counts derive from the weights, so under ``tp`` this rank runs
    nh/tp query heads and nkv/tp kv heads on its cache plane."""
    b, s, H = x.shape
    hd = cfg.head_dim
    nh = lp["wq"].shape[-1] // hd
    nkv = lp["wk"].shape[-1] // hd

    if cfg.attn_layernorm:
        h = layer_norm(x, lp["attn_norm_w"], lp["attn_norm_b"], cfg.norm_eps)
    else:
        h = rms_norm(x, lp["attn_norm_w"], cfg.norm_eps)

    q = dense(h, lp["wq"], "bsh,hd->bsd")
    k = dense(h, lp["wk"], "bsh,hd->bsd")
    v = dense(h, lp["wv"], "bsh,hd->bsd")
    if cfg.attn_layernorm or cfg.attn_qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)

    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    attn_fn = attn_impl if attn_impl is not None else _default_attn
    attn, k_cache, v_cache = attn_fn(
        q, k, v, k_cache, v_cache, positions, cache_start, slopes)
    attn = dense(attn.reshape(b, s, nh * hd), lp["wo"], "bsd,dh->bsh")
    if tp is not None:
        attn = tp.all_reduce(attn)
    if cfg.attn_layernorm:
        attn = attn + lp["bo"]
    x = x + attn

    if cfg.attn_layernorm:
        h = layer_norm(x, lp["mlp_norm_w"], lp["mlp_norm_b"], cfg.norm_eps)
    else:
        h = rms_norm(x, lp["mlp_norm_w"], cfg.norm_eps)
    return x + _mlp(cfg, lp, h, tp, ep), k_cache, v_cache


def stage_forward(
    params: StageParams,
    cfg: ModelConfig,
    spec: StageSpec,
    inputs: torch.Tensor,        # [b, s] int ids (first stage) or [b, s, H]
    cache: Optional[KVCache],    # this stage's cache; None: training form
    positions: torch.Tensor,     # [b, s] absolute positions of the chunk
    attn_impl=None,              # attention hook (see _default_attn)
    last_logits_only: bool = False,  # head over the final position only
    tp=None,                     # tensor-parallel AxisGroup (a rank's slice)
    ep=None,                     # expert-parallel AxisGroup
) -> Tuple[torch.Tensor, KVCache]:
    """Run this stage's layer range.  Returns (hidden or logits, cache).

    The cache's tensors are written in place, layer plane by layer plane;
    the returned KVCache shares them and carries the advanced length.
    ``last_logits_only`` narrows the LM head to the chunk's final position
    ([b, 1, V]): prefill samples only from the last token.

    ``cache=None`` is the training form (the reference's
    ``cache_in_carry=False``): the chunk starts at position 0, each layer
    attends to its own K/V (:func:`_own_kv_attn`), nothing is written in
    place, so ``backward()`` runs through it; the same ``_layer`` in the
    same order of operations.  The returned cache is None.  (The cached
    form writes every layer's K/V into a plane of one shared tensor,
    which bumps the version counter autograd saved for the planes before
    it.)"""
    if spec.is_first and not torch.is_floating_point(inputs):
        x = embed_tokens(params, cfg, inputs)  # [b, s, H]
    else:
        x = inputs.to(cfg.dtype)

    slopes = (alibi_slopes(cfg.num_heads, device=x.device)
              if cfg.use_alibi else None)
    if slopes is not None and tp is not None:
        nh_local = params.layers["wq"].shape[-1] // cfg.head_dim
        slopes = slopes[tp.rank * nh_local:(tp.rank + 1) * nh_local]
    if cache is None:
        if attn_impl is not None:
            raise ValueError("the training form (cache=None) runs the "
                             "default attention; attn_impl is for caches")
        # fresh views: ``params.layer``'s are built once, possibly under
        # no_grad, and would carry no gradient to the stack.  A float
        # stack is unbound once, so its gradient is one stack of the
        # layers' gradients; indexing it a layer at a time would add a
        # zero-filled stack-sized gradient per layer
        n = next(iter(params.layers.values())).shape[0]
        planes = {k: (v.unbind(0) if torch.is_tensor(v)
                      else [v[i] for i in range(n)])
                  for k, v in params.layers.items()}
        for li in range(n):
            lp = {k: v[li] for k, v in planes.items()}
            x, _, _ = _layer(cfg, lp, x, None, None, positions, 0, slopes,
                             _own_kv_attn, tp, ep)
        new_cache = None
    else:
        # a length held as a device scalar passes through (the
        # fixed-shape decode step); a host length stays a Python int
        cache_start = (cache.length if torch.is_tensor(cache.length)
                       else int(cache.length))
        for li in range(cache.keys.shape[0]):
            # every hook writes its layer's cache plane in place
            # (update_kv_cache), so the returned planes need no copy back
            x, _, _ = _layer(cfg, params.layer(li), x, cache.keys[li],
                             cache.values[li], positions, cache_start,
                             slopes, attn_impl, tp, ep)
        new_cache = KVCache(cache.keys, cache.values,
                            cache_start + inputs.shape[1])

    if spec.is_last:
        if last_logits_only:
            x = x[:, -1:, :]
        if cfg.attn_layernorm:
            x = layer_norm(x, params.final_norm["w"], params.final_norm["b"],
                           cfg.norm_eps)
        else:
            x = rms_norm(x, params.final_norm["w"], cfg.norm_eps)
        head = (params.embed["tokens"].T if cfg.tie_embeddings
                else params.lm_head["w"])
        x = torch.einsum("bsh,hv->bsv", x, head)
        if tp is not None and x.shape[-1] != cfg.vocab_size:
            # vocab-parallel head: every rank sees full logits
            x = tp.all_gather(x, dim=-1)
    return x, new_cache
