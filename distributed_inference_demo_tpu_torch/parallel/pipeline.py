"""Pipeline parallelism over rank processes: the circular pipeline's
decode (:func:`make_pipeline_generate_fn`), its loss
(:func:`pipeline_apply`) and the dp x pp x tp training step
(:func:`make_pipeline_train_step`).

Counterpart of ``distributed_inference_demo_tpu/parallel/pipeline.py``.
The reference runs one SPMD program under ``shard_map``: a ``lax.scan``
over ring steps, ``lax.ppermute`` as the hop, every rank executing the
same program with first / last roles as data selections.  Here ranks
are processes and rank 0 drives (``parallel/mesh.py``): each step is a
module-level command issued through :meth:`~.mesh.Mesh.spmd`, and every
rank runs it on its own shard, kept in ``mesh.objects`` with its
optimizer.  The layer stack is split over pp (its leading axis) and
within a stage over tp (``sharding.stage_param_spec_tree(pp_shard=True)``,
:func:`_pp_in_specs`).  The scan becomes a Python loop, the hop
:meth:`~.mesh.AxisGroup.rotate` (rank i -> i + 1).  Roles are chosen by
rank, not by masking: only the first rank embeds, only the last runs the
head and the loss, so S - 1 ranks do not pay for the ``[b, s, H] x
[H, V]`` product; a rank outside its microbatch window computes nothing
and passes on what it received.

Gradients: the sum/sum convention (``mesh.GradGroup``).  A tp
all-reduce's backward is an all-reduce, the vocab-parallel head's
all-gather's backward a reduce-scatter, and a ring hop's backward the
hop back.  Chosen over Megatron's f/g pair because the training forward
then stays the inference forward op for op (``models/decoder.py`` calls
the same ``tp.all_reduce``): f/g needs an identity with an all-reduced
backward at every column-parallel input, and a second one on the MoE
routing matrix, which each tp rank slices.  Under sum/sum every tp rank
backpropagates its own copy of the loss, so every raw gradient (a
tp-replicated leaf's once summed over tp) is tp times the single-device
gradient, and :func:`_train_step` divides by tp.  The reference divides
by pp * tp (``tools/grad_scale_probe.py``) because it also psums the
loss over pp, so each pp rank backpropagates a copy; here only the last
pp rank holds the loss and the hop back carries each gradient once, so
pp adds no factor.  A leaf replicated over pp (the embedding, the final
norm, an untied head) gets its gradient on the rank that uses it (the
embedding on the first, and with tied embeddings on the last too), and
:func:`_grad_sync_axes` sums it over pp, so replicas stay equal; dp
gradients and losses are means.  With ``sgd(1.0)`` every leaf's change
equals the single-device gradient (``tests/test_torch_pipeline.py``).

The backward runs as one ``torch.autograd.backward`` on every rank, its
roots the last rank's loss and, with a zero gradient, every tensor a hop
received, so each rank runs the backward of every hop it ran forward.
The hops are the only collectives between stages; autograd runs ready
nodes highest sequence number first, so every rank runs its hops'
backwards in reverse step order, in lockstep with its ring neighbours.
"""

from typing import Optional

import numpy as np
import torch

from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..ops.quant import QuantizedArray, QuantizedArray4
from .mesh import GradGroup
from .sharding import stage_param_spec_tree
from .tensor import ShardedParams, distribute_params, free_tp, validate_tp

_PARTS = ("layers", "embed", "final_norm", "lm_head")
# "not first, not last": the raw layer stack (roles are chosen by rank)
_SPEC_MID = StageSpec(stage_id=1, num_stages=3, layer_start=0, layer_end=0)


def _pp_in_specs(params: StageParams, cfg: ModelConfig, use_tp: bool
                 ) -> StageParams:
    """The pipeline's spec tree: the layer stack split over pp (leading
    axis) and tp (head / column axes); embed and norms replicated; an
    untied head vocab-column-sharded under tp (:func:`_head` gathers)."""
    return stage_param_spec_tree(params, cfg, pp_shard=True, use_tp=use_tp,
                                 vocab_parallel_embed=False)


def _grad_sync_axes(params: StageParams, cfg: ModelConfig, use_tp: bool
                    ) -> StageParams:
    """For each leaf, the axes (of pp, tp) its gradient is summed over:
    those it is replicated on.  A quantized leaf maps each of its
    fields.  dp is a mean, taken separately."""
    def axes_for(spec):
        return tuple(ax for ax in ("pp", "tp") if ax not in spec)

    def leaf(spec):
        if isinstance(spec, QuantizedArray):
            return QuantizedArray(q=axes_for(spec.q),
                                  scale=axes_for(spec.scale))
        if isinstance(spec, QuantizedArray4):
            return QuantizedArray4(q=axes_for(spec.q),
                                   scale=axes_for(spec.scale),
                                   group=spec.group)
        return axes_for(spec)

    specs = _pp_in_specs(params, cfg, use_tp)
    return StageParams(**{n: (None if getattr(specs, n) is None else
                              {k: leaf(v) for k, v in
                               getattr(specs, n).items()})
                          for n in _PARTS})


def trainable_leaves(params: StageParams) -> list:
    """``(part, key, tensor)`` of every float leaf that is not part of a
    quantized weight, parts in tree order and keys sorted: the order an
    optimizer is built over, so its state's indices name the same leaf
    in every tree of one model (``checkpoint.py`` relies on it)."""
    out = []
    for part in _PARTS:
        leaves = getattr(params, part) or {}
        for key in sorted(leaves):
            v = leaves[key]
            if torch.is_tensor(v) and torch.is_floating_point(v):
                out.append((part, key, v))
    return out


def _refuse_quantized(params: StageParams) -> None:
    """A train step differentiates every leaf, as the reference's
    ``jax.value_and_grad`` does, and a quantized weight's codes are
    integers: raise JAX's ``TypeError`` for them."""
    for part in _PARTS:
        leaves = getattr(params, part) or {}
        for key in sorted(leaves):
            v = leaves[key]
            dt = v.q.dtype if not torch.is_tensor(v) else v.dtype
            if not (dt.is_floating_point or dt.is_complex):
                name = str(dt).replace("torch.", "")
                raise TypeError(
                    "grad requires real- or complex-valued inputs (input "
                    "dtype that is a sub-dtype of np.inexact), but got "
                    f"{name}. If you want to use Boolean- or integer-valued"
                    " inputs, use vjp or set allow_int to True.")


def _embed(params: StageParams, cfg: ModelConfig,
           ids: torch.Tensor) -> torch.Tensor:
    """Token embedding through ``decoder.embed_tokens``, the one owner of
    the embedding pipeline (bloom's LayerNorm, gemma's sqrt(H) scale), so
    the pipeline cannot drift from single-stage serving."""
    from ..models.decoder import embed_tokens
    return embed_tokens(params, cfg, ids).to(cfg.dtype)


def _head(params: StageParams, cfg: ModelConfig, h: torch.Tensor,
          tp=None) -> torch.Tensor:
    """Final norm + LM head on [b, s, H]; gathers vocab-sharded logit
    shards under tp."""
    from ..ops.norms import layer_norm, rms_norm
    if cfg.attn_layernorm:
        h = layer_norm(h, params.final_norm["w"], params.final_norm["b"],
                       cfg.norm_eps)
    else:
        h = rms_norm(h, params.final_norm["w"], cfg.norm_eps)
    head = (params.embed["tokens"].T if cfg.tie_embeddings
            else params.lm_head["w"])
    logits = torch.einsum("bsh,hv->bsv", h, head)
    if tp is not None and logits.shape[-1] != cfg.vocab_size:
        logits = tp.all_gather(logits, dim=-1)
    return logits


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of the targets, in f32; ``-100``
    targets are padding."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.clamp_min(0)[..., None])[..., 0]
    return -torch.where(targets != -100, ll, torch.zeros_like(ll)).sum()


def pipeline_apply(cfg: ModelConfig, params: StageParams,
                   ids_mb: torch.Tensor, targets_mb: torch.Tensor,
                   tp=None, pp=None, backward: bool = False,
                   logits_out: Optional[list] = None) -> torch.Tensor:
    """Forward + mean cross-entropy through the circular pipeline, run by
    every rank of a command on its own shard (the reference's, inside
    ``shard_map``).

    ``ids_mb`` / ``targets_mb``: ``[M, b, s]`` microbatches (``-100``
    targets are padding).  ``M + S - 1`` ring steps: rank i works on
    microbatch ``t - i`` at step t, the first rank embeds, the last runs
    the head and sums the loss.  ``tp`` / ``pp``: this rank's groups
    (``tp`` a :class:`~.mesh.GradGroup` to train through it).  Returns
    the loss, the same on every rank of ``pp``, detached.  With
    ``backward`` it also backpropagates (see the module docstring),
    leaving in each leaf's ``.grad`` the gradient of this rank's own use
    of it.  ``logits_out``: a list the last rank appends each
    microbatch's ``[b, s, V]`` logits to, detached."""
    S = pp.size if pp is not None else 1
    me = pp.rank if pp is not None else 0
    first, last = me == 0, me == S - 1
    hop = GradGroup(pp) if pp is not None else None
    M, b, s = ids_mb.shape
    T = M + S - 1
    dev = ids_mb.device
    positions = torch.arange(s, device=dev).expand(b, s)
    layers = StageParams(layers=params.layers)
    from ..models.decoder import stage_forward

    ntok = int((targets_mb != -100).sum())
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    received = []
    with torch.set_grad_enabled(backward):
        recv = None
        if S > 1:
            recv = torch.zeros((b, s, cfg.hidden_size), dtype=cfg.dtype,
                               device=dev, requires_grad=backward)
        for t in range(T):
            m = t - me
            if 0 <= m < M:
                x = _embed(params, cfg, ids_mb[m]) if first else recv
                h, _ = stage_forward(layers, cfg, _SPEC_MID, x, None,
                                     positions, tp=tp)
                if last:
                    logits = _head(params, cfg, h, tp)
                    loss_sum = loss_sum + _nll_sum(logits, targets_mb[m])
                    if logits_out is not None:
                        logits_out.append(logits.detach())
            else:
                h = recv
            if S > 1 and t < T - 1:      # nobody takes the last step's
                recv = hop.rotate(h)
                received.append(recv)
        loss = loss_sum / max(ntok, 1)
    if backward:
        roots = ([loss] if last else []) + received
        grads = ([torch.ones_like(loss)] if last else []) + [
            torch.zeros_like(r) for r in received]
        if roots:
            torch.autograd.backward(roots, grads)
    loss = loss.detach()
    if pp is not None:
        loss = pp.all_reduce(loss if last else torch.zeros_like(loss))
    return loss


# ---------------------------------------------------------------------------
# the rank state: shards and optimizers in mesh.objects
# ---------------------------------------------------------------------------

def distribute_pipeline_params(params: StageParams, cfg: ModelConfig,
                               mesh) -> ShardedParams:
    """Send every rank its pp x tp slice of the full tree ``params``
    (replicated over dp); returns rank 0's (:class:`~.tensor.
    ShardedParams`).  The layer count must divide by pp."""
    specs = _pp_in_specs(params, cfg, mesh.shape.get("tp", 1) > 1)
    return distribute_params(params, cfg, mesh, specs)


def _init_train(mesh, params_h: int, opt_h: int, optimizer, state,
                specs) -> None:
    """Command: every rank makes its float leaves trainable (rank 0's a
    copy, since its slices are views of the caller's tree), builds
    ``optimizer`` over them (:func:`trainable_leaves`' order) and, given
    a full tree's optimizer ``state`` (a ``state_dict()``), loads its
    slice of it."""
    params = mesh.objects[params_h]
    for part, key, v in trainable_leaves(params):
        if mesh.rank == 0:
            v = v.detach().clone()
        getattr(params, part)[key] = v.requires_grad_(True)
    params._layer_views = None
    leaves = trainable_leaves(params)
    opt = optimizer([v for _, _, v in leaves])
    if state is not None:
        from .sharding import slice_leaf
        sliced = {}
        for i, st in state["state"].items():
            part, key, v = leaves[int(i)]
            spec = getattr(specs, part)[key]
            sliced[int(i)] = {
                n: (slice_leaf(x, spec, mesh.coords, mesh.shape)
                    if torch.is_tensor(x) and x.ndim == v.ndim else x)
                for n, x in st.items()}
        opt.load_state_dict({"state": sliced,
                             "param_groups": state["param_groups"]})
    mesh.objects[opt_h] = opt


def _gather_leaves(mesh, params_h: int, names):
    """Command: this rank's slices of the leaves ``names`` (``(part,
    key)``), gathered at rank 0."""
    params = mesh.objects[params_h]
    return mesh.gather({f"{p}/{k}": getattr(params, p)[k].detach()
                        for p, k in names})


def gather_pipeline_params(params: ShardedParams, cfg: ModelConfig,
                           names=None) -> dict:
    """The full tensors of a pipeline-sharded tree's leaves, assembled on
    rank 0 (on the host) from every rank's slice: ``{(part, key):
    tensor}`` for ``names`` (default every float leaf).  For checks and
    checkpoints."""
    from .sharding import rank_coords
    mesh = params.mesh
    specs = _pp_in_specs(params, cfg, mesh.shape.get("tp", 1) > 1)
    names = list(names or [(p, k) for p, k, _ in trainable_leaves(params)])
    shards = mesh.spmd(_gather_leaves, params.handle, names)
    out = {}
    for part, key in names:
        spec = getattr(specs, part)[key]
        local = shards[0][f"{part}/{key}"]
        shape = [n * (mesh.shape.get(a, 1) if a is not None else 1)
                 for n, a in zip(local.shape, spec + (None,) * local.ndim)]
        full = torch.empty(shape, dtype=local.dtype)
        for r, got in enumerate(shards):
            c = rank_coords(mesh.shape, r)
            idx = tuple(slice(c[a] * n, (c[a] + 1) * n) if a else slice(None)
                        for n, a in zip(local.shape,
                                        spec + (None,) * local.ndim))
            full[idx] = got[f"{part}/{key}"]
        out[(part, key)] = full
    return out


def _apply(mesh, params_h: int, cfg: ModelConfig, ids_mb: torch.Tensor,
           targets_mb: torch.Tensor, return_logits: bool):
    """Command: :func:`pipeline_apply`'s forward on every rank; with
    ``return_logits`` also the last rank's logits, gathered at rank 0."""
    logits = [] if return_logits else None
    loss = pipeline_apply(cfg, mesh.objects[params_h],
                          ids_mb.to(mesh.device), targets_mb.to(mesh.device),
                          tp=mesh.group("tp"), pp=mesh.group("pp"),
                          logits_out=logits)
    if not return_logits:
        return loss
    got = mesh.gather(torch.stack(logits) if logits else None)
    if got is None:                      # a follower
        return None
    return loss, next(x for x in got if x is not None)


def pipeline_loss(params, cfg: ModelConfig, mesh, ids_mb, targets_mb,
                  return_logits: bool = False):
    """Rank 0: the pipeline's mean cross-entropy over ``[M, b, s]``
    microbatches, forward only (every dp replica runs the whole batch).
    ``params``: a full tree (copied out for the call) or
    :func:`distribute_pipeline_params`' result.  A quantized tree runs
    through ``ops.quant.dense``: on the card, the dense kernel.  With
    ``return_logits``: ``(loss, logits)``, the logits ``[M, b, s, V]``
    of the last pp rank, on the host (for checks)."""
    own = not (isinstance(params, ShardedParams) and params.mesh is mesh)
    if own:
        params = distribute_pipeline_params(params, cfg, mesh)
    try:
        return mesh.spmd(_apply, params.handle, cfg,
                         torch.as_tensor(ids_mb), torch.as_tensor(targets_mb),
                         return_logits)
    finally:
        if own:
            free_tp(mesh, params)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _sync_grads(mesh, params: StageParams, sync: StageParams) -> None:
    """Each trainable leaf's gradient summed over the axes ``sync``
    names (an unused leaf's as zeros), divided by tp (the sum/sum
    factor, module docstring), then averaged over dp."""
    tp = mesh.shape.get("tp", 1)
    dp = mesh.group("dp")
    for part, key, v in trainable_leaves(params):
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        for axis in getattr(sync, part)[key]:
            group = mesh.group(axis)
            if group is not None:
                g = group.all_reduce(g)
        if tp > 1:
            g = g / tp
        if dp is not None:
            g = dp.all_reduce(g) / dp.size
        v.grad = g


def _train_step(mesh, params_h: int, opt_h: int, cfg: ModelConfig,
                sync: StageParams, num_microbatches: int,
                ids: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Command: one step on every rank: its dp slice of each microbatch
    through the pipeline, forward and backward, the gradient sync, the
    optimizer.  Returns the loss (the mean over dp)."""
    params, opt = mesh.objects[params_h], mesh.objects[opt_h]
    M = num_microbatches
    B, s = ids.shape
    ids_mb = ids.to(mesh.device).reshape(M, B // M, s)
    targets_mb = targets.to(mesh.device).reshape(M, B // M, s)
    dp = mesh.group("dp")
    if dp is not None:
        b = B // M // dp.size
        lo = dp.rank * b
        ids_mb, targets_mb = ids_mb[:, lo:lo + b], targets_mb[:, lo:lo + b]
    tp = mesh.group("tp")
    opt.zero_grad(set_to_none=True)
    loss = pipeline_apply(cfg, params, ids_mb, targets_mb,
                          tp=GradGroup(tp) if tp is not None else None,
                          pp=mesh.group("pp"), backward=True)
    _sync_grads(mesh, params, sync)
    opt.step()
    if dp is not None:
        loss = dp.all_reduce(loss.clone()) / dp.size
    return loss


def make_pipeline_train_step(cfg: ModelConfig, mesh, optimizer,
                             num_microbatches: int):
    """The dp x pp x tp training step over ``mesh``.

    ``optimizer`` is a factory over a list of tensors, for example
    ``functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)``
    (optax's ``adamw`` decays by 1e-4 by default, torch's by 1e-2; pass
    it); each rank applies one to its own shard, in the parameters'
    dtype.  Returns ``train_step(params, opt_state, ids, targets) ->
    (params, opt_state, loss)``: ``ids`` / ``targets`` ``[batch, seq]``,
    the batch divisible by ``num_microbatches`` x dp.  ``params``: a full
    tree, which the first step copies out to the ranks, or the
    :class:`~.tensor.ShardedParams` a step returned, updated in place
    (``tensor.free_tp(mesh, params, opt_state)`` drops both on every
    rank).
    ``opt_state``: None (a fresh optimizer on every rank), the optimizer
    a step returned (rank 0's, registered on the mesh), or any other
    optimizer over a full tree (a restored checkpoint's: each rank loads
    its slice of its ``state_dict()``).  The loss is a 0-d f32 tensor on
    rank 0.  A quantized tree raises the reference's ``TypeError``."""
    use_tp = validate_tp(cfg, mesh) > 1
    M = num_microbatches

    def train_step(params, opt_state, ids, targets):
        B = ids.shape[0]
        if B % M or (B // M) % mesh.shape.get("dp", 1):
            raise ValueError(f"batch {B} does not divide into {M} "
                             f"microbatches x dp={mesh.shape.get('dp', 1)}")
        specs = _pp_in_specs(params, cfg, use_tp)
        if not (isinstance(params, ShardedParams) and params.mesh is mesh):
            _refuse_quantized(params)
            params = distribute_pipeline_params(params, cfg, mesh)
            opt_h = None
        else:
            opt_h = (mesh.handle_of(opt_state) if opt_state is not None
                     else None)
        if opt_h is None:
            state = opt_state.state_dict() if opt_state is not None else None
            opt_h = mesh.new_handle()
            mesh.spmd(_init_train, params.handle, opt_h, optimizer, state,
                      specs)
            opt_state = mesh.objects[opt_h]
            mesh.register(opt_state, opt_h)
            params = ShardedParams(mesh.objects[params.handle], mesh,
                                   params.handle)
        loss = mesh.spmd(_train_step, params.handle, opt_h, cfg,
                         _grad_sync_axes(params, cfg, use_tp), M,
                         torch.as_tensor(ids), torch.as_tensor(targets))
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# the circular decode
# ---------------------------------------------------------------------------

def _generator(device, seed: int, m: int, k: int) -> torch.Generator:
    """The draw of microbatch ``m``'s token ``k``: its own generator,
    seeded from (seed, m, k), so a seed gives the same tokens whatever
    the ring's schedule."""
    mixed = np.random.SeedSequence([seed, m, k]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _generate(mesh, params_h: int, cfg: ModelConfig, max_seq: int,
              num_new: int, sampling, ids_mb: torch.Tensor, seed: int):
    """Command: the circular decode on every rank (see
    :func:`make_pipeline_generate_fn`); the tokens at rank 0."""
    from ..models.base import pad_cache_capacity
    from ..models.decoder import stage_forward
    from ..ops.sampling import sample_logits

    params = mesh.objects[params_h]
    pp, tp = mesh.group("pp"), mesh.group("tp")
    S, me = pp.size, pp.rank
    first, last = me == 0, me == S - 1
    M, b, plen = ids_mb.shape
    N, H, dt, dev = num_new, cfg.hidden_size, cfg.dtype, mesh.device
    ids_mb = ids_mb.to(dev)
    layers = StageParams(layers=params.layers)
    nkv = params.layers["wk"].shape[-1] // cfg.head_dim
    L = next(iter(params.layers.values())).shape[0]
    cshape = (M, L, b, nkv, pad_cache_capacity(max_seq), cfg.head_dim)
    K = torch.zeros(cshape, dtype=dt, device=dev)
    V = torch.zeros(cshape, dtype=dt, device=dev)

    def run(x, m, length, positions):
        h, _ = stage_forward(layers, cfg, _SPEC_MID, x,
                             KVCache(K[m], V[m], length), positions, tp=tp)
        return h

    def tail(h_row, m, k):
        logits = _head(params, cfg, h_row, tp)[:, 0]
        return sample_logits(logits, _generator(dev, seed, m, k),
                             sampling).to(torch.int32)

    with torch.no_grad():
        # prefill: M + S - 1 ring steps over the prompt chunks
        pos = torch.arange(plen, device=dev).expand(b, plen)
        tok0 = torch.full((M, b), -1, dtype=torch.int32, device=dev)
        recv = torch.zeros((b, plen, H), dtype=dt, device=dev)
        T = M + S - 1
        for t in range(T):
            m = t - me
            h = recv
            if 0 <= m < M:
                x = _embed(params, cfg, ids_mb[m]) if first else recv
                h = run(x, m, 0, pos)
                if last:
                    tok0[m] = tail(h[:, -1:], m, 0)
            if t < T - 1:
                recv = pp.rotate(h)
        # the first rank embeds every microbatch's first sampled token
        tok0 = pp.all_reduce(tok0, op="max")

        out = torch.zeros((M, b, N), dtype=torch.int32, device=dev)
        if last:
            out[:, :, 0] = tok0
        lengths = [plen] * M
        tok_buf = tok0.clone()
        # decode: S - 1 + (N - 1) * M ring steps; at step g rank i works
        # on microbatch (g - i) mod M, pass (g - i) // M, and the token
        # the tail samples rides the lane back to the first rank
        G = S - 1 + (N - 1) * M if N > 1 else 0
        recv_h = torch.zeros((b, 1, H), dtype=dt, device=dev)
        recv_tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        for g in range(G):
            m, k = (g - me) % M, (g - me) // M
            if first and g >= S:
                # the lane is one hop behind the tail
                tok_buf[(g - S) % M] = recv_tok
            h, tok_next = recv_h, recv_tok
            if g >= me and k < N - 1:
                length = lengths[m]
                x = (_embed(params, cfg, tok_buf[m][:, None].long())
                     if first else recv_h)
                h = run(x, m, length,
                        torch.full((b, 1), length, device=dev))
                lengths[m] = length + 1
                if last:
                    tok_next = tail(h, m, k + 1)
                    out[m, :, k + 1] = tok_next
            if g < G - 1:
                recv_h = pp.rotate(h)
                recv_tok = pp.rotate(tok_next)
        # only the last rank holds the tokens; share them
        out = pp.all_reduce(out if last else torch.zeros_like(out))
    return out


def make_pipeline_generate_fn(cfg: ModelConfig, mesh, *, max_seq: int,
                              num_new_tokens: int, sampling=None):
    """The circular pipeline's decode over a mesh with pp >= 2 (the
    reference's socket token ring as one command a token step).

    Microbatches circulate the pp ring round-robin: at ring step g, rank
    i works on microbatch ``(g - i) mod M``; every hop carries the hidden
    row and a token lane (the sampled token riding last -> first); each
    rank keeps a per-microbatch cache of its layer range.  The pipeline
    is full whenever M >= S.  Composes with tp (Megatron slices within
    each stage).

    Returns ``fn(params, ids_mb, seed=0) -> tokens``: ``params`` a full
    tree (copied out to the ranks for the call) or
    :func:`distribute_pipeline_params`' result; ``ids_mb`` ``[M, b,
    prompt_len]`` (equal-length prompts); ``tokens`` ``[M, b,
    num_new_tokens]`` int32 on rank 0.  Greedy tokens are exact; a
    sampled token draws from a ``torch.Generator`` seeded per (seed,
    microbatch, step)."""
    from ..ops.sampling import SamplingParams

    sampling = sampling or SamplingParams(greedy=True)
    S = mesh.shape.get("pp", 1)
    if S < 2:
        raise ValueError("pipeline generate needs pp >= 2 (use the "
                         "engine for a single stage)")
    validate_tp(cfg, mesh)

    def fn(params, ids_mb, seed: int = 0):
        ids_mb = torch.as_tensor(ids_mb)
        M = ids_mb.shape[0]
        if M < S:
            raise ValueError(f"need microbatches M={M} >= stages S={S} "
                             "for a full pipeline")
        own = not (isinstance(params, ShardedParams) and params.mesh is mesh)
        if own:
            params = distribute_pipeline_params(params, cfg, mesh)
        try:
            return mesh.spmd(_generate, params.handle, cfg, max_seq,
                             num_new_tokens, sampling, ids_mb, int(seed))
        finally:
            if own:
                free_tp(mesh, params)

    return fn


__all__ = ["distribute_pipeline_params", "gather_pipeline_params", "make_pipeline_generate_fn",
           "make_pipeline_train_step", "pipeline_apply", "pipeline_loss",
           "trainable_leaves"]
