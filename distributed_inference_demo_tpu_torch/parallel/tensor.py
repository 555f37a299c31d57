"""Tensor-parallel stage execution (Megatron layout over the ``tp`` axis).

Counterpart of ``distributed_inference_demo_tpu/parallel/tensor.py``.
BASELINE.json config #3: Llama-3-8B tensor-parallel, attention heads
sharded across devices.  The reference runs ``stage_forward`` inside
``jax.shard_map``; here every rank of a :class:`~.mesh.Mesh` runs it on
its own slice (``parallel/sharding.py``) with the tp group's
collectives (``models/decoder.py``, ``tp=``), and rank 0 drives.

The seams (:func:`make_forward_seam`, :func:`make_paged_forward_seam`,
:func:`make_tp_forward`) keep the reference's signatures: an engine
calls ``fwd(params, inputs, cache, positions, last_logits_only)`` and
gets replicated logits back, mesh-oblivious.  Under a tp mesh that call
is one :meth:`~.mesh.Mesh.spmd` command: rank 0 sends a header (the
seam, the params and cache handles, the flags) with the replicated
inputs (ids, positions, the cache start, the block tables), and every
rank runs the forward on its shard.

The commands rank 0 issues on a tp mesh, each a function of this module
run on every rank (followers mirror rank 0's device state through
nothing else):

- :func:`_load_params`: a weight shard, sent by rank 0 to each follower;
- :func:`_make_seam`: a rank's attention hook for its local head counts
  (the flash kernel hook, plain attention, or the paged kernels' hook);
- :func:`_alloc_kv`: a rank's kv-head plane of a dense cache or of a
  page pool (``[..., nkv / tp, ...]``, quantized sidecars with their
  pages);
- :func:`_forward`: one forward, its cache plane written in place;
- :func:`_kv_seed` / :func:`_kv_store`: the prefix pool's gather into a
  working cache and scatter out of it (``InferenceEngine`` with
  ``kv_cache_blocks``);
- :func:`_gather_pages` / :func:`_scatter_pages`: blocks of a page
  pool out of every rank's plane, joined over the kv-head axis at rank
  0, and global blocks split back into each rank's heads (the tier's
  demotions and promotions, a request's export and import, a
  premigrated join);
- :func:`_row_to_pages`: a dense row's blocks into every rank's pages
  (the batching draft's admission prefill);
- :func:`_free`: drop a handle (an engine's close);
- :func:`_fetch`: every rank's copy of an object at rank 0 (checks).

A cache or pool is addressed by the handle of its keys / values object.
Anything rank 0 did to its own plane without one of these commands would
leave the followers' planes stale, so the engines touch a tp cache only
through them.  An owner hands its pool's :class:`TPPoolOps` to
``runtime/kvcache/device.py``'s block export, adopt and row write,
which then run the commands above, so the tier and the fleet move a tp
pool's pages with the code they use at tp=1.  Blocks leave and enter in
the tp=1 layout (``[n, L, H, bt, D]``, every kv head), so a tier entry,
an export or a premigrated block is the same bytes at any tp.
"""

from typing import Optional

import torch

from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..models.decoder import stage_forward
from .sharding import shard_tree, stage_param_spec_tree

# head-major cache [layers, batch, nkv, seq, hd] and page pool
# [layers, pages, nkv, bt, hd]: both shard the kv-head axis (axis 2); a
# quantized pool's sidecars keep the same axis order and shard with it
_CACHE_SPEC = KVCache(keys=(None, None, "tp", None, None),
                      values=(None, None, "tp", None, None),
                      length=())


def tp_cache_sharding(mesh) -> KVCache:
    """The cache's spec on a tp mesh (kv-head-sharded): what each rank
    holds of a cache or a page pool."""
    return _CACHE_SPEC


def tp_size(mesh) -> int:
    return dict(mesh.shape).get("tp", 1) if mesh is not None else 1


def validate_tp(cfg: ModelConfig, mesh) -> int:
    """Check the config can shard over the mesh's tp axis; returns tp."""
    tp = tp_size(mesh)
    if tp > 1 and cfg.num_kv_heads % tp:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} not divisible by tp={tp}")
    return tp


def resolve_tp_attn_backend(tp: int, attn_backend: str) -> str:
    """The one rule for attention backends under a tp mesh.  The port's
    kernels run per shard at the rank's head counts (the reference forces
    its jnp path instead), so the engines' own backends pass unchanged;
    a backend the port does not know is refused."""
    if tp > 1 and attn_backend not in ("auto", "flash", "plain", "cuda"):
        raise ValueError(
            f"attn_backend={attn_backend!r} is incompatible with a tp "
            "mesh; use 'auto', 'flash' or 'plain'")
    return attn_backend


def check_graph_under_mesh(mesh, cuda_graph: bool, device) -> None:
    """A multi-rank step runs eagerly: a gloo collective cannot be
    captured, and a captured step would need every follower to replay
    its own graph in lockstep.  ``cuda_graph=True`` on the card raises
    under such a mesh."""
    if (mesh is not None and mesh.world > 1 and cuda_graph
            and torch.device(device).type == "cuda"):
        raise ValueError(
            f"cuda_graph=True cannot run over a {mesh.world}-rank "
            f"{mesh.backend} mesh (a gloo collective cannot be captured); "
            "pass cuda_graph=False")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

class ShardedParams(StageParams):
    """Rank 0's slice of a tp-sharded tree, with the mesh and the handle
    under which every rank keeps its own slice."""

    def __init__(self, local: StageParams, mesh, handle: int):
        super().__init__(layers=local.layers, embed=local.embed,
                         final_norm=local.final_norm, lm_head=local.lm_head)
        self.mesh = mesh
        self.handle = handle


def _leaves(params: StageParams) -> list:
    """Every tensor of a tree in a fixed order (quantized leaves as their
    codes then their scales)."""
    out = []
    for part in (params.layers, params.embed, params.final_norm,
                 params.lm_head):
        for v in (part or {}).values():
            if torch.is_tensor(v):
                out.append(v)
            else:
                out.extend([v.q, v.scale])
    return out


_PARTS = ("layers", "embed", "final_norm", "lm_head")


def _structure(params: StageParams) -> dict:
    """A tree's shape without its tensors: per part, per key, "t" for a
    tensor, "q8" for an int8 leaf, ("q4", group) for an int4 leaf."""
    def kind(v):
        if torch.is_tensor(v):
            return "t"
        return ("q4", v.group) if hasattr(v, "group") else "q8"
    return {n: (None if getattr(params, n) is None else
                {k: kind(v) for k, v in getattr(params, n).items()})
            for n in _PARTS}


def _refill(structure: dict, tensors: list) -> StageParams:
    """A tree of ``structure`` over ``tensors`` (:func:`_leaves`' order)."""
    from ..ops.quant import QuantizedArray, QuantizedArray4
    it = iter(tensors)

    def leaf(kind):
        if kind == "t":
            return next(it)
        if kind == "q8":
            return QuantizedArray(q=next(it), scale=next(it))
        return QuantizedArray4(q=next(it), scale=next(it), group=kind[1])

    return StageParams(**{
        n: (None if part is None else {k: leaf(v) for k, v in part.items()})
        for n, part in structure.items()})


def _load_params(mesh, src: int, handle: int, layout) -> None:
    """Command: rank 0 sends each follower its slice of the tree it
    parked under ``src``, leaf by leaf through host memory; each rank
    keeps its slice under ``handle``."""
    template, shapes = layout
    if mesh.rank == 0:
        from .sharding import rank_coords
        full, specs = mesh.objects.pop(src)
        for r in range(1, mesh.world):
            part = shard_tree(full, specs, rank_coords(mesh.shape, r),
                              mesh.shape)
            for t in _leaves(part):
                mesh.send(t, r)
        local = shard_tree(full, specs, mesh.coords, mesh.shape,
                           copy=lambda x: x.contiguous())
        mesh.objects[handle] = local
        return
    got = [mesh.recv(shape, dtype, 0) for shape, dtype in shapes]
    mesh.objects[handle] = _refill(template, got)


def distribute_params(params: StageParams, cfg: ModelConfig, mesh,
                      specs: Optional[StageParams] = None
                      ) -> ShardedParams:
    """Send every rank its slice of the full tree ``params`` (rank 0's
    device) by ``specs`` (default: the engines' tp layout, replicated
    embed, vocab-parallel head); return rank 0's slice."""
    if specs is None:
        specs = stage_param_spec_tree(params, cfg, vocab_parallel_embed=False)
    local = shard_tree(params, specs, mesh.coords, mesh.shape)
    template = _structure(local)
    shapes = [(tuple(t.shape), t.dtype) for t in _leaves(local)]
    src, handle = mesh.new_handle(), mesh.new_handle()
    mesh.objects[src] = (params, specs)
    mesh.spmd(_load_params, src, handle, (template, shapes))
    return ShardedParams(mesh.objects[handle], mesh, handle)


# ---------------------------------------------------------------------------
# caches and page pools
# ---------------------------------------------------------------------------

def _alloc_kv(mesh, handles, kind: str, shape, dtype, kv_dtype) -> None:
    """Command: a rank's planes (keys, values) of a dense cache
    (``kind`` "dense", zeros of ``dtype``) or a page pool ("pages",
    ``ops.quant.alloc_kv_pages``), ``shape`` already per rank."""
    from ..ops.quant import alloc_kv_pages
    for h in handles:
        if kind == "dense":
            obj = torch.zeros(shape, dtype=dtype, device=mesh.device)
        else:
            obj = alloc_kv_pages(shape, kv_dtype, dtype, mesh.device)
        mesh.objects[h] = obj


def _local_heads(shape, mesh) -> tuple:
    shape = list(shape)
    shape[2] //= tp_size(mesh)
    return tuple(shape)


def alloc_tp_kv(mesh, kind: str, shape, dtype, kv_dtype=None):
    """Every rank's kv-head plane of a cache (``kind`` "dense") or page
    pool ("pages") whose global shape is ``shape`` (kv heads on axis
    2); returns rank 0's (keys, values), registered under handles."""
    return alloc_mesh_kv(mesh, kind, _local_heads(shape, mesh), dtype,
                         kv_dtype)


def alloc_mesh_kv(mesh, kind: str, local_shape, dtype, kv_dtype=None):
    """Keys and values of ``local_shape`` on every rank (see
    :func:`_alloc_kv`); returns rank 0's, registered under handles."""
    handles = (mesh.new_handle(), mesh.new_handle())
    mesh.spmd(_alloc_kv, handles, kind, tuple(local_shape), dtype,
              kv_dtype)
    k, v = (mesh.objects[h] for h in handles)
    for obj, h in ((k, handles[0]), (v, handles[1])):
        mesh.register(obj, h)
    return k, v


def _free(mesh, handles) -> None:
    """Command: drop objects from every rank's table."""
    for h in handles:
        mesh.unregister(mesh.objects.pop(h, None))


def free_tp(mesh, *objs) -> None:
    """Drop the handles of rank 0's ``objs`` (tensors, pools, params, a
    forward of :func:`make_tp_forward`) on every rank."""
    hs = [getattr(o, "handle", None) or mesh.handle_of(o) for o in objs]
    hs = [h for h in hs if h is not None]
    if hs and not mesh.closed:
        mesh.spmd(_free, hs)


def _fetch(mesh, handle):
    """Command: every rank's object under ``handle`` at rank 0."""
    return mesh.gather(mesh.objects.get(handle))


def fetch_tp(mesh, obj) -> list:
    """Every rank's copy of rank 0's ``obj`` (a cache or pool plane), on
    the host, in rank order: for checks."""
    return mesh.spmd(_fetch, mesh.handle_of(obj))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

class _Seam:
    """A rank's forward program: its attention hook for its local heads
    and, for a paged seam, the hook's table binder."""

    def __init__(self, cfg, spec, attn):
        self.cfg, self.spec = cfg, spec
        self.bind = None
        if attn[0] == "paged":
            from ..ops.paged_attention import make_paged_attn_impl
            _, bt, backend, num_pages, head_dim, device_type, launches = attn
            self.impl, self.bind = make_paged_attn_impl(
                bt, backend, num_pages=num_pages, head_dim=head_dim,
                device_type=device_type, launches=launches)
        elif attn[1] == "flash":
            from ..ops.flash_attention import make_flash_attn_impl
            self.impl = make_flash_attn_impl()
        elif attn[1] == "slot":
            from ..ops.attention import slot_attention_impl
            self.impl = slot_attention_impl
        else:
            self.impl = None


def _make_seam(mesh, handle: int, cfg, spec, attn) -> None:
    """Command: build a rank's forward program under ``handle``."""
    mesh.objects[handle] = _Seam(cfg, spec, attn)


def _forward(mesh, seam_h, params_h, keys_h, values_h, inputs, positions,
             start, last_logits_only, tables):
    """Command: one forward on every rank's shard and cache plane; the
    logits come back replicated (rank 0 keeps them)."""
    seam = mesh.objects[seam_h]
    if seam.bind is not None:
        seam.bind(tables)
    cache = KVCache(mesh.objects[keys_h], mesh.objects[values_h], start)
    return stage_forward(mesh.objects[params_h], seam.cfg, seam.spec,
                         inputs, cache, positions, attn_impl=seam.impl,
                         last_logits_only=last_logits_only,
                         tp=mesh.group("tp"))


def make_tp_forward(cfg: ModelConfig, spec: StageSpec, mesh,
                    params_template: StageParams, attn=("dense", "plain")):
    """``(fwd, bind)``: ``fwd(params, inputs, cache, positions,
    last_logits_only)`` running ``stage_forward`` on every rank of a tp
    mesh, the seam every engine builds on.  ``params`` are the
    :class:`ShardedParams` of :func:`distribute_params`; the cache's
    keys / values are tp planes (:func:`alloc_tp_kv`).  Inputs,
    positions and logits are replicated.  ``attn`` describes the hook
    each rank builds for its own heads: ``("dense", "flash" | "plain")``
    or ``("paged", block_tokens, backend, num_pages, head_dim,
    device_type, launches)`` (``launches``: a dict rank 0's hook counts
    its own launches in; each follower counts into its copy); ``bind(
    tables)`` hands a paged seam the dispatch's block tables (None for a
    dense seam)."""
    validate_tp(cfg, mesh)
    handle = mesh.new_handle()
    mesh.spmd(_make_seam, handle, cfg, spec, attn)
    bound = {"tables": None}

    def bind(tables):
        bound["tables"] = tables

    def fwd(p, inputs, cache, positions, last_logits_only):
        start = cache.length
        logits, _ = mesh.spmd(
            _forward, handle, p.handle, mesh.handle_of(cache.keys),
            mesh.handle_of(cache.values), inputs, positions, start,
            last_logits_only, bound["tables"])
        return logits, KVCache(cache.keys, cache.values,
                               start + inputs.shape[1])

    fwd.handle = handle          # free_tp(mesh, fwd) drops every rank's hook
    return fwd, (bind if attn[0] == "paged" else None)


def make_forward_seam(cfg: ModelConfig, spec: StageSpec, mesh,
                      params_template: StageParams, attn_impl=None,
                      attn_backend: str = "plain"):
    """(fwd, cache_sharding) for an engine: the tp seam when ``mesh`` has
    a tp axis > 1 (each rank builds its own ``attn_backend`` hook, since
    a hook is rank-local: "flash", "plain", or "slot", the batching
    draft's admission row), else a plain ``stage_forward`` closure over
    ``attn_impl`` with ``cache_sharding=None``."""
    if tp_size(mesh) > 1:
        fwd, _ = make_tp_forward(cfg, spec, mesh, params_template,
                                 attn=("dense", attn_backend))
        return fwd, tp_cache_sharding(mesh)

    def fwd(p, inputs, cache, positions, last_logits_only):
        return stage_forward(p, cfg, spec, inputs, cache, positions,
                             attn_impl=attn_impl,
                             last_logits_only=last_logits_only)

    return fwd, None


def make_paged_forward_seam(cfg: ModelConfig, spec: StageSpec, mesh,
                            params_template: StageParams,
                            block_tokens: int, backend: str = "auto",
                            num_pages=None, device_type: str = "cpu",
                            launches=None):
    """``(fwd, bind, pool_sharding)`` for a PAGED-cache engine: the
    forward runs ``ops.paged_attention``'s block-table hook over a page
    pool ``[L, N + 1, H, bt, D]`` standing in for the dense cache
    buffers (page N is the drop page, see ``write_paged_kv``).

    ``bind(tables)`` hands the current dispatch's device block tables to
    the hook; call it before the first ``fwd`` of a dispatch.  Under a
    tp mesh every rank runs the hook (the paged kernels on the card) on
    its kv-head plane of the pool, the tables go out with the forward's
    inputs, and ``pool_sharding`` is the kv-head spec; off-mesh it is
    None.  ``num_pages``, ``backend``, ``device_type`` and ``launches``
    (the hook's own launch counts; under tp rank 0's) go to
    :func:`~..ops.paged_attention.make_paged_attn_impl`."""
    from ..ops.paged_attention import make_paged_attn_impl
    if tp_size(mesh) > 1:
        fwd, bind = make_tp_forward(
            cfg, spec, mesh, params_template,
            attn=("paged", block_tokens, backend, num_pages, cfg.head_dim,
                  device_type, launches))
        return fwd, bind, tp_cache_sharding(mesh)
    impl, bind = make_paged_attn_impl(block_tokens, backend,
                                      num_pages=num_pages,
                                      head_dim=cfg.head_dim,
                                      device_type=device_type,
                                      launches=launches)

    def fwd(p, inputs, cache, positions, last_logits_only):
        return stage_forward(p, cfg, spec, inputs, cache, positions,
                             attn_impl=impl,
                             last_logits_only=last_logits_only)

    return fwd, bind, None


def make_tp_stage_fn(cfg: ModelConfig, spec: StageSpec, mesh,
                     params_template: StageParams):
    """``fn(params, inputs, cache, positions) -> (out, cache)`` with the
    stage's weights and KV cache sharded over ``tp`` (the all-positions
    logits variant of :func:`make_tp_forward`).  ``params`` come from
    :func:`distribute_params` and the cache from :func:`new_tp_cache`.
    Requires ``cfg.num_kv_heads % tp == 0``; logits come back
    replicated."""
    fwd, _ = make_tp_forward(cfg, spec, mesh, params_template)

    def fn(params, inputs, cache, positions):
        return fwd(params, inputs, cache, positions, False)

    return fn


def new_tp_cache(cfg: ModelConfig, mesh, num_layers: int, batch: int,
                 max_seq: int, dtype=None) -> KVCache:
    """A dense cache sharded by kv head over the tp mesh (rank 0's plane
    returned; the reference's ``KVCache.create`` + ``tp_cache_sharding``)."""
    from ..models.base import pad_cache_capacity
    shape = (num_layers, batch, cfg.num_kv_heads,
             pad_cache_capacity(max_seq), cfg.head_dim)
    k, v = alloc_tp_kv(mesh, "dense", shape, dtype or cfg.dtype)
    return KVCache(k, v, 0)


# ---------------------------------------------------------------------------
# the prefix pool's device ops (InferenceEngine with kv_cache_blocks)
# ---------------------------------------------------------------------------

def _kv_seed(mesh, ck, cv, pk, pv, block_ids) -> None:
    """Command: gather pool pages into every rank's working cache."""
    from ..runtime.kvcache.device import seed_cache_from_pages
    o = mesh.objects
    seed_cache_from_pages(o[ck], o[cv], o[pk], o[pv], block_ids)


def _kv_store(mesh, pk, pv, ck, cv, block_ids, covered) -> None:
    """Command: scatter every rank's cache blocks into pool pages."""
    from ..runtime.kvcache.device import store_cache_to_pages
    o = mesh.objects
    store_cache_to_pages(o[pk], o[pv], o[ck], o[cv], block_ids, covered)


class TPPoolOps:
    """A page pool's device ops as commands on a tp mesh, its owner's
    ``ops`` (``runtime/kvcache/backend.PagedKVBackend``'s
    ``device_ops``): allocation, the prefix pool's seed and store, and
    ``runtime/kvcache/device.py``'s block export, adopt and row write.
    On a closed mesh each raises, rather than rank 0 moving its own
    heads alone."""

    def __init__(self, mesh):
        self.mesh = mesh

    def export(self, pk, pv, ids):
        return gather_tp_blocks(self.mesh, pk, pv, ids)

    def adopt(self, pk, pv, k_blocks, v_blocks, ids, num_pages):
        scatter_tp_blocks(self.mesh, pk, pv, k_blocks, v_blocks, ids,
                          num_pages)

    def write_row(self, pk, pv, row_k, row_v, ids, num_pages):
        write_tp_row(self.mesh, pk, pv, row_k, row_v, ids, num_pages)

    def alloc(self, shape, kv_dtype, dtype, device):
        return alloc_tp_kv(self.mesh, "pages", shape, dtype, kv_dtype)

    def seed(self, ck, cv, pk, pv, block_ids):
        h = self.mesh.handle_of
        self.mesh.spmd(_kv_seed, h(ck), h(cv), h(pk), h(pv),
                       list(block_ids))

    def store(self, pk, pv, ck, cv, block_ids, covered):
        h = self.mesh.handle_of
        self.mesh.spmd(_kv_store, h(pk), h(pv), h(ck), h(cv),
                       list(block_ids), int(covered))


# ---------------------------------------------------------------------------
# page blocks across ranks: the tier, the fleet, the draft's admission
# ---------------------------------------------------------------------------

def _block_leaves(blocks) -> list:
    """A block payload's tensors (a quantized one's data, scale[, zero])."""
    from ..ops.quant import QuantizedKVPages
    return blocks.leaves() if isinstance(blocks, QuantizedKVPages) \
        else [blocks]


def _block_map(blocks, fn):
    """``fn`` over every tensor of a block payload, its kind kept."""
    from ..ops.quant import QuantizedKVPages
    if isinstance(blocks, QuantizedKVPages):
        return QuantizedKVPages(
            *[None if t is None else fn(t)
              for t in (blocks.data, blocks.scale, blocks.zero)],
            bits=blocks.bits)
    return fn(blocks)


def _heads(blocks, rank: int, tp: int):
    """Rank ``rank``'s kv heads of global blocks ``[n, L, H, bt, ...]``."""
    def cut(t):
        h = t.shape[2] // tp
        return t[:, :, rank * h:(rank + 1) * h].contiguous()
    return _block_map(blocks, cut)


def _gather_pages(mesh, keys_h, values_h, ids):
    """Command: every rank's blocks ``ids`` of its planes, on the host,
    gathered at rank 0."""
    from ..runtime.kvcache.device import export_blocks_from_pages, payload_to
    kb, vb = export_blocks_from_pages(mesh.objects[keys_h],
                                      mesh.objects[values_h], ids)
    return mesh.gather((payload_to(kb, "cpu"), payload_to(vb, "cpu")))


def gather_tp_blocks(mesh, pk, pv, ids):
    """Blocks ``ids`` of the tp pool whose rank-0 planes are ``(pk, pv)``,
    every rank's heads joined along the kv-head axis: global ``(k, v)``
    payloads ``[n, L, H, bt, D]`` (quantized pools: their narrow leaves)
    on rank 0's host, as ``export_blocks_from_pages`` gives them at
    tp=1."""
    got = mesh.spmd(_gather_pages, mesh.handle_of(pk), mesh.handle_of(pv),
                    [int(i) for i in ids])

    def join(side):
        parts = [g[side] for g in got]
        leaves = [_block_leaves(p) for p in parts]
        joined = iter([torch.cat([ls[j] for ls in leaves], dim=2)
                       for j in range(len(leaves[0]))])
        return _block_map(parts[0], lambda _: next(joined))

    return join(0), join(1)


def _layout(blocks) -> tuple:
    """What a follower needs to receive its slice of a payload: the
    quantized bits (None for full width) and each tensor's shape and
    dtype, in :func:`_block_leaves`' order."""
    from ..ops.quant import QuantizedKVPages
    bits = blocks.bits if isinstance(blocks, QuantizedKVPages) else None
    zero = bits is not None and blocks.zero is not None
    return bits, zero, [(tuple(t.shape), t.dtype)
                        for t in _block_leaves(blocks)]


def _received(mesh, layout):
    from ..ops.quant import QuantizedKVPages
    bits, zero, shapes = layout
    got = [mesh.recv(shape, dtype, 0) for shape, dtype in shapes]
    if bits is None:
        return got[0]
    return QuantizedKVPages(got[0], got[1], got[2] if zero else None, bits)


def _scatter_pages(mesh, keys_h, values_h, src, layouts, ids, num_pages):
    """Command: rank 0 sends each follower its kv heads of the global
    blocks it parked under ``src`` (through host memory); every rank
    adopts its slice into blocks ``ids`` of its planes."""
    from ..runtime.kvcache.device import adopt_blocks_into_pages
    tp = tp_size(mesh)
    if mesh.rank == 0:
        kb, vb = mesh.objects.pop(src)
        for r in range(1, mesh.world):
            for blocks in (kb, vb):
                for t in _block_leaves(_heads(blocks, r, tp)):
                    mesh.send(t, r)
        mine = [_block_map(_heads(b, 0, tp), lambda t: t.to(mesh.device))
                for b in (kb, vb)]
        mesh.stats["scattered_bytes"] = (
            mesh.stats.get("scattered_bytes", 0)
            + sum(t.numel() * t.element_size()
                  for b in (kb, vb) for t in _block_leaves(b)))
    else:
        mine = [_received(mesh, layouts[0]), _received(mesh, layouts[1])]
    adopt_blocks_into_pages(mesh.objects[keys_h], mesh.objects[values_h],
                            mine[0], mine[1], ids, num_pages=num_pages)


def scatter_tp_blocks(mesh, pk, pv, k_blocks, v_blocks, ids,
                      num_pages=None) -> None:
    """Global blocks ``[n, L, H, bt, D]`` (the tp=1 layout, a tensor or a
    quantized payload, on the host or rank 0's device) into blocks
    ``ids`` of the tp pool whose rank-0 planes are ``(pk, pv)``: each
    rank adopts its own kv heads (``adopt_blocks_into_pages``' rules).
    Every byte that lands on a rank's device is counted in
    ``mesh.stats["scattered_bytes"]``."""
    tp = tp_size(mesh)
    src = mesh.new_handle()
    mesh.objects[src] = (k_blocks, v_blocks)
    layouts = [_layout(_heads(b, 0, tp)) for b in (k_blocks, v_blocks)]
    try:
        mesh.spmd(_scatter_pages, mesh.handle_of(pk), mesh.handle_of(pv),
                  src, layouts, [int(i) for i in ids], num_pages)
    finally:
        mesh.objects.pop(src, None)


def _row_to_pages(mesh, keys_h, values_h, row_k_h, row_v_h, table,
                  num_pages):
    """Command: a dense row's blocks into every rank's pages."""
    from ..runtime.kvcache.device import write_row_to_pages
    o = mesh.objects
    write_row_to_pages(o[keys_h], o[values_h], o[row_k_h], o[row_v_h],
                       table, num_pages=num_pages)


def write_tp_row(mesh, pk, pv, row_k, row_v, table, num_pages=None):
    """``write_row_to_pages`` on every rank: its plane of the dense row
    ``(row_k, row_v)`` (:func:`new_tp_cache`) into its planes of the
    pool."""
    h = mesh.handle_of
    mesh.spmd(_row_to_pages, h(pk), h(pv), h(row_k), h(row_v),
              [int(i) for i in table], num_pages)


# ---------------------------------------------------------------------------
# the kernels' launch counts on every rank
# ---------------------------------------------------------------------------

_COUNTERS = ("launches", "int8_launches", "fp8_launches", "wide_launches",
             "f32_wide_launches", "decode_launches")


def _rank_launches(mesh, reset: bool):
    """Command: this rank's kernel wrappers' launch counts (reset to 0
    after reading with ``reset``), gathered at rank 0."""
    from ..ops import flash_attention as fa
    from ..ops import paged_attention as pa
    from ..ops import quant_dense as qd
    wrappers = {"flash": fa.flash_attention,
                "paged_decode": pa.paged_flash_attention,
                "paged_prefill": pa.paged_prefill_attention,
                "quant_dense": qd.quant_dense}
    out = {k: {a: getattr(w, a) for a in _COUNTERS if hasattr(w, a)}
           for k, w in wrappers.items()}
    if reset:
        for w in wrappers.values():
            for a in _COUNTERS:
                if hasattr(w, a):
                    setattr(w, a, 0)
    return mesh.gather(out)


def rank_launches(mesh, reset: bool = False) -> list:
    """Every rank's kernel launch counts, in rank order: what each
    wrapper launched in that rank's process (a wrapper counts only
    launches of its kernel, on the card)."""
    return mesh.spmd(_rank_launches, bool(reset))
