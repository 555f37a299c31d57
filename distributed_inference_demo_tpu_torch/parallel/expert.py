"""Expert-parallel MoE stage execution over the ``ep`` mesh axis.

Counterpart of ``distributed_inference_demo_tpu/parallel/expert.py``
(BASELINE.json config #4, per-expert shard placement): expert weights
live E-sliced over ``ep`` (each rank holds ``E/ep`` experts), tokens are
data-parallel over the same axis, and ``decoder._moe_mlp_ep`` routes
tokens to expert owners with GShard capacity dispatch and two
all-to-alls.  Everything that is not an expert weight (attention, norms,
router, embed and head) runs data-parallel with replicated weights.

Rank 0 drives (``parallel/mesh.py``): it sends the full batch, each rank
takes its rows and its batch slice of the cache, and the outputs are
all-gathered back in batch order.
"""

from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..models.decoder import _moe_mlp_ep, stage_forward
from ..ops.quant import QuantizedArray, QuantizedArray4
from .sharding import quant4_specs, quant_scale_spec, slice_leaf

# expert stacks [L, E, H, I]: shard E over ep; everything else replicated
_EP_LAYER_SPECS = {
    "w_gate": (None, "ep", None, None),
    "w_up": (None, "ep", None, None),
    "w_down": (None, "ep", None, None),
}

# tokens are data-parallel over ep: the cache [layers, batch, nkv, seq,
# hd] is batch-sharded
_CACHE_SPEC = KVCache(keys=(None, "ep", None, None, None),
                      values=(None, "ep", None, None, None),
                      length=())


def _ep_param_specs(params: StageParams) -> StageParams:
    def map_layers(layers):
        out = {}
        for k, v in layers.items():
            spec = _EP_LAYER_SPECS.get(k, ())
            if isinstance(v, QuantizedArray):
                out[k] = QuantizedArray(q=spec, scale=quant_scale_spec(spec))
            elif isinstance(v, QuantizedArray4):
                # ep slices the EXPERT axis; int4 packing lives on the
                # input axis (-2), so the two compose
                out[k] = quant4_specs(v, spec)
            else:
                out[k] = spec
        return out

    def rep(d):
        return None if d is None else {k: () for k in d}

    return StageParams(layers=map_layers(params.layers),
                       embed=rep(params.embed),
                       final_norm=rep(params.final_norm),
                       lm_head=rep(params.lm_head))


def _rows(mesh, x):
    """This rank's batch rows of a replicated ``x`` [b, ...]."""
    n, r = mesh.shape["ep"], mesh.coords["ep"]
    step = x.shape[0] // n
    return x[r * step:(r + 1) * step]


def _ep_forward(mesh, cfg, spec, params_h, keys_h, values_h, inputs,
                positions, start):
    """Command: every rank's batch rows through the stage, E-sliced
    experts, its batch slice of the cache; outputs gathered."""
    o = mesh.objects
    cache = KVCache(o[keys_h], o[values_h], start)
    out, _ = stage_forward(o[params_h], cfg, spec, _rows(mesh, inputs),
                           cache, _rows(mesh, positions),
                           ep=mesh.group("ep"))
    return mesh.group("ep").all_gather(out, dim=0)


def make_ep_stage_fn(cfg: ModelConfig, spec: StageSpec, mesh,
                     params_template: StageParams):
    """``fn(params, inputs, cache, positions) -> (out, cache)`` with
    expert weights E-sliced over ``ep`` (``params`` from
    :func:`distribute_ep_params`) and the batch data-parallel over it
    (``cache`` from :func:`new_ep_cache`).  Requires ``cfg.num_experts %
    ep == 0`` and ``batch % ep == 0``; outputs come back whole."""
    ep = mesh.shape["ep"]
    if cfg.num_experts == 0:
        raise ValueError("expert parallelism needs a MoE config "
                         "(num_experts > 0)")
    if cfg.num_experts % ep:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by ep={ep}")

    def fn(params, inputs, cache, positions):
        if inputs.shape[0] % ep:
            raise ValueError(
                f"batch={inputs.shape[0]} not divisible by ep={ep} "
                "(tokens are data-parallel over the ep axis)")
        start = cache.length
        out = mesh.spmd(_ep_forward, cfg, spec, params.handle,
                        mesh.handle_of(cache.keys),
                        mesh.handle_of(cache.values), inputs, positions,
                        start)
        return out, KVCache(cache.keys, cache.values,
                            start + inputs.shape[1])

    return fn


def distribute_ep_params(params: StageParams, cfg: ModelConfig, mesh):
    """Send every rank its E-slice of the expert stacks (the rest
    replicated); returns rank 0's (``parallel.tensor.ShardedParams``)."""
    from .tensor import distribute_params
    return distribute_params(params, cfg, mesh, _ep_param_specs(params))


def new_ep_cache(cfg: ModelConfig, mesh, num_layers: int, batch: int,
                 max_seq: int, dtype=None) -> KVCache:
    """A dense cache batch-sharded over ``ep`` (rank 0's slice)."""
    from ..models.base import pad_cache_capacity
    from .tensor import alloc_mesh_kv
    ep = mesh.shape["ep"]
    shape = (num_layers, batch // ep, cfg.num_kv_heads,
             pad_cache_capacity(max_seq), cfg.head_dim)
    k, v = alloc_mesh_kv(mesh, "dense", shape, dtype or cfg.dtype)
    return KVCache(k, v, 0)


def _ep_mlp(mesh, cfg, lp, x):
    """Command: ``_moe_mlp_ep`` over each rank's rows of ``x`` and its
    E-slice of the layer weights ``lp``; outputs gathered."""
    sizes, coords = mesh.shape, mesh.coords
    local = {k: (slice_leaf(v, _EP_LAYER_SPECS[k][1:], coords, sizes)
                 if k in _EP_LAYER_SPECS else v) for k, v in lp.items()}
    ep = mesh.group("ep")
    return ep.all_gather(_moe_mlp_ep(cfg, local, _rows(mesh, x), ep), dim=0)


def run_ep_mlp(mesh, cfg: ModelConfig, lp: dict, x):
    """One layer's expert-parallel MoE MLP over the mesh (float weights
    ``lp`` without the layer axis, ``x`` [b, s, H] with b % ep == 0):
    the dispatch on its own, as the reference's tests drive it."""
    return mesh.spmd(_ep_mlp, cfg, lp, x)
