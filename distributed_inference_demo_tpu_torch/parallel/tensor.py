"""The paged forward seam: one stage forward over a block-table page pool.

Counterpart of ``distributed_inference_demo_tpu/parallel/tensor.py``'s
``make_paged_forward_seam``, single-device branch.  Tensor-parallel
meshes (Megatron weights, a pool sharded by kv head) are ported in a
later slice (ROADMAP A13) and raise here.
"""

from ..models.base import ModelConfig, StageParams, StageSpec
from ..models.decoder import stage_forward

TP_LATER = "tensor-parallel meshes are ported in a later slice (ROADMAP A13)"


def make_paged_forward_seam(cfg: ModelConfig, spec: StageSpec, mesh,
                            params_template: StageParams,
                            block_tokens: int, backend: str = "auto",
                            num_pages=None, device_type: str = "cpu"):
    """``(fwd, bind, pool_sharding)`` for a PAGED-cache engine: the
    forward runs ``ops.paged_attention``'s block-table hook over a page
    pool ``[L, N + 1, H, bt, D]`` standing in for the dense cache
    buffers (page N is the drop page, see ``write_paged_kv``).

    ``bind(tables)`` hands the current dispatch's device block tables to
    the hook; call it before the first ``fwd`` of a dispatch.
    ``pool_sharding`` is always None here: there is no mesh.
    ``num_pages``, ``backend`` and ``device_type`` go to
    :func:`~..ops.paged_attention.make_paged_attn_impl`."""
    from ..ops.paged_attention import make_paged_attn_impl
    tp = mesh.shape.get("tp", 1) if mesh is not None else 1
    if tp > 1:
        raise NotImplementedError(TP_LATER)
    impl, bind = make_paged_attn_impl(block_tokens, backend,
                                      num_pages=num_pages,
                                      head_dim=cfg.head_dim,
                                      device_type=device_type)

    def fwd(p, inputs, cache, positions, last_logits_only):
        return stage_forward(p, cfg, spec, inputs, cache, positions,
                             attn_impl=impl,
                             last_logits_only=last_logits_only)

    return fwd, bind, None
