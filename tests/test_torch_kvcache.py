"""The torch port's paged KV-cache manager against the JAX package's.

The same scripted sequence of ``match``, ``alloc``, ``store_shared``,
``free``, eviction under pressure and ``peek`` runs on both managers:
block ids, matched lengths, ``epoch``, ``free_blocks``, ``stats`` and
``snapshot`` must be identical after every operation.  Plus the config
resolution and page-width arithmetic the manager is built from.
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.runtime import kvcache as ref_kvcache
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.runtime import kvcache


def _lease(lease):
    return None if lease is None else (list(lease.block_ids), lease.tokens)


def _state(mgr):
    snap = mgr.snapshot()
    return (mgr.epoch, mgr.free_blocks, mgr.used_blocks, dict(mgr.stats),
            snap, mgr.tree.block_count, mgr.tree.node_count)


def _script(mgr, bt: int, rng) -> list:
    """One trace of manager operations and what each returned."""
    vocab = 50
    base = rng.randint(0, vocab, 6 * bt).tolist()
    p1 = base[:4 * bt + 3]                         # 4 full blocks + tail
    p2 = base[:2 * bt] + rng.randint(0, vocab, 3 * bt).tolist()
    p3 = rng.randint(0, vocab, 3 * bt).tolist()
    trace = []

    def note(what, value):
        trace.append((what, value, _state(mgr)))

    note("match p1 (cold)", _lease(mgr.match(p1)))
    ids1 = mgr.alloc(6)
    note("alloc 6", ids1)
    adopted1, lease1 = mgr.store_shared(p1, ids1[:len(p1) // bt])
    note("store p1", (list(adopted1), _lease(lease1)))
    note("peek p2", mgr.peek(p2))
    lease2 = mgr.match(p2)
    note("match p2 (2-block hit)", _lease(lease2))
    m2 = lease2.tokens
    ids2 = mgr.alloc(-(-(len(p2) + 4) // bt) - m2 // bt)
    note("alloc p2 private", ids2)
    table2 = list(lease2.block_ids) + ids2
    adopted2, store2 = mgr.store_shared(p2, table2[:len(p2) // bt])
    note("store p2", (list(adopted2), _lease(store2)))
    # p1 finishes: pins released, its non-adopted private pages freed
    lease1.release()
    mgr.free([b for b in ids1 if b not in set(adopted1)])
    note("finish p1", None)
    hit = mgr.match(p1)
    note("match p1 (full hit, capped at len-1)", _lease(hit))
    # pinned while p2 decodes: nothing is reclaimable past the free list
    note("alloc past the pins", mgr.alloc(mgr.free_blocks + 1))
    hit.release()
    lease2.release()
    store2.release()
    mgr.free([b for b in ids2 if b not in set(adopted2)])
    note("finish p2", None)
    # pressure: more pages than are free, evicting unpinned LRU leaves
    note("infeasible alloc", mgr.alloc(mgr.num_blocks + 1))
    big = mgr.alloc(mgr.free_blocks + 2)
    note("alloc with eviction", big)
    mgr.free(big)
    note("free", None)
    note("peek p3 (miss)", mgr.peek(p3))
    all_ids = mgr.alloc(mgr.num_blocks)
    note("alloc the whole pool (evicts the tree)", all_ids)
    mgr.free(all_ids)
    note("free all", None)
    with pytest.raises(ValueError, match="bad block id"):
        mgr.free([mgr.num_blocks])
    return trace


@pytest.mark.parametrize("model", ["llama-test", "bloom-test"])
@pytest.mark.parametrize("block_tokens", [4, 8])
def test_paged_manager_matches_reference(model, block_tokens):
    rcfg, cfg = ref_get_model_config(model), get_model_config(model)
    ref = ref_kvcache.PagedKVCacheManager.for_model(rcfg, 16, block_tokens)
    port = kvcache.PagedKVCacheManager.for_model(cfg, 16, block_tokens)
    assert port.block_bytes == ref.block_bytes
    ref_trace = _script(ref, block_tokens, np.random.RandomState(3))
    port_trace = _script(port, block_tokens, np.random.RandomState(3))
    assert [t[0] for t in port_trace] == [t[0] for t in ref_trace]
    for (what, pv, ps), (_, rv, rs) in zip(port_trace, ref_trace):
        assert pv == rv, what
        assert ps == rs, what
    seen = dict((t[0], t[1]) for t in port_trace)
    assert seen["match p2 (2-block hit)"][1] == 2 * block_tokens
    assert seen["alloc past the pins"] is None
    assert port_trace[-1][2][3]["evicted_blocks"] > 0


def test_config_resolution_matches_reference(monkeypatch):
    for env in ({}, {"DWT_KVCACHE_BLOCKS": "40",
                     "DWT_KVCACHE_BLOCK_TOKENS": "8"},
                {"DWT_KVCACHE_BLOCKS": "oops"}):
        for k in ("DWT_KVCACHE_BLOCKS", "DWT_KVCACHE_BLOCK_TOKENS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for args in ((None, None, 0), (None, None, 64), (12, 4, 0),
                     (0, None, 7)):
            assert (kvcache.resolve_kvcache_config(*args)
                    == ref_kvcache.resolve_kvcache_config(*args))
    monkeypatch.setenv("DWT_KVCACHE_BYTES", str(3 * 4096))
    cfg = get_model_config("llama-test")
    rcfg = ref_get_model_config("llama-test")
    assert (kvcache.PagedKVCacheManager.for_model(cfg, 64, 8).num_blocks
            == ref_kvcache.PagedKVCacheManager.for_model(rcfg, 64, 8)
            .num_blocks)
    assert kvcache.resolve_kv_layout() == ref_kvcache.resolve_kv_layout()
    for bad in ("dense", "ring"):
        with pytest.raises(ValueError):
            kvcache.resolve_kv_layout(bad)


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float32, np.float32),
                                            (torch.bfloat16, "bfloat16")])
def test_page_width_matches_reference(dtype, np_dtype):
    import ml_dtypes  # noqa: F401  (numpy's bfloat16 for the reference)
    for hd in (8, 64, 128):
        assert (quant.kv_token_head_bytes(hd, "bf16", dtype)
                == ref_quant.kv_token_head_bytes(hd, "bf16",
                                                 np.dtype(np_dtype)))
    assert quant.kv_scale_token_head_bytes(None) == 0
    assert quant.resolve_kv_dtype() == ref_quant.resolve_kv_dtype() == "bf16"
    for width in ("int8", "int4"):
        assert (quant.kv_token_head_bytes(64, width, dtype)
                == ref_quant.kv_token_head_bytes(64, width,
                                                 np.dtype(np_dtype)))
        assert (quant.kv_scale_token_head_bytes(width)
                == ref_quant.kv_scale_token_head_bytes(width))
    with pytest.raises(ValueError, match="unknown kv dtype"):
        quant.resolve_kv_dtype("fp8")
