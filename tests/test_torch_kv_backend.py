"""The torch port's KV backend seam and ``InferenceEngine``'s prefix pool
against the JAX package's.

- ``PagedKVBackend``: a store then a seed gives the working cache the
  reference's bits, with the reference's stats; after every call the
  leak invariant holds (``used == tree.block_count``, no live lease), as
  the reference's ``tests/test_kv_backend.py`` pins it; the byte budget
  counts each page width; the "cannot compose" error is the reference's;
  the tier knobs raise.
- ``InferenceEngine`` on f32 ``llama-test`` with a pool: cold and
  radix-primed runs give the same tokens (a prefix hit is a memory
  optimization, never a semantics change), equal to the reference
  engine's with the same pool, for ``kv_dtype`` bf16 / int8 / int4,
  whole and chunked prefill, ``generate`` and ``generate_stream`` at
  ``stream_block`` 1 and 4; hit counts equal the reference's; and the
  float8 ``kv_cache_dtype`` engine's tokens equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.base import KVCache as RefKVCache
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.kvcache import \
    make_kv_backend as ref_make_kv_backend
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import KVCache
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.kvcache import (
    TIER_LATER, PagedKVBackend, make_kv_backend)

POOL = dict(kv_cache_blocks=32, kv_block_tokens=4)
SHARED = list(range(2, 22))                  # 20 tokens = 5 blocks
PROMPT = np.asarray([SHARED + [51, 52, 53]])
PRIME = np.asarray([SHARED + [90]])
MAX_SEQ, NEW = 96, 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


def assert_drained(backend):
    """The leak invariant: every page is tree-owned or free, and no lease
    outlives its call."""
    mgr = backend.mgr
    assert mgr.used_blocks == mgr.tree.block_count
    assert backend.debug_state()["leased_nodes"] == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_backend_store_then_seed_equals_reference(weights, kv_dtype):
    """Store a prompt's cache, seed a prompt sharing 3 of its blocks: the
    seeded columns hold the reference's bits, the stats and the seed's
    start equal the reference's, and the pool drains."""
    rcfg, _, cfg, _ = weights
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, 1, cfg.num_kv_heads, 32, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    a = np.asarray([list(range(1, 19))])              # 18 tokens: 4 blocks
    b = np.asarray([list(range(1, 13)) + [77, 78, 79]])
    ref = ref_make_kv_backend(rcfg, 8, 4, layout="paged", kv_dtype=kv_dtype)
    port = make_kv_backend(cfg, 8, 4, layout="paged", kv_dtype=kv_dtype,
                           device="cpu")
    assert isinstance(port, PagedKVBackend) and port.num_blocks == 8
    ref.store(a, RefKVCache(jnp.asarray(ck), jnp.asarray(cv), 18))
    port.store(a, KVCache(torch.from_numpy(ck), torch.from_numpy(cv), 18))
    assert_drained(port)
    fresh = np.zeros(shape, np.float32)
    r_start, r_cache = ref.seed(b, RefKVCache(jnp.asarray(fresh),
                                              jnp.asarray(fresh), 0))
    tk, tv = torch.from_numpy(fresh.copy()), torch.from_numpy(fresh.copy())
    p_start, p_cache = port.seed(b, KVCache(tk, tv, 0))
    assert p_start == r_start == 12 and p_cache.length == 12
    assert p_cache.keys is tk                          # seeded in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(r_cache.keys))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(r_cache.values))
    assert port.stats == ref.stats
    assert port.snapshot() == ref.snapshot()
    assert_drained(port)
    # a two-row batch neither seeds nor stores
    two = np.concatenate([b, b])
    assert port.seed(two, p_cache) == (0, p_cache)
    port.store(two, p_cache)
    assert port.stats == ref.stats
    port.reset_stats()
    port.close()


@pytest.mark.parametrize("kv_dtype,dtype", [
    ("bf16", None), ("int8", None), ("int4", None),
    ("bf16", "float8_e4m3fn")])
def test_byte_budget_counts_the_page_width(weights, monkeypatch, kv_dtype,
                                           dtype):
    """``DWT_KVCACHE_BYTES`` caps the pool at the real page width; below
    one block the pool is off."""
    rcfg, _, cfg, _ = weights
    rdt = jnp.dtype(dtype) if dtype else None
    tdt = torch.float8_e4m3fn if dtype else None
    for budget in (1 << 16, 1 << 12, 10):
        monkeypatch.setenv("DWT_KVCACHE_BYTES", str(budget))
        ref = ref_make_kv_backend(rcfg, 64, 4, layout="paged", dtype=rdt,
                                  kv_dtype=kv_dtype)
        port = make_kv_backend(cfg, 64, 4, layout="paged", dtype=tdt,
                               kv_dtype=kv_dtype, device="cpu")
        assert (port is None) == (ref is None)
        if ref is not None:
            assert port.num_blocks == ref.mgr.num_blocks
            assert port.snapshot() == ref.snapshot()


def test_kv_dtype_and_storage_cast_and_tiers_are_refused(weights,
                                                         monkeypatch):
    rcfg, _, cfg, params = weights
    with pytest.raises(ValueError, match="cannot compose") as want:
        ref_make_kv_backend(rcfg, 8, 4, layout="paged",
                            dtype=jnp.dtype("float8_e4m3fn"),
                            kv_dtype="int8")
    with pytest.raises(ValueError, match="cannot compose") as got:
        make_kv_backend(cfg, 8, 4, layout="paged",
                        dtype=torch.float8_e4m3fn, kv_dtype="int8")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cannot compose"):
        InferenceEngine(cfg, params, kv_dtype="int4",
                        kv_cache_dtype="float8_e4m3fn", device="cpu")
    with pytest.raises(ValueError, match="paged is the only layout"):
        make_kv_backend(cfg, 8, 4, layout="dense")
    with pytest.raises(NotImplementedError, match="A12") as tier:
        make_kv_backend(cfg, 8, 4, layout="paged", kv_disk_tier_path="/x")
    assert str(tier.value) == TIER_LATER
    monkeypatch.setenv("DWT_KV_HOST_TIER_BYTES", str(1 << 20))
    with pytest.raises(NotImplementedError, match="A12"):
        InferenceEngine(cfg, params, device="cpu", **POOL)
    # no pool, no tier to refuse (the reference builds none either)
    InferenceEngine(cfg, params, device="cpu")


def _engines(weights, **kw):
    rcfg, rp, cfg, params = weights
    ref_kw = dict(kw)
    if "kv_cache_dtype" in ref_kw:
        ref_kw["attn_backend"] = "jnp"
    ref = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(greedy=True), **ref_kw)
    port = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                           sampling=SamplingParams(greedy=True),
                           device="cpu", **kw)
    return ref, port


def _runs(eng, k):
    """cold generate, prime, primed generate, primed stream at K = k:
    the token arrays (the stream's stacked)."""
    cold = eng.generate(PROMPT, NEW).tokens
    eng.generate(PRIME, 4)
    primed = eng.generate(PROMPT, NEW).tokens
    eng.stream_block = k
    streamed = np.stack(list(eng.generate_stream(PROMPT, NEW)), 1)
    return cold, primed, streamed


@pytest.mark.parametrize("chunk,k", [
    (None, 1), (8, 4),
    pytest.param(None, 4, marks=pytest.mark.slow),
    pytest.param(8, 1, marks=pytest.mark.slow)])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_engine_prefix_pool_equals_reference(weights, kv_dtype, chunk, k):
    ref, port = _engines(weights, prefill_chunk=chunk, kv_dtype=kv_dtype,
                         **POOL)
    got, want = _runs(port, k), _runs(ref, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kv_dtype == "bf16":
        # full-width pages: a hit changes nothing
        np.testing.assert_array_equal(got[0], got[1])
    assert port.kv_cache.stats == ref.kv_cache.stats
    assert port.kv_cache.stats["hits"] == 3
    assert_drained(port.kv_cache)


@pytest.mark.parametrize("chunk", [None, 8])
def test_float8_engine_equals_reference(weights, chunk):
    """``kv_cache_dtype`` float8: the working cache and the pool's pages
    are float8; plain attention, as the reference forces its "jnp" path;
    tokens and hits equal the reference's, cold equals primed."""
    ref, port = _engines(weights, prefill_chunk=chunk,
                         kv_cache_dtype="float8_e4m3fn", **POOL)
    assert port.attn_backend == "plain"
    assert port.new_cache(1).keys.dtype == torch.float8_e4m3fn
    assert port.kv_cache.pool[0].dtype == torch.float8_e4m3fn
    got, want = _runs(port, 4), _runs(ref, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], got[1])
    assert port.kv_cache.stats == ref.kv_cache.stats
    assert_drained(port.kv_cache)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        InferenceEngine(weights[2], weights[3], attn_backend="flash",
                        kv_cache_dtype="float8_e4m3fn", device="cpu")
