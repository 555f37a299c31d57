"""The port's tiered KV (``runtime/kvcache/tiered.py``) against the JAX
package's.

The tier's bookkeeping is the reference's: the same demotions, lookups
and takes give the same stats, snapshots and digests, exactly, and the
chain digests (sha1 over 8-byte big-endian token ids) are the same
bytes.  The payloads are torch tensors in the port; a take returns the
demoted bits, on the host ring and through the disk segment, for bf16,
float8, int8 and int4 leaves.  Then the engines: ``InferenceEngine``'s
prefix pool and the batching engine demote on eviction and promote at
admission, their greedy tokens equal the reference engines' on the same
weights, and the pool snapshots (the ``tier`` fragment with its digest
and ``h2d_bytes``) are equal.  ``llama-test`` in f32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.quant import \
    QuantizedKVPages as RefQ
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.kvcache import tiered as ref_tiered
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.quant import QuantizedKVPages
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime import kvcache
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.kvcache import tiered
from distributed_inference_demo_tpu_torch.runtime.kvcache.device import \
    export_blocks_from_pages
from distributed_inference_demo_tpu_torch.telemetry import profiling

BT = 4
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _keys(tokens):
    toks = list(tokens)
    return [tuple(toks[i * BT:(i + 1) * BT]) for i in range(len(toks) // BT)]


def _payloads(n, kind, seed):
    """(reference numpy payload pair, port torch payload pair) holding the
    same bits: kind "f32", "bf16", "int8" or "int4"."""
    rng = np.random.default_rng(seed)
    shape = (n, 2, 2, BT, 8)                    # [n, L, H, bt, D]
    if kind in ("f32", "bf16"):
        def one():
            x = rng.standard_normal(shape).astype(np.float32)
            t = torch.from_numpy(x)
            if kind == "bf16":
                t = t.to(torch.bfloat16)
                import ml_dtypes
                return x.astype(ml_dtypes.bfloat16), t
            return x, t
        (rk, pk), (rv, pv) = one(), one()
        return (rk, rv), (pk, pv)
    bits = 4 if kind == "int4" else 8

    def one():
        d, dt = (4, np.uint8) if bits == 4 else (8, np.int8)
        data = rng.integers(0, 255, shape[:-1] + (d,)).astype(dt)
        scale = rng.standard_normal(shape[:-1] + (1,)).astype(np.float32)
        zero = (rng.standard_normal(shape[:-1] + (1,)).astype(np.float32)
                if bits == 4 else None)
        port = QuantizedKVPages(
            torch.from_numpy(data), torch.from_numpy(scale),
            None if zero is None else torch.from_numpy(zero), bits)
        return RefQ(data, scale, zero, bits), port
    (rk, pk), (rv, pv) = one(), one()
    return (rk, rv), (pk, pv)


def _bits(x) -> list:
    """A payload's leaves as numpy bit arrays, either package."""
    if isinstance(x, (QuantizedKVPages, RefQ)):
        leaves = [x.data, x.scale] + ([x.zero] if x.zero is not None else [])
    else:
        leaves = [x]
    out = []
    for a in leaves:
        if torch.is_tensor(a):
            a = (a.view(torch.uint16) if a.dtype == torch.bfloat16
                 else a).numpy()
        a = np.asarray(a)
        out.append(a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    return out


def test_chain_digests_and_config_equal_reference(monkeypatch, tmp_path):
    rng = np.random.RandomState(0)
    for n in (1, 3, 9):
        keys = [tuple(int(t) for t in rng.randint(-5, 32000, BT))
                for _ in range(n)]
        assert tiered.chain_digests(keys) == ref_tiered.chain_digests(keys)
    for kw in (dict(), dict(host_bytes=1 << 20),
               dict(host_bytes=64, disk_path=str(tmp_path / "s"),
                    disk_bytes=1 << 20),
               dict(host_bytes=64, disk_path=str(tmp_path / "s")),
               dict(host_bytes=-3, disk_bytes=9)):
        assert (tiered.resolve_tier_config(**kw)
                == ref_tiered.resolve_tier_config(**kw))
    monkeypatch.setenv("DWT_KV_HOST_TIER_BYTES", "4096")
    monkeypatch.setenv("DWT_KV_DISK_TIER_PATH", str(tmp_path / "d"))
    monkeypatch.setenv("DWT_KV_DISK_TIER_BYTES", "8192")
    assert (tiered.resolve_tier_config()
            == ref_tiered.resolve_tier_config())
    errs = []
    for mod in (tiered, ref_tiered):
        with pytest.raises(ValueError) as e:
            mod.resolve_tier_config(0, str(tmp_path / "x"), 100)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
def test_store_bookkeeping_and_payloads_equal_reference(kind, tmp_path):
    """The same demote / match / take sequence, with a host budget that
    spills to a disk segment too small for everything (so entries also
    drop), gives equal stats, snapshots, digests and check() in both
    packages, and every take returns the demoted bits."""
    one = sum(a.nbytes for a in _bits(_payloads(1, kind, 0)[0][0])) * 2
    stores = [mod.TieredKVStore(3 * one, BT,
                                disk_path=str(tmp_path / f"{kind}-{t}"),
                                disk_bytes=4 * one)
              for mod, t in ((ref_tiered, "r"), (tiered, "p"))]
    demoted = {}
    for i, n in enumerate((2, 3, 1, 4)):
        toks = list(range(100 * i, 100 * i + n * BT))
        ref_pl, port_pl = _payloads(n, kind, seed=i)
        demoted[i] = (toks, port_pl)
        got = [s.demote(_keys(toks), *pl)
               for s, pl in zip(stores, (ref_pl, port_pl))]
        assert got[0] == got[1] == n
    # a duplicate demotion refreshes, never re-copies
    toks, port_pl = demoted[2]
    ref_dup, _ = _payloads(1, kind, seed=2)
    assert (stores[0].demote(_keys(toks), *ref_dup)
            == stores[1].demote(_keys(toks), *port_pl) == 0)
    for s in stores:
        s.check()
    assert stores[0].snapshot() == stores[1].snapshot()
    assert stores[0].digest() == stores[1].digest()
    assert stores[0].stats["dropped_blocks"] > 0
    assert stores[0].stats["spilled_blocks"] > 0
    for i in (3, 1, 0, 2):
        toks, port_pl = demoted[i]
        prompt = np.asarray(toks + [7])
        runs = [s.match(prompt, 0) for s in stores]
        assert runs[0] == runs[1]
        takes = [s.take(r) if r else None for s, r in zip(stores, runs)]
        assert (takes[0] is None) == (takes[1] is None)
        if takes[0] is None:
            continue
        (rk, rv, rn, rcount), (pk, pv, pn, pcount) = takes
        assert (rn, rcount) == (pn, pcount)
        for a, b in zip(_bits(rk) + _bits(rv), _bits(pk) + _bits(pv)):
            np.testing.assert_array_equal(a, b)
        # the promoted run is the tail of what this prompt demoted
        first = len(_keys(toks)) - pcount
        for a, b in zip(_bits(pk), _bits(port_pl[0])):
            np.testing.assert_array_equal(a, b[first:] if first else b)
    for s in stores:
        s.check()
    assert stores[0].snapshot() == stores[1].snapshot()
    assert stores[0].stats == stores[1].stats


def test_float8_payloads_round_trip_through_the_disk(tmp_path):
    """Float8 pools demote too (the reference's host ring holds float8
    arrays): the disk segment stores their bytes and gives them back."""
    x = torch.randn(3, 2, 2, BT, 8).to(torch.float8_e4m3fn)
    y = torch.randn(3, 2, 2, BT, 8).to(torch.float8_e4m3fn)
    s = tiered.TieredKVStore(x[0].nbytes * 2, BT,
                             disk_path=str(tmp_path / "f8"),
                             disk_bytes=1 << 20)
    toks = list(range(3 * BT))
    assert s.demote(_keys(toks), x, y) == 3
    assert s.snapshot()["disk_blocks"] == 2
    kb, vb, _, n = s.take(s.match(np.asarray(toks + [1]), 0))
    assert n == 3 and kb.dtype == torch.float8_e4m3fn
    assert torch.equal(kb.view(torch.uint8), x.view(torch.uint8))
    assert torch.equal(vb.view(torch.uint8), y.view(torch.uint8))
    s.check()


def _pool(num_blocks, bits=None):
    mgr = kvcache.PagedKVCacheManager(
        num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=num_blocks,
        block_tokens=BT, dtype=np.float32,
        kv_dtype={None: "bf16", 8: "int8", 4: "int4"}[bits])
    shape = (2, num_blocks + 1, 2, BT, 8)
    from distributed_inference_demo_tpu_torch.ops.quant import \
        alloc_kv_pages
    kvd = {None: "bf16", 8: "int8", 4: "int4"}[bits]
    return (mgr, alloc_kv_pages(shape, kvd, torch.float32, "cpu"),
            alloc_kv_pages(shape, kvd, torch.float32, "cpu"))


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_eviction_demotes_and_promotion_restores_the_pages(bits):
    """The seam at manager level: pages of a stored prefix whose leaf is
    evicted demote through the hook; ``promote_prefix`` adopts them
    back, bit for bit, as an ordinary prefix hit, and counts the h2d
    bytes; pool pressure skips the promotion and leaks nothing."""
    from distributed_inference_demo_tpu_torch.runtime.kvcache.device \
        import adopt_blocks_into_pages
    mgr, pk, pv = _pool(4, bits)
    tier = tiered.TieredKVStore(1 << 24, BT)
    mgr.tier = tier
    mgr.demote_hook = tiered.make_demote_hook(tier, lambda: (pk, pv))
    toks = list(range(50, 50 + 2 * BT))
    ids = mgr.alloc(2)
    src_k = torch.randn(2, 2, 2, BT, 8)
    src_v = torch.randn(2, 2, 2, BT, 8)
    adopt_blocks_into_pages(pk, pv, src_k, src_v, ids)
    before = export_blocks_from_pages(pk, pv, ids)
    _, lease = mgr.store_shared(np.asarray(toks), ids)
    lease.release()
    held = mgr.alloc(4)                 # evicts the leaf: demotes it
    assert tier.stats["demoted_blocks"] == 2
    assert tier.stats["demote_errors"] == 0
    prompt = np.asarray(toks + [1])
    assert tiered.promote_prefix(mgr, tier, pk, pv, prompt)[2] == 0
    assert tier.snapshot()["host_blocks"] == 2          # skipped, kept
    mgr.free(held)
    _, _, promoted = tiered.promote_prefix(mgr, tier, pk, pv, prompt)
    assert promoted == 2 * BT
    hit = mgr.match(prompt)
    assert hit.tokens == 2 * BT
    after = export_blocks_from_pages(pk, pv, hit.block_ids)
    hit.release()
    for a, b in zip(_bits(before[0]) + _bits(before[1]),
                    _bits(after[0]) + _bits(after[1])):
        np.testing.assert_array_equal(a, b)
    snap = mgr.snapshot()
    assert snap["h2d_bytes"] == tier.stats["promoted_bytes"] > 0
    assert mgr.used_blocks == mgr.tree.block_count == 2
    tier.check()


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


PROMPT_A = np.asarray([list(range(2, 22)) + [51, 52, 53]])   # 5 blocks
PROMPT_B = np.asarray([list(range(60, 80)) + [1, 2, 3]])


def _strip(snap: dict) -> dict:
    """A pool snapshot without its wall-clock fields."""
    return {k: v for k, v in snap.items() if "seconds" not in k}


def test_engine_prefix_pool_demotes_and_promotes_as_reference(
        weights, monkeypatch):
    """``InferenceEngine`` with a 7-block pool of 4-token pages and the
    tier from its env knob: A stores 5 blocks, B's store evicts some of
    them into the tier, A again promotes them.  Tokens and pool
    snapshots (the tier fragment, its digest, h2d bytes) equal the
    reference engine's after every call."""
    rcfg, rp, cfg, params = weights
    monkeypatch.setenv("DWT_KV_HOST_TIER_BYTES", str(1 << 22))
    ref = RefEngine(rcfg, rp, max_seq=64,
                    sampling=RefSamplingParams(greedy=True),
                    kv_cache_blocks=7, kv_block_tokens=4)
    port = InferenceEngine(cfg, params, max_seq=64,
                           sampling=SamplingParams(greedy=True),
                           kv_cache_blocks=7, kv_block_tokens=4,
                           device="cpu")
    try:
        assert port.kv_cache.tier is not None
        for prompt in (PROMPT_A, PROMPT_B, PROMPT_A):
            r = ref.generate(prompt, 8).tokens
            p = port.generate(prompt, 8).tokens
            np.testing.assert_array_equal(r, p)
            assert (_strip(port.kv_cache.snapshot())
                    == _strip(ref.kv_cache.snapshot()))
        tier = port.kv_cache.tier
        assert tier.stats["promoted_blocks"] > 0
        assert tier.stats == ref.kv_cache.tier.stats
        snap = port.kv_cache.snapshot()
        assert snap["h2d_bytes"] == tier.stats["promoted_bytes"] > 0
        mgr = port.kv_cache.mgr
        assert mgr.used_blocks == mgr.tree.block_count
        tier.check()
    finally:
        port.kv_cache.close()
        ref.kv_cache.close()
    assert port.kv_cache.tier is None


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_batching_engine_tier_equals_reference(weights, kv_dtype, tmp_path):
    """The batching engine with explicit tier kwargs (a host ring that
    spills to a disk segment): oversubscribed admissions demote, a
    re-submitted prompt promotes, tokens equal the reference engine's
    and ``/stats``' kvcache fragment (tier, digest, h2d bytes) is the
    reference's.  The HBM ledger gains the host_tier owner and loses it
    on close."""
    rcfg, rp, cfg, params = weights
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(5)]
    kw = dict(max_seq=64, max_batch=4, prompt_buckets=(16,),
              kv_cache_blocks=8, kv_block_tokens=4, kv_dtype=kv_dtype,
              kv_host_tier_bytes=1 << 12)
    ref = RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                      kv_disk_tier_path=str(tmp_path / "r"),
                      kv_disk_tier_bytes=1 << 20, **kw)
    port = ContinuousBatchingEngine(
        cfg, params, sampling=SamplingParams(greedy=True), device="cpu",
        kv_disk_tier_path=str(tmp_path / "p"), kv_disk_tier_bytes=1 << 20,
        **kw)
    try:
        outs = []
        for eng in (ref, port):
            reqs = [eng.submit(p, 14) for p in prompts]
            outs.append([r.wait(timeout=WAIT).tolist() for r in reqs])
            outs.append(eng.submit(prompts[0], 14).wait(
                timeout=WAIT).tolist())
        assert outs[0] == outs[2] and outs[1] == outs[3]
        tier = port._kv_tier
        assert tier.stats["demoted_blocks"] > 0
        assert tier.stats["promoted_blocks"] > 0
        rs, ps = ref.stats()["kvcache"], port.stats()["kvcache"]
        assert _strip(ps) == _strip(rs)
        assert ps["tier"]["digest"] == rs["tier"]["digest"]
        assert ps["h2d_bytes"] == tier.stats["promoted_bytes"] > 0
        mgr = port.kv_cache
        assert mgr.used_blocks == mgr.tree.block_count
        tier.check()
        port._sample_hbm()
        assert "host_tier" in profiling.get_hbm_watermarks().watermarks()
    finally:
        port.close()
        ref.close()
    assert "host_tier" not in profiling.get_hbm_watermarks().watermarks()
