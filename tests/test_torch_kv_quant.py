"""The torch port's quantized KV pages against the JAX package's.

Same numpy inputs through both: int8/int4 codes, scales and zeros equal
exactly; ``write_paged_kv`` into a quantized pool leaves the same pages
(sentinel and past-table writes dropped); the quantized gather path and
the plain versions of both kernels' int8 instances agree with the
reference's gather and its Pallas kernels in interpret mode to rtol/atol
2e-4, with ALiBi and GQA; the byte owners, the routing by pool type (int4
always gathers) and the ``kv_dtype`` + ``kv_cache_dtype`` refusal match.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.kvcache import \
    PagedKVCacheManager as RefManager
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import (
    kv_pages_from_numpy, params_from_numpy)
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.kvcache import \
    PagedKVCacheManager

TOL = dict(rtol=2e-4, atol=2e-4)
BITS = {"int8": 8, "int4": 4}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _leaves(q):
    """(data, scale, zero) of a quantized pool of either package as numpy
    arrays (zero None for int8)."""
    return tuple(None if t is None else np.asarray(t)
                 for t in (q.data, q.scale, q.zero))


def _port_pool(ref_pages):
    """The reference's quantized pool carried across, drop page added."""
    return kv_pages_from_numpy(*_leaves(ref_pages), ref_pages.bits, "cpu")


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("shape,scale", [
    ((3, 5, 2, 64), 3.0),        # projection chunks at TinyLlama's hd
    ((4, 2, 8, 16), 1e-3),       # small values, pages of 8 tokens
    ((2, 1, 4, 128), 50.0),      # hd 128, large values
])
def test_codes_scales_zeros_equal_reference(kv_dtype, shape, scale):
    rng = np.random.default_rng(len(shape) + int(scale))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                          # an all-zero token
    x[-1, -1, -1, : shape[-1] // 2] = 0.25    # ties at the rounding point
    want = ref_quant.quantize_kv_pages(jnp.asarray(x), BITS[kv_dtype])
    got = quant.quantize_kv_pages(_t(x), BITS[kv_dtype])
    for w, g in zip(_leaves(want), _leaves(got)):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got.shape == tuple(want.shape) and got.ndim == want.ndim
    assert got.nbytes == want.nbytes
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    np.testing.assert_array_equal(
        quant.dequantize_kv(got, torch.bfloat16).float().numpy(),
        np.asarray(ref_quant.dequantize_kv(want, jnp.bfloat16)
                   ).astype(np.float32))


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("case", [
    # decode tokens of ragged rows, one row freed (all-sentinel table)
    dict(b=3, chunk=1, bt=8, W=4, starts=[4, 15, 9], freed=[2]),
    # a chunk crossing a page boundary, and one running off the table
    dict(b=2, chunk=6, bt=8, W=3, starts=[5, 21], freed=[]),
])
def test_write_quantized_pages_matches_reference(kv_dtype, case):
    """The chunk is quantized once at write time: the pages a table names
    end equal to the reference's leaf for leaf, and the sentinel and
    past-table writes land in the drop page only."""
    rng = np.random.default_rng(len(str(case)))
    b, chunk, bt, W = case["b"], case["chunk"], case["bt"], case["W"]
    nkv, hd = 2, 16
    N = b * W + 3
    bits = BITS[kv_dtype]
    pool = ref_quant.quantize_kv_pages(
        jnp.asarray(rng.standard_normal((N, nkv, bt, hd)), jnp.float32),
        bits)
    tables = rng.permutation(N)[:b * W].reshape(b, W).astype(np.int32)
    tables[:, -1] = N                     # one sentinel entry per row
    for i in case["freed"]:
        tables[i] = N + 3
    k_new = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    pos = (np.asarray(case["starts"])[:, None]
           + np.arange(chunk)).astype(np.int32)
    rk, rv = ref_pa.write_paged_kv(pool, pool, jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(tables),
                                   jnp.asarray(pos))
    tk, tv = _port_pool(pool), _port_pool(pool)
    pa.write_paged_kv(tk, tv, _t(k_new), _t(v_new), _t(tables),
                      _t(pos).long(), num_pages=N)
    for ref_pages, port in ((rk, tk), (rv, tv)):
        for w, g in zip(_leaves(ref_pages), _leaves(port[:N])):
            if w is not None:
                np.testing.assert_array_equal(g, w)
    # the drop page took a write iff some write went to a sentinel or
    # past the table
    dropped = bool(((pos // bt) >= W).any() or case["freed"]
                   or (np.take_along_axis(tables, np.minimum(pos // bt,
                                                             W - 1), 1)
                       >= N).any())
    assert bool((tk.scale[N] != 0).any()) == dropped


def _paged_case(rng, kv_dtype, b, nkv, hd, bt, W, lens):
    """Quantized K/V pools for per-row lengths ``lens`` under shuffled
    page ids (sentinels N and N + 7 after each row's pages), in both
    packages' containers."""
    need = [-(-int(n) // bt) for n in lens]
    N = sum(need) + 3
    ids = rng.permutation(N)
    tables = np.full((b, W), N + 7, np.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[nxt:nxt + n]
        if n < W:
            tables[i, n] = N
        nxt += n
    pools = []
    for _ in range(2):
        x = rng.standard_normal((N, nkv, bt, hd)).astype(np.float32)
        pools.append(ref_quant.quantize_kv_pages(jnp.asarray(x),
                                                 BITS[kv_dtype]))
    return pools, [_port_pool(p) for p in pools], tables


def _slopes(nh, alibi):
    if not alibi:
        return None, None
    return ref_alibi_slopes(nh), alibi_slopes(nh)


DECODE = [dict(nh=4, nkv=2, hd=16, bt=8, W=4, lens=[5, 8, 17]),
          dict(nh=8, nkv=2, hd=32, bt=16, W=3, lens=[1, 33, 48])]
PREFILL = [dict(nh=4, nkv=2, hd=16, bt=8, W=6, chunk=8, starts=[0, 19]),
           dict(nh=8, nkv=2, hd=32, bt=16, W=4, chunk=5, starts=[3, 40])]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("alibi", [False, True])
def test_quantized_gather_matches_reference(kv_dtype, alibi):
    """The gather path reads the narrow leaves through the table, then
    dequantizes in f32, as the reference's does."""
    case = DECODE[1]
    rng = np.random.default_rng(7 + alibi)
    b = len(case["lens"])
    (rk, rv), (tk, tv), tables = _paged_case(
        rng, kv_dtype, b, case["nkv"], case["hd"], case["bt"], case["W"],
        case["lens"])
    q = rng.standard_normal((b, 3, case["nh"], case["hd"])
                            ).astype(np.float32)
    qpos = (np.asarray(case["lens"])[:, None] - 3
            + np.arange(3)).clip(0).astype(np.int32)
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_gather_attention(jnp.asarray(q), rk, rv,
                                         jnp.asarray(tables),
                                         jnp.asarray(qpos), rs)
    got = pa.paged_gather_attention(_t(q), tk, tv, _t(tables),
                                    _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", DECODE)
def test_int8_decode_plain_matches_reference_kernel(case, alibi):
    """The decode kernel's int8 instance, plain version, against
    ``_paged_kernel`` over int8 pages in interpret mode; the CPU wrapper
    takes the plain version and counts no launch."""
    rng = np.random.default_rng(len(str(case)) + alibi)
    lens = np.asarray(case["lens"], np.int32)
    b = len(lens)
    (rk, rv), (tk, tv), tables = _paged_case(
        rng, "int8", b, case["nkv"], case["hd"], case["bt"], case["W"],
        lens)
    q = rng.standard_normal((b, 1, case["nh"], case["hd"])
                            ).astype(np.float32)
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_flash_attention(jnp.asarray(q), rk, rv,
                                        jnp.asarray(tables),
                                        jnp.asarray(lens), rs,
                                        interpret=True)
    got = pa.paged_flash_attention_plain(_t(q), tk, tv, _t(tables),
                                         _t(lens), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    before = (pa.paged_flash_attention.launches,
              pa.paged_flash_attention.int8_launches)
    via = pa.paged_flash_attention(_t(q), tk, tv, _t(tables), _t(lens), ps)
    assert (pa.paged_flash_attention.launches,
            pa.paged_flash_attention.int8_launches) == before
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", PREFILL)
def test_int8_prefill_plain_matches_reference_kernel(case, alibi):
    """The prefill kernel's int8 instance, plain version, against
    ``_paged_prefill_kernel`` over int8 pages in interpret mode, and the
    CPU wrapper against the gather path."""
    rng = np.random.default_rng(len(str(case)) + alibi)
    starts, chunk = case["starts"], case["chunk"]
    b = len(starts)
    (rk, rv), (tk, tv), tables = _paged_case(
        rng, "int8", b, case["nkv"], case["hd"], case["bt"], case["W"],
        [s + chunk for s in starts])
    q = rng.standard_normal((b, chunk, case["nh"], case["hd"])
                            ).astype(np.float32)
    qpos = (np.asarray(starts)[:, None] + np.arange(chunk)).astype(np.int32)
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_prefill_attention(jnp.asarray(q), rk, rv,
                                          jnp.asarray(tables),
                                          jnp.asarray(qpos), rs,
                                          interpret=True)
    got = pa.paged_prefill_attention_plain(_t(q), tk, tv, _t(tables),
                                           _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    via = pa.paged_prefill_attention(_t(q), tk, tv, _t(tables),
                                     _t(qpos).long(), ps)
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    gathered = pa.paged_gather_attention(_t(q), tk, tv, _t(tables),
                                         _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), **TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_byte_owners_pools_and_snapshot(kv_dtype):
    for hd in (16, 64, 128):
        for base in (np.float32, "bfloat16"):
            tdt = torch.float32 if base is np.float32 else torch.bfloat16
            jdt = jnp.float32 if base is np.float32 else jnp.bfloat16
            assert (quant.kv_token_head_bytes(hd, kv_dtype, tdt)
                    == ref_quant.kv_token_head_bytes(hd, kv_dtype, jdt))
    assert (quant.kv_scale_token_head_bytes(kv_dtype)
            == ref_quant.kv_scale_token_head_bytes(kv_dtype))
    shape = (2, 5, 2, 8, 16)
    want = ref_quant.alloc_kv_pages(shape, kv_dtype, jnp.bfloat16)
    got = quant.alloc_kv_pages(shape, kv_dtype, torch.bfloat16, "cpu")
    if kv_dtype == "bf16":
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    else:
        assert got.bits == want.bits and got.shape == tuple(want.shape)
        assert got.nbytes == want.nbytes
        for w, g in zip(_leaves(want), _leaves(got)):
            if w is not None:
                assert g.shape == w.shape and g.dtype == w.dtype
                assert not g.any()
        # a layer of the stacked pool is a view: writes land in the pool
        layer = got[1]
        layer.scale[3] = 2.0
        assert got.scale[1, 3].eq(2.0).all() and got.ndim == 5
    cfg, rcfg = (get_model_config("llama-test"),
                 ref_get_model_config("llama-test"))
    mine = PagedKVCacheManager.for_model(cfg, 12, 8, kv_dtype=kv_dtype)
    ref = RefManager.for_model(rcfg, 12, 8, kv_dtype=kv_dtype)
    assert (mine.block_bytes, mine.scale_block_bytes) == (
        ref.block_bytes, ref.scale_block_bytes)
    ids = mine.alloc(3)
    assert ref.alloc(3) is not None
    snap, rsnap = mine.snapshot(), ref.snapshot()
    for key in ("page_dtype", "quant_scale_bytes", "device_resident_bytes",
                "capacity_bytes"):
        assert snap[key] == rsnap[key], key
    mine.free(ids)


ROUTES = ("decode", "prefill", "gather")


def _record_routes(monkeypatch, module):
    calls = []
    for name, route in zip(("paged_flash_attention",
                            "paged_prefill_attention",
                            "paged_gather_attention"), ROUTES):
        monkeypatch.setattr(module, name,
                            lambda q, *a, _r=route, **k: calls.append(_r)
                            or q)
    return calls


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("chunk,bt", [(1, 16), (1, 8), (5, 8), (65, 16),
                                      (1, 12)])
def test_routing_follows_the_pool_type(monkeypatch, kv_dtype, chunk, bt):
    """The pool's own type picks the route, as the reference's (kernels
    on, which also waives its 32-token int8 rule): int8 pools take the
    kernels on 8-aligned pages, int4 pools always gather."""
    rng = np.random.default_rng(chunk * 10 + bt)
    b, nh, nkv, hd, W = 2, 32, 4, 8, 12
    (rk, rv), (tk, tv), tables = _paged_case(rng, kv_dtype, b, nkv, hd, bt,
                                             W, [20, 7])
    q = rng.standard_normal((b, chunk, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    pos = (np.asarray([3, 11])[:, None] + np.arange(chunk)).astype(np.int32)
    ref_calls = _record_routes(monkeypatch, ref_pa)
    impl, bind = ref_pa.make_paged_attn_impl(bt, "pallas", interpret=True)
    bind(jnp.asarray(tables))
    impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), rk, rv,
         jnp.asarray(pos), 0, None)
    port_calls = _record_routes(monkeypatch, pa)
    impl, bind = pa.make_paged_attn_impl(bt, "auto")
    bind(_t(tables))
    impl(_t(q), _t(k), _t(k), tk, tv, _t(pos).long(), 0, None)
    assert port_calls == ref_calls
    if kv_dtype == "int4":
        assert port_calls == ["gather"]
    assert pa.paged_route(True, chunk, nh // nkv, bt,
                          BITS[kv_dtype]) == ref_calls[0]


def test_cuda_wrappers_refuse_int4_and_mixed_pools():
    x = torch.zeros((3, 2, 8, 16))
    int4 = quant.quantize_kv_pages(x, 4)
    int8 = quant.quantize_kv_pages(x, 8)
    with pytest.raises(ValueError, match="int4 KV takes the gather path"):
        pa._check_pages(int4, int4, torch.float32)
    with pytest.raises(ValueError, match="both be quantized"):
        pa._check_pages(int8, x, torch.float32)
    with pytest.raises(ValueError, match="of q's dtype"):
        pa._check_pages(x, x, torch.bfloat16)
    assert pa._check_pages(int8, int8, torch.bfloat16) is True
    assert pa._check_pages(x, x, torch.float32) is False


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


def test_kv_dtype_refuses_a_storage_cast(weights):
    """``kv_dtype`` int8/int4 with ``kv_cache_dtype`` is the reference's
    ValueError, raised before the tp mesh's not-yet-ported refusal."""
    rcfg, rp, cfg, params = weights
    kw = dict(max_seq=64, kv_block_tokens=8, kv_dtype="int8",
              kv_cache_dtype="float8_e4m3fn")
    with pytest.raises(ValueError, match="cannot compose") as want:
        RefBatching(rcfg, rp, **kw)
    with pytest.raises(ValueError, match="cannot compose") as got:
        ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cannot compose"):
        ContinuousBatchingEngine(cfg, params, device="cpu",
                                 mesh=SimpleNamespace(shape={"tp": 2}),
                                 **kw)
    with pytest.raises(NotImplementedError, match="A13"):
        ContinuousBatchingEngine(cfg, params, device="cpu", max_seq=64,
                                 mesh=SimpleNamespace(shape={"tp": 2}))
