"""Float8 e4m3 KV pages in the torch port against the JAX package.

The plain versions of both paged kernels' e4m3 instances against the
reference's Pallas kernels in interpret mode over the same float8 pages
(GQA, ALiBi, ragged rows, sentinels), the gather path, the routing (a
float8 pool takes the kernels), the CPU wrappers (plain version, no
launch counted), and the batching engine over a float8 pool: its greedy
tokens equal the float8 ``InferenceEngine``'s, as the reference holds
its own two engines (``tests/test_batching.py``).  Floats agree to
rtol/atol 2e-4, tokens exactly.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

TOL = dict(rtol=2e-4, atol=2e-4)
F8 = torch.float8_e4m3fn
DECODE = [dict(nh=4, nkv=2, hd=16, bt=8, W=4, lens=[5, 8, 17]),
          dict(nh=8, nkv=1, hd=8, bt=16, W=3, lens=[1, 33, 48]),
          dict(nh=8, nkv=4, hd=8, bt=24, W=5, lens=[25, 120, 24, 1])]
PREFILL = [dict(nh=4, nkv=2, hd=16, bt=8, W=6, chunk=8, starts=[0, 8, 19]),
           dict(nh=8, nkv=2, hd=8, bt=8, W=8, chunk=5, starts=[3, 0, 40]),
           dict(nh=4, nkv=4, hd=8, bt=8, W=5, chunk=17, starts=[1, 20])]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _fp8_case(rng, b, nkv, hd, bt, W, lens):
    """float8 pools for per-row lengths ``lens`` under shuffled page ids
    (sentinels N and N + 7), as reference arrays and as the port's pools
    with the drop page."""
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
    ref, port = [], []
    for _ in range(2):
        x = (rng.standard_normal((N, nkv, bt, hd)) * 2).astype(np.float32)
        codes = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
        ref.append(jnp.asarray(codes))
        raw = np.concatenate([codes.view(np.uint8),
                              np.zeros((1, nkv, bt, hd), np.uint8)])
        port.append(_t(raw).view(F8))
    return ref, port, tables


def _slopes(nh, alibi):
    if not alibi:
        return None, None
    return ref_alibi_slopes(nh), alibi_slopes(nh)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", DECODE)
def test_fp8_decode_plain_matches_reference_kernel(case, alibi):
    """The decode kernel's e4m3 instance, plain version, against
    ``_paged_kernel`` over float8 pages in interpret mode and against the
    reference's gather; the CPU wrapper takes the plain version and
    counts no launch."""
    rng = np.random.default_rng(len(str(case)) + alibi)
    lens = np.asarray(case["lens"], np.int32)
    b = len(lens)
    (rk, rv), (tk, tv), tables = _fp8_case(
        rng, b, case["nkv"], case["hd"], case["bt"], case["W"], lens)
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
    gathered = ref_pa.paged_gather_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(tables),
        jnp.asarray(lens - 1)[:, None], rs)
    np.testing.assert_allclose(got.numpy(), np.asarray(gathered), **TOL)
    before = pa.paged_flash_attention.fp8_launches
    via = pa.paged_flash_attention(_t(q), tk, tv, _t(tables), _t(lens), ps)
    assert pa.paged_flash_attention.fp8_launches == before
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    split = pa.paged_decode_split_plain(_t(q), tk, tv, _t(tables), _t(lens),
                                        ps)
    np.testing.assert_allclose(split.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", PREFILL)
def test_fp8_prefill_plain_matches_reference_kernel(case, alibi):
    """The prefill kernel's e4m3 instance, plain version, against
    ``_paged_prefill_kernel`` over float8 pages in interpret mode, and
    the port's gather path on the same pages."""
    rng = np.random.default_rng(len(str(case)) + alibi)
    starts, chunk = case["starts"], case["chunk"]
    b = len(starts)
    (rk, rv), (tk, tv), tables = _fp8_case(
        rng, b, case["nkv"], case["hd"], case["bt"], case["W"],
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
    np.testing.assert_allclose(gathered.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [1, 6])
def test_fp8_pool_takes_the_kernels_route(chunk):
    """The hook writes a chunk into a float8 pool with the reference's
    codes, and routes it to a kernel wrapper, as a full-width pool."""
    nh, nkv, hd, bt, W, N = 4, 2, 16, 8, 3, 6
    rng = np.random.default_rng(chunk)
    k = (rng.standard_normal((1, chunk, nkv, hd)) * 300).astype(np.float32)
    pos = (5 + np.arange(chunk, dtype=np.int32))[None]
    tables = np.array([[4, 1, N]], np.int32)
    pool = torch.zeros((N + 1, nkv, bt, hd), dtype=F8)
    vpool = pool.clone()
    impl, bind = pa.make_paged_attn_impl(bt, "auto", num_pages=N)
    bind(_t(tables))
    q = torch.zeros((1, chunk, nh, hd))
    impl(q, _t(k), _t(k), pool, vpool, _t(pos).long(), 0, None)
    ref_pool = jnp.zeros((N, nkv, bt, hd), jnp.float8_e4m3fn)
    want, _ = ref_pa.write_paged_kv(ref_pool, ref_pool, jnp.asarray(k),
                                    jnp.asarray(k), jnp.asarray(tables),
                                    jnp.asarray(pos))
    np.testing.assert_array_equal(pool[:N].view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
    assert pa.paged_route(True, chunk, nh // nkv, bt, None) == (
        "decode" if chunk == 1 else "prefill")
    assert pa._check_pages(pool, vpool, torch.bfloat16) is False
    with pytest.raises(ValueError, match="of q's dtype or float8"):
        pa._check_pages(pool.float(), pool.float(), torch.bfloat16)


def test_fp8_batching_equals_fp8_inference_engine():
    """Greedy tokens of the batching engine over a float8 pool (whole and
    chunked admission, and the mixed dispatch) equal the float8
    ``InferenceEngine``'s, prompt for prompt; the pool's pages are
    float8."""
    cfg = get_model_config("llama-test")
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    greedy = SamplingParams(greedy=True)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((5, 19, 33))]
    eng = InferenceEngine(cfg, params, max_seq=64, sampling=greedy,
                          kv_cache_dtype="float8_e4m3fn", device="cpu")
    assert eng.attn_backend == "plain"
    want = [eng.generate([p], 7).tokens[0].tolist() for p in prompts]
    for extra in (dict(), dict(prefill_chunk=8),
                  dict(prefill_chunk=8, decode_block=4,
                       mixed_token_budget=16)):
        with ContinuousBatchingEngine(
                cfg, params, max_seq=64, max_batch=4, sampling=greedy,
                kv_block_tokens=8, kv_cache_dtype="float8_e4m3fn",
                device="cpu", **extra) as bat:
            assert bat._pk.dtype == F8
            reqs = [bat.submit(p, 7) for p in prompts]
            got = [r.wait(timeout=60).tolist() for r in reqs]
            assert bat.kv_cache.snapshot()["blocks_used"] >= 0
        assert got == want, extra
    assert quant.resolve_kv_cache_dtype("float8_e4m3fn") is F8
    assert quant.resolve_kv_cache_dtype(F8) is F8
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        quant.resolve_kv_cache_dtype("float16")
    assert ml_dtypes.float8_e4m3fn(464.0) == 448.0
