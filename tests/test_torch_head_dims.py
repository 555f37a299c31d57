"""The torch port at the catalog's other head dims against the JAX package.

Head dims 80 (bloom3b), 96 (bloom1b1) and 256 (gemma), where the port's
CUDA kernels have instances as at 64 and 128.  The same numpy inputs go
through the reference's Pallas kernels (interpret mode, as the JAX
package's own tests run them) and the plain versions of the port's three
kernels, which its wrappers run on CPU tensors: the flash kernel, paged
decode and paged prefill, over full-width and int8 pages, with ALiBi at
80 and 96.  Then whole engines on a gemma-shaped config at hd 256 and a
bloom-shaped one at hd 80, derived here from the ``-test`` configs:
``InferenceEngine`` (the reference's flash kernel in interpret mode) and
``ContinuousBatchingEngine`` in plain mode and in mixed mode over int8
pages.  Floats agree to rtol/atol 2e-4, tokens exactly.  The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

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
from distributed_inference_demo_tpu.ops.flash_attention import \
    flash_attention as ref_flash_attention
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import (
    kv_pages_from_numpy, params_from_numpy)
from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

TOL = dict(rtol=2e-4, atol=2e-4)
# (nh, nkv, alibi) per head dim: gemma's MQA (g = 4 here), bloom's MHA
# with ALiBi, and GQA with ALiBi
HEADS = {256: (4, 1, False), 80: (2, 2, True), 96: (4, 2, True)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _slopes(nh, alibi):
    return (ref_alibi_slopes(nh), alibi_slopes(nh)) if alibi else (None, None)


def test_the_new_head_dims_are_the_catalogs():
    """Every catalog model's head dim has a kernel instance, in both
    wrappers; 80, 96 and 256 are bloom3b's, bloom1b1's and gemma's."""
    assert get_model_config("bloom3b").head_dim == 80
    assert get_model_config("bloom1b1").head_dim == 96
    assert get_model_config("gemma-2b").head_dim == 256
    assert get_model_config("gemma-7b").head_dim == 256
    assert fa.HEAD_DIMS == pa.HEAD_DIMS == (64, 80, 96, 128, 256)


@pytest.mark.parametrize("hd", [80, 96, 256])
def test_flash_plain_matches_reference_kernel(hd):
    nh, nkv, alibi = HEADS[hd]
    rng = np.random.RandomState(hd)
    b, chunk, max_seq, q_start = 2, 20, 48, 7
    q = rng.randn(b, chunk, nh, hd).astype(np.float32)
    kc = rng.randn(b, nkv, max_seq, hd).astype(np.float32)
    vc = rng.randn(b, nkv, max_seq, hd).astype(np.float32)
    rs, ps = _slopes(nh, alibi)
    kv_len = q_start + chunk
    before = fa.flash_attention.launches
    got = fa.flash_attention(_t(q), _t(kc), _t(vc), q_start, kv_len,
                             ps).numpy()
    assert fa.flash_attention.launches == before   # CPU: plain version
    want = ref_flash_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(q_start),
                               jnp.int32(kv_len), rs, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _pools(rng, pages, b, nkv, hd, bt, W, lens):
    """K/V pools for per-row lengths ``lens`` under shuffled page ids
    (sentinels N and N + 7 after each row's pages), as (reference pools,
    port pools, tables).  int8: quantized by the reference, carried
    across with the port's drop page."""
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
    raw = [rng.standard_normal((N, nkv, bt, hd)).astype(np.float32)
           for _ in range(2)]
    if pages == "full":
        return [jnp.asarray(x) for x in raw], [_t(x) for x in raw], tables
    ref = [ref_quant.quantize_kv_pages(jnp.asarray(x), 8) for x in raw]
    port = [kv_pages_from_numpy(np.asarray(p.data), np.asarray(p.scale),
                                None, 8, "cpu") for p in ref]
    return ref, port, tables


@pytest.mark.parametrize("pages", ["full", "int8"])
@pytest.mark.parametrize("hd", [80, 96, 256])
def test_paged_decode_plain_matches_reference_kernel(hd, pages):
    """Ragged rows over 8-token pages: mid-page, a page boundary, a
    1-token tail; the CPU wrapper takes the plain version, no launch."""
    nh, nkv, alibi = HEADS[hd]
    rng = np.random.default_rng(hd + len(pages))
    lens = np.asarray([5, 16, 33], np.int32)
    b, bt, W = len(lens), 8, 6
    (rk, rv), (tk, tv), tables = _pools(rng, pages, b, nkv, hd, bt, W, lens)
    q = rng.standard_normal((b, 1, nh, hd)).astype(np.float32)
    rs, ps = _slopes(nh, alibi)
    want = ref_pa.paged_flash_attention(jnp.asarray(q), rk, rv,
                                        jnp.asarray(tables),
                                        jnp.asarray(lens), rs,
                                        interpret=True)
    before = (pa.paged_flash_attention.launches,
              pa.paged_flash_attention.int8_launches)
    got = pa.paged_flash_attention(_t(q), tk, tv, _t(tables), _t(lens), ps)
    assert (pa.paged_flash_attention.launches,
            pa.paged_flash_attention.int8_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pages", ["full", "int8"])
@pytest.mark.parametrize("hd", [80, 96, 256])
def test_paged_prefill_plain_matches_reference_kernel(hd, pages):
    """Chunks from zero and from mid-page, over prior pages plus their
    own keys (already written)."""
    nh, nkv, alibi = HEADS[hd]
    rng = np.random.default_rng(hd + 10 * len(pages))
    starts, chunk = [0, 13], 9
    b, bt, W = len(starts), 8, 4
    lens = [s + chunk for s in starts]
    (rk, rv), (tk, tv), tables = _pools(rng, pages, b, nkv, hd, bt, W, lens)
    q = rng.standard_normal((b, chunk, nh, hd)).astype(np.float32)
    qpos = (np.asarray(starts)[:, None] + np.arange(chunk)).astype(np.int32)
    rs, ps = _slopes(nh, alibi)
    want = ref_pa.paged_prefill_attention(jnp.asarray(q), rk, rv,
                                          jnp.asarray(tables),
                                          jnp.asarray(qpos), rs,
                                          interpret=True)
    before = (pa.paged_prefill_attention.launches,
              pa.paged_prefill_attention.int8_launches)
    got = pa.paged_prefill_attention(_t(q), tk, tv, _t(tables),
                                     _t(qpos).long(), ps)
    assert (pa.paged_prefill_attention.launches,
            pa.paged_prefill_attention.int8_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# whole engines at hd 256 (gemma-shaped) and hd 80 (bloom-shaped)

# gemma-test keeps its 4 q heads on 1 kv head, GeGLU and embedding scale,
# at gemma's head dim; bloom-test keeps its 4 heads and ALiBi at bloom3b's
SHAPED = {"gemma-hd256": ("gemma-test", dict(head_dim_override=256), 256),
          "bloom-hd80": ("bloom-test", dict(hidden_size=320), 80)}
NEW = 8
# the mixed dispatch over int8 pages: 8-token chunks, a 24-token budget
# (3 segments), fused decode blocks of 4, as the reference's mixed test
BATCH = dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
             kv_block_tokens=8, prefill_chunk=8)
MIXED = dict(BATCH, decode_block=4, mixed_token_budget=24, kv_dtype="int8")


@pytest.fixture(scope="module", params=list(SHAPED))
def shaped(request):
    """(ref cfg, ref params, port cfg, port params, prompt [3, 27])."""
    base, kw, hd = SHAPED[request.param]
    rcfg = ref_get_model_config(base).replace(**kw)
    cfg = get_model_config(base).replace(**kw)
    assert cfg.head_dim == rcfg.head_dim == hd
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                           (3, 27)).astype(np.int32)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu"), ids


def test_inference_engine_matches_reference(shaped):
    """The reference on its Pallas flash kernel (interpret mode) against
    the port's engine: greedy tokens, their logprobs, prefill logits."""
    rcfg, rp, cfg, params, ids = shaped
    ref = RefEngine(rcfg, rp, max_seq=64,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="flash-interpret")
    port = InferenceEngine(cfg, params, max_seq=64,
                           sampling=SamplingParams(greedy=True),
                           device="cpu")
    r = ref.generate(ids, NEW, logprobs=True)
    p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
    rl, _ = ref._run_prefill(jnp.asarray(ids), ref.new_cache(len(ids)))
    np.testing.assert_allclose(port.prefill_logits(ids), np.asarray(rl),
                               **TOL)


@pytest.mark.parametrize("mode", ["plain", "mixed-int8"])
def test_batching_engine_matches_reference(shaped, mode):
    """The batching engines, each row its own request over 8-token pages
    with chunked admission: in plain mode over full-width pages, and in
    the mixed dispatch over int8 pages.  The port runs its kernels' plain
    versions; tokens equal, logprobs within 2e-4."""
    rcfg, rp, cfg, params, ids = shaped
    kw = BATCH if mode == "plain" else MIXED
    with RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                     **kw) as ref:
        r = ref.generate(ids, NEW, logprobs=True)
    with ContinuousBatchingEngine(cfg, params,
                                  sampling=SamplingParams(greedy=True),
                                  device="cpu", **kw) as port:
        p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
