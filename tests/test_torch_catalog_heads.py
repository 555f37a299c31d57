"""The torch port at the catalog's remaining head layouts against the JAX
package.

qwen2.5's 7 q heads a kv head (qwen2.5-0.5b 14/2, qwen2.5-7b 28/4),
bloom7b1's ALiBi at hd 128 and gemma-7b's 16 heads on 16 at hd 256.
The same numpy inputs go through the reference's Pallas kernels
(interpret mode, as the JAX package's own tests run them) and the plain
versions of the port's three kernels, which its wrappers run on CPU
tensors: the flash kernel, paged decode and paged prefill over
full-width and int8 pages.  Then whole engines: ``InferenceEngine`` (the
reference's flash kernel in interpret mode) and ``ContinuousBatchingEngine``
in plain mode and in the mixed dispatch over int8 pages on a qwen2-shaped
config at g = 7 derived from ``qwen2-test``; ``SpeculativeEngine`` and
speculative batching with a ``bloom-test``-shaped target and a smaller
``bloom-test``-shaped draft (ALiBi in both).  Floats agree to rtol/atol
2e-4, tokens and the speculative counters exactly.  The kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda_catalog.py`` and ``chip_smoke.py``.
"""

import dataclasses

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
from distributed_inference_demo_tpu.runtime import speculative as ref_spec
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
from distributed_inference_demo_tpu_torch.runtime.speculative import \
    SpeculativeEngine

TOL = dict(rtol=2e-4, atol=2e-4)
# (nh, nkv, hd, alibi): g = 7 at a small head dim, ALiBi at 128 (MHA, as
# bloom7b1), MHA at 256 (as gemma-7b)
HEADS = {"g7": (14, 2, 16, False), "alibi-hd128": (4, 4, 128, True),
         "mha-hd256": (2, 2, 256, False)}
GREEDY = SamplingParams(greedy=True)


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


def test_the_layouts_are_the_catalogs():
    """The catalog's models these layouts stand for."""
    def heads(name):
        c = get_model_config(name)
        return c.num_heads, c.num_kv_heads, c.head_dim, c.use_alibi
    assert heads("qwen2.5-0.5b") == (14, 2, 64, False)
    assert heads("qwen2.5-7b") == (28, 4, 128, False)
    assert heads("bloom7b1") == (32, 32, 128, True)
    assert heads("gemma-7b") == (16, 16, 256, False)
    assert heads("bloom560m") == (16, 16, 64, True)
    for name in ("qwen2.5-0.5b", "qwen2.5-7b", "gemma-7b", "bloom7b1"):
        assert get_model_config(name).head_dim in fa.HEAD_DIMS


@pytest.mark.parametrize("chunk,q_start", [(9, 0), (5, 11)])
@pytest.mark.parametrize("layout", list(HEADS))
def test_flash_plain_matches_reference_kernel(layout, chunk, q_start):
    """At g = 7 a 9-token chunk is 63 regrouped rows and a 5-token one
    35, neither a multiple of 8 or 16."""
    nh, nkv, hd, alibi = HEADS[layout]
    rng = np.random.RandomState(hd + chunk)
    b, max_seq = 2, 24
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
    port pools, tables); int8 pages quantized by the reference."""
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
@pytest.mark.parametrize("layout", list(HEADS))
def test_paged_decode_plain_matches_reference_kernel(layout, pages):
    """Ragged rows over 8-token pages: mid-page, a page boundary, a
    1-token row; the CPU wrapper takes the plain version, no launch."""
    nh, nkv, hd, alibi = HEADS[layout]
    rng = np.random.default_rng(hd + len(pages))
    lens = np.asarray([5, 16, 1, 23], np.int32)
    b, bt, W = len(lens), 8, 4
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
@pytest.mark.parametrize("layout", list(HEADS))
def test_paged_prefill_plain_matches_reference_kernel(layout, pages):
    """Chunks from zero and from mid-page (at g = 7, 9 tokens are 63
    rows), over prior pages plus their own keys."""
    nh, nkv, hd, alibi = HEADS[layout]
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
# whole engines


def _bridge(rp, cfg):
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    return params_from_numpy(tree, cfg, "cpu")


# qwen2-test at 14 q heads on 2 kv heads of 16 (g = 7), qkv biases kept
QWEN_G7 = dict(hidden_size=224, num_heads=14, num_kv_heads=2)
NEW = 8
# the mixed dispatch over int8 pages: 8-token chunks, a 24-token budget
# (3 segments), fused decode blocks of 4, as the reference's mixed test
BATCH = dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
             kv_block_tokens=8, prefill_chunk=8)
MIXED = dict(BATCH, decode_block=4, mixed_token_budget=24, kv_dtype="int8")


@pytest.fixture(scope="module")
def qwen_g7():
    """(ref cfg, ref params, port cfg, port params, prompts [3, 21])."""
    rcfg = ref_get_model_config("qwen2-test").replace(**QWEN_G7)
    cfg = get_model_config("qwen2-test").replace(**QWEN_G7)
    assert cfg.num_heads // cfg.num_kv_heads == 7 and cfg.attn_qkv_bias
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                           (3, 21)).astype(np.int32)
    return rcfg, rp, cfg, _bridge(rp, cfg), ids


def test_inference_engine_matches_reference_at_g7(qwen_g7):
    """The reference on its Pallas flash kernel (interpret mode) against
    the port's engine: greedy tokens, their logprobs, prefill logits."""
    rcfg, rp, cfg, params, ids = qwen_g7
    ref = RefEngine(rcfg, rp, max_seq=64,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="flash-interpret")
    port = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY,
                           device="cpu")
    r = ref.generate(ids, NEW, logprobs=True)
    p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
    rl, _ = ref._run_prefill(jnp.asarray(ids), ref.new_cache(len(ids)))
    np.testing.assert_allclose(port.prefill_logits(ids), np.asarray(rl),
                               **TOL)


@pytest.mark.parametrize("mode", ["plain", "mixed-int8"])
def test_batching_engine_matches_reference_at_g7(qwen_g7, mode):
    """Each row its own request over 8-token pages with chunked
    admission, plain over full-width pages and the mixed dispatch over
    int8 pages: tokens equal, logprobs within 2e-4."""
    rcfg, rp, cfg, params, ids = qwen_g7
    kw = BATCH if mode == "plain" else MIXED
    with RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                     **kw) as ref:
        r = ref.generate(ids, NEW, logprobs=True)
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  device="cpu", **kw) as port:
        p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)


@pytest.fixture(scope="module")
def blooms():
    """bloom-test (4 layers, ALiBi) as the target and bloom-test at 2
    layers from another seed as the draft, reference and port."""
    rcfg = ref_get_model_config("bloom-test")
    rdcfg = dataclasses.replace(rcfg, num_layers=2)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    rdp = ref_init_full_params(jax.random.PRNGKey(1), rdcfg)
    cfg = get_model_config("bloom-test")
    dcfg = dataclasses.replace(cfg, num_layers=2)
    assert cfg.use_alibi and dcfg.use_alibi
    return dict(rcfg=rcfg, rp=rp, rdcfg=rdcfg, rdp=rdp, cfg=cfg,
                p=_bridge(rp, cfg), dcfg=dcfg, dp=_bridge(rdp, dcfg))


def test_speculative_engine_matches_reference_with_alibi(blooms):
    """``SpeculativeEngine`` with an ALiBi draft, K = 4, b = 2: greedy
    tokens equal the reference engine's and plain decode's, and the
    round counters equal the reference's."""
    m = blooms
    prompt = np.asarray([[3, 14, 15, 92, 65, 35], [1, 2, 3, 4, 5, 6]])
    ref = ref_spec.SpeculativeEngine(
        m["rcfg"], m["rp"], m["rdcfg"], m["rdp"], max_seq=96,
        sampling=RefSamplingParams(greedy=True), num_draft=4)
    rres, rstats = ref.generate(prompt, 20)
    port = SpeculativeEngine(m["cfg"], m["p"], m["dcfg"], m["dp"],
                             max_seq=96, sampling=GREEDY, num_draft=4,
                             device="cpu")
    res, stats = port.generate(prompt, 20)
    np.testing.assert_array_equal(res.tokens, rres.tokens)
    plain = InferenceEngine(m["cfg"], m["p"], max_seq=96, sampling=GREEDY,
                            device="cpu")
    np.testing.assert_array_equal(res.tokens,
                                  plain.generate(prompt, 20).tokens)
    assert vars(stats) == vars(rstats)
    assert stats.rounds >= 1


def test_speculative_batching_matches_reference_with_alibi(blooms):
    """Speculative batching, serialized (decode blocks of 3, K = 3,
    chunked admission), the ALiBi draft: requests one after another,
    tokens equal the reference engine's and plain decode's, and the
    ``speculative`` fragment equals the reference's."""
    m = blooms
    kw = dict(max_seq=96, max_batch=4, prompt_buckets=(16, 64),
              kv_block_tokens=8, num_draft=3, decode_block=3,
              prefill_chunk=8)
    requests = [([3, 14, 15, 92, 65], 12), (list(range(3, 22)), 10),
                ([1], 8)]
    plain = InferenceEngine(m["cfg"], m["p"], max_seq=96, sampling=GREEDY,
                            device="cpu")
    ref = RefBatching(m["rcfg"], m["rp"],
                      sampling=RefSamplingParams(greedy=True),
                      draft_cfg=m["rdcfg"], draft_params=m["rdp"], **kw)
    port = ContinuousBatchingEngine(m["cfg"], m["p"], sampling=GREEDY,
                                    draft_cfg=m["dcfg"],
                                    draft_params=m["dp"], device="cpu",
                                    **kw)
    try:
        for prompt, n in requests:
            got = port.submit(prompt, n).wait(timeout=120).tolist()
            want = ref.submit(prompt, n).wait(timeout=120).tolist()
            oracle = plain.generate(np.asarray(prompt)[None, :],
                                    n).tokens[0].tolist()
            assert got == want == oracle
        assert port.stats()["speculative"] == ref.stats()["speculative"]
        assert port.stats()["speculative"]["proposer"] == "draft"
    finally:
        port.close()
        ref.close()
