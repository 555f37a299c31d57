"""The torch port's prompt-lookup speculation against the JAX package's.

``ngram_propose`` exactly on random histories (``hist_len`` 1 and 2,
rows with no match, matches near the end), then ``PromptLookupEngine``
on ``llama-test`` (f32, the reference's weights through
``models/bridge.py``): greedy tokens and ``SpecStats`` equal the
reference engine's and the port's ``InferenceEngine``'s, on a prompt
whose continuation the lookup accepts; chunked prefill against whole,
the prefix pool, the float8 cache, dispatch-size invariance, stream =
generate, eos padding and early stop, the capacity guard, sampled
determinism, and ``-int8`` weights against the plain engine on the same
codes.
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
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime import prompt_lookup as ref_pl
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.loader import load_or_init
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.prompt_lookup import (
    PromptLookupEngine, ngram_propose)
from distributed_inference_demo_tpu_torch.runtime.speculative import \
    SpecStats

MAX_SEQ = 160
GREEDY = SamplingParams(greedy=True)
# greedy decode of the seed-0 test model loops on a tiled motif, which
# the lookup then accepts (the reference's own repetitive prompt)
MOTIF = list(np.arange(16) * 7 % 250)
REP = np.asarray([MOTIF * 4])


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_model_config("llama-test")
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def oracle(models):
    return InferenceEngine(models[2], models[3], max_seq=MAX_SEQ,
                           sampling=GREEDY, device="cpu")


def _pl(models, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("num_draft", 4)
    return PromptLookupEngine(models[2], models[3], device="cpu", **kw)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_matches_reference(seed):
    """Random [b, cap] histories over a small vocabulary (so bigrams and
    unigrams repeat), with per-row lengths from 1 up to cap, a row with
    no match (all distinct) and ragged garbage past each length."""
    rng = np.random.RandomState(seed)
    b, cap, K = 6, 40, 1 + seed % 4
    hist = rng.randint(0, 5 + seed, (b, cap)).astype(np.int32)
    hist[0] = np.arange(cap)                       # no match anywhere
    lens = np.asarray([cap, 1, 2, 3, rng.randint(4, cap), cap - 1],
                      np.int32)
    want = ref_pl.ngram_propose(jnp.asarray(hist), jnp.asarray(lens), K)
    got = ngram_propose(torch.from_numpy(hist).long(),
                        torch.from_numpy(lens).long(), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_matches_reference_and_target_only(models, oracle):
    rcfg, rp = models[:2]
    ref = ref_pl.PromptLookupEngine(rcfg, rp, max_seq=MAX_SEQ,
                                    sampling=RefSamplingParams(greedy=True),
                                    num_draft=4)
    for prompt, n in ((REP, 48), (np.asarray([[3, 14, 15, 92, 65],
                                               [1, 2, 3, 4, 5]]), 20)):
        rres, rstats = ref.generate(prompt, n)
        res, stats = _pl(models).generate(prompt, n)
        np.testing.assert_array_equal(res.tokens, rres.tokens)
        np.testing.assert_array_equal(res.tokens,
                                      oracle.generate(prompt, n).tokens)
        assert vars(stats) == vars(rstats)
    assert stats.rounds >= 1
    assert _pl(models).generate(REP, 48)[1].acceptance_rate > 0


@pytest.mark.parametrize("plen", [5, 23, 64])
def test_chunked_prefill_matches_whole(models, plen):
    prompt = REP[:, :plen]
    whole, _ = _pl(models).generate(prompt, 16)
    chunked, _ = _pl(models, prefill_chunk=8).generate(prompt, 16)
    np.testing.assert_array_equal(whole.tokens, chunked.tokens)


def test_prefix_pool_and_float8_cache(models, oracle):
    eng = _pl(models, kv_cache_blocks=16, kv_block_tokens=8)
    for p in (REP[:, :24], REP[:, :40]):
        np.testing.assert_array_equal(eng.generate(p, 12)[0].tokens,
                                      oracle.generate(p, 12).tokens)
    assert eng.kv_cache.snapshot()["hits"] == 1
    base = InferenceEngine(models[2], models[3], max_seq=MAX_SEQ,
                           sampling=GREEDY, kv_cache_dtype="float8_e4m3fn",
                           device="cpu")
    fp8 = _pl(models, kv_cache_dtype="float8_e4m3fn")
    np.testing.assert_array_equal(fp8.generate(REP, 24)[0].tokens,
                                  base.generate(REP, 24).tokens)


def test_dispatch_size_invariance_stream_and_eos(models):
    eng = _pl(models)
    want = eng.generate(REP, 30)[0].tokens
    for r in (1, 5):
        np.testing.assert_array_equal(
            eng.generate(REP, 30, rounds_per_dispatch=r)[0].tokens, want)
    st = SpecStats()
    streamed = np.stack(list(eng.generate_stream(REP, 30, stats_out=st)), 1)
    np.testing.assert_array_equal(streamed, want)
    assert st.emitted == 30
    eos = int(want[0, 6])
    base = InferenceEngine(models[2], models[3], max_seq=MAX_SEQ,
                           sampling=GREEDY, eos_id=eos, device="cpu")
    res, stats = _pl(models, eos_id=eos).generate(REP, 30)
    np.testing.assert_array_equal(res.tokens, base.generate(REP, 30).tokens)
    assert stats.emitted < 30


def test_refusals_and_sampled_determinism(models):
    with pytest.raises(ValueError, match="exceeds KV-cache capacity"):
        _pl(models).generate(REP, MAX_SEQ)
    with pytest.raises(ValueError, match="num_draft"):
        _pl(models, num_draft=0)
    eng = _pl(models, sampling=SamplingParams(temperature=0.9, top_k=40))
    a, _ = eng.generate(REP, 20, seed=1)
    b, _ = eng.generate(REP, 20, seed=1)
    c, _ = eng.generate(REP, 20, seed=2)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)
    assert ((a.tokens >= 0) & (a.tokens < 256)).all()


def test_int8_weights_match_plain_engine():
    """``-int8`` weights: the verify forward goes through the quantized
    ``dense`` (on the card the decode kernel, M = K + 1), and greedy
    tokens equal the plain engine's on the same codes."""
    cfg = get_model_config("llama-test-int8")
    params = load_or_init("llama-test-int8", cfg, None, seed=0,
                          device="cpu")
    plain = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=GREEDY,
                            device="cpu")
    eng = PromptLookupEngine(cfg, params, max_seq=MAX_SEQ, sampling=GREEDY,
                             device="cpu")
    np.testing.assert_array_equal(eng.generate(REP, 32)[0].tokens,
                                  plain.generate(REP, 32).tokens)
