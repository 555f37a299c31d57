"""The torch port's ``InferenceEngine`` against the JAX package's.

Same weights (the reference's init, carried across by
``params_from_numpy``), same prompts: greedy tokens and
``steps_computed`` equal exactly, logits and logprobs agree to 2e-4, for
whole and chunked prefill, ``stream_block`` 1 and K, eos and stop ids.
The reference runs its flash hook in interpret mode; the port on the CPU
runs plain attention.
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
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.engine import (
    InferenceEngine, resolve_attn_backend, run_chunked_prefill)

MAX_SEQ, NEW = 64, 12
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny shapes gain nothing from many intra-op threads; cap them so
    parallel test workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _numpy_tree(rp):
    return {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}


@pytest.fixture(scope="module", params=["llama-test", "bloom-test"])
def models(request):
    """(ref cfg, ref params, port cfg, port params, prompt [2, 37])."""
    name = request.param
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_model_config(name)
    params = params_from_numpy(_numpy_tree(rp), cfg, "cpu")
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                           (2, 37)).astype(np.int32)
    return rcfg, rp, cfg, params, ids


def _engines(models, **kw):
    rcfg, rp, cfg, params, _ = models
    ref = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="flash-interpret", **kw)
    port = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                           sampling=SamplingParams(greedy=True),
                           device="cpu", **kw)
    return ref, port


def _stream(engine, ids, k, logprobs=False):
    engine.stream_block = k
    items = list(engine.generate_stream(ids, NEW, logprobs=logprobs))
    if logprobs:
        return (np.stack([t for t, _ in items], 1),
                np.stack([lp for _, lp in items], 1))
    return np.stack(items, 1)


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_greedy_generation_matches_reference(models, prefill_chunk):
    ids = models[4]
    ref, port = _engines(models, prefill_chunk=prefill_chunk)
    r = ref.generate(ids, NEW, logprobs=True)
    p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    assert p.steps_computed == r.steps_computed == NEW
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
    rl, _ = ref._run_prefill(jnp.asarray(ids), ref.new_cache(2))
    np.testing.assert_allclose(port.prefill_logits(ids), np.asarray(rl),
                               **TOL)
    for k in (1, 4):
        np.testing.assert_array_equal(_stream(port, ids, k), r.tokens)
    np.testing.assert_array_equal(_stream(ref, ids, 4), r.tokens)
    toks, lps = _stream(port, ids, 1, logprobs=True)
    np.testing.assert_allclose(lps, r.logprobs, **TOL)
    assert port.loop_stats["device_loop_steps"] == NEW * 4


def test_eos_and_stop_ids_match_reference(models):
    ids = models[4]
    ref, port = _engines(models)
    free = ref.generate(ids, NEW).tokens
    # eos: a token row 0 emits at step 3, so that row ends early
    eos = int(free[0, 3])
    stop = int(free[1, 5])
    ref_s, port_s = _engines(models, stop_token_ids=[stop])
    steps = []
    for (r_eng, p_eng), eos_id in (((ref, port), eos), ((ref_s, port_s), None),
                                   ((ref_s, port_s), eos)):
        r_eng.eos_id = p_eng.eos_id = eos_id
        r = r_eng.generate(ids, NEW)
        p = p_eng.generate(ids, NEW)
        np.testing.assert_array_equal(p.tokens, r.tokens)
        assert p.steps_computed == r.steps_computed
        steps.append(p.steps_computed)
        for k in (1, 4):
            r_eng.stream_block = p_eng.stream_block = k
            rs = list(r_eng.generate_stream(ids, NEW))
            ps = list(p_eng.generate_stream(ids, NEW))
            assert len(ps) == len(rs)
            np.testing.assert_array_equal(np.stack(ps), np.stack(rs))
    assert min(steps) < NEW      # eos + stop id ended every row early


def test_chunked_prefill_aligned_last_window():
    """A prompt whose padded length would spill past max_seq: the last
    window shifts left, no write passes max_seq, the length rewinds, and
    the logits equal a whole-prompt prefill's."""
    cfg = get_model_config("llama-test")
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ids = np.random.RandomState(6).randint(0, cfg.vocab_size, (1, 45))
    whole = InferenceEngine(cfg, params, max_seq=48, device="cpu")
    chunked = InferenceEngine(cfg, params, max_seq=48, prefill_chunk=16,
                              device="cpu")
    np.testing.assert_allclose(chunked.prefill_logits(ids),
                               whole.prefill_logits(ids), rtol=1e-5,
                               atol=1e-5)
    starts = []

    def mid(x, cache, start):
        starts.append(("mid", start, cache.length))
        return chunked._chunk_mid(x, cache, start)

    def last(x, cache, start, idx):
        starts.append(("last", start, cache.length, idx))
        return chunked._chunk_last(x, cache, start, idx)

    _, cache = run_chunked_prefill(torch.as_tensor(ids), chunked.new_cache(1),
                                   16, 48, mid, last)
    assert starts == [("mid", 0, 0), ("mid", 16, 16),
                      ("last", 32, 32, 12)]
    assert cache.length == 45


def test_sampled_generation_is_seeded_and_scores_raw_logprobs():
    cfg = get_model_config("llama-test")
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                          sampling=SamplingParams(temperature=0.8, top_k=5))
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 9))
    a = eng.generate(ids, 6, seed=1, logprobs=True)
    b = eng.generate(ids, 6, seed=1, logprobs=True)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.dtype == np.int32 and a.tokens.shape == (2, 6)
    assert (a.logprobs <= 0).all() and np.isfinite(a.logprobs).all()
    streamed = list(eng.generate_stream(ids, 6, seed=1))
    np.testing.assert_array_equal(np.stack(streamed, 1), a.tokens)


def test_engine_refuses_what_this_slice_does_not_port(monkeypatch):
    cfg = get_model_config("llama-test")
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        InferenceEngine(cfg, params, attn_backend="flash", device="cpu")
    with pytest.raises(ValueError, match="attn_backend"):
        InferenceEngine(cfg, params, attn_backend="jnp", device="cpu")
    # the KV options are ported: each builds its pool or cast
    assert InferenceEngine(cfg, params, kv_cache_blocks=4,
                           device="cpu").kv_cache.num_blocks == 4
    assert InferenceEngine(cfg, params, kv_block_tokens=16,
                           device="cpu").kv_cache is None
    assert InferenceEngine(cfg, params, kv_cache_dtype="float8_e4m3fn",
                           device="cpu").attn_backend == "plain"
    assert InferenceEngine(cfg, params, kv_cache_blocks=4, kv_dtype="int8",
                           device="cpu").kv_cache.kv_dtype == "int8"
    # so is the tier below the pool, from its env knob; a disk segment
    # without the host ring above it is the reference's own refusal
    monkeypatch.setenv("DWT_KV_HOST_TIER_BYTES", str(1 << 20))
    assert InferenceEngine(cfg, params, kv_cache_blocks=4,
                           device="cpu").kv_cache.tier is not None
    monkeypatch.delenv("DWT_KV_HOST_TIER_BYTES")
    monkeypatch.setenv("DWT_KV_DISK_TIER_PATH", "/x")
    monkeypatch.setenv("DWT_KV_DISK_TIER_BYTES", "1024")
    with pytest.raises(ValueError, match="BELOW the host ring"):
        InferenceEngine(cfg, params, kv_cache_blocks=4, device="cpu")
    monkeypatch.delenv("DWT_KV_DISK_TIER_PATH")
    monkeypatch.delenv("DWT_KV_DISK_TIER_BYTES")
    eng = InferenceEngine(cfg, params, max_seq=16, kv_layout="paged",
                          device="cpu")
    with pytest.raises(ValueError, match="exceeds KV-cache capacity"):
        eng.generate(np.zeros((1, 10), np.int32), 7)
    assert eng.classify(np.zeros((2, 3), np.int32), [1, 2, 3]).shape == (2,)


@pytest.mark.parametrize("backend,device_type,head_dim,want", [
    ("auto", "cpu", 64, "plain"),
    ("auto", "cpu", 256, "plain"),
    ("auto", "cuda", 64, "flash"),
    ("auto", "cuda", 128, "flash"),
    ("auto", "cuda", 80, "flash"),      # bloom3b
    ("auto", "cuda", 96, "flash"),      # bloom1b1
    ("auto", "cuda", 256, "flash"),     # gemma
    ("flash", "cuda", 64, "flash"),
    ("plain", "cuda", 256, "plain"),
    ("auto", "cuda", 48, "--attn-backend plain"),
    ("flash", "cuda", 48, "--attn-backend plain"),
    ("flash", "cpu", 64, "CUDA kernel"),
    ("jnp", "cuda", 64, "unknown attn_backend"),
])
def test_attn_backend_never_gives_way_to_plain_on_the_card(
        backend, device_type, head_dim, want):
    """On CUDA "auto" is always the kernel hook: a head dim the kernel
    does not take (48, which no catalog model has) raises, naming the
    explicit plain choice, instead of running plain attention on the
    card."""
    if want in ("plain", "flash"):
        assert resolve_attn_backend(backend, device_type, head_dim) == want
    else:
        with pytest.raises(ValueError, match=want):
            resolve_attn_backend(backend, device_type, head_dim)


def test_cuda_is_the_default_and_is_never_dropped_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model_config("llama-test")
    with pytest.raises(RuntimeError, match="--device cpu"):
        init_full_params(torch.Generator(), cfg)
    params = init_full_params(torch.Generator(), cfg, "cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        InferenceEngine(cfg, params)
