"""The torch port's ``ContinuousBatchingEngine`` against the JAX package's.

``llama-test`` in f32, the reference's weights carried across by
``models/bridge.py``.  The same submissions go to a reference engine and
a port engine of the same configuration (three configurations, each
built once): greedy streams must be equal token for token, and equal to
the port's ``InferenceEngine``, under concurrent ragged submissions with
a late joiner and a prefix hit, chunked admission, and ``decode_block=4``
with an eos early exit.  Then the port's own invariants: an
oversubscribed pool requeues and completes, cancel / failure / close
return every page, queue-depth shedding, a request larger than the pool
is refused, sampled rows score finite logprobs <= 0.  The port runs on
the CPU, where its paged kernels run their plain versions.
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.overload import \
    SchedulerOverloaded

MAX_SEQ = 96
GREEDY = SamplingParams(greedy=True)
WAIT = 120
# (name, engine kwargs) of the three configurations run on both packages
CONFIGS = {
    "plain": dict(max_batch=4, prompt_buckets=(16, 64),
                  kv_block_tokens=8),
    "chunked": dict(max_batch=4, prompt_buckets=(16, 64),
                    kv_block_tokens=8, prefill_chunk=16),
    "fused": dict(max_batch=4, prompt_buckets=(16, 64), kv_block_tokens=8,
                  decode_block=4),
}


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


@pytest.fixture(scope="module")
def oracle(weights):
    _, _, cfg, params = weights
    return InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=GREEDY,
                           device="cpu")


def expected(oracle, prompt, n, eos=None):
    """The port InferenceEngine's greedy tokens, cut after eos."""
    toks = oracle.generate(np.asarray(prompt)[None, :], n).tokens[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[:toks.index(eos) + 1]
    return toks


PROMPTS = [np.random.RandomState(i).randint(0, 256, n).tolist()
           for i, n in enumerate((3, 9, 20, 5, 7, 40, 33))]


@pytest.fixture(scope="module")
def eos(oracle):
    """(eos id, step): the fused configuration's eos is the first token
    PROMPTS[1] decodes for the first time at step 2, 3 or 4, so the
    row ends inside the first fused block."""
    toks = expected(oracle, PROMPTS[1], 12)
    step = next(j for j in (2, 3, 4) if toks[j] not in toks[:j])
    return toks[step], step


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, weights, eos):
    """(name, reference engine, port engine) of one configuration."""
    rcfg, rp, cfg, params = weights
    kw = dict(CONFIGS[request.param], max_seq=MAX_SEQ)
    if request.param == "fused":
        kw["eos_id"] = eos[0]
    ref = RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                      **kw)
    port = ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                    device="cpu", **kw)
    yield request.param, ref, port
    port.close()
    ref.close()


def no_page_leak(eng) -> bool:
    """Every page is free or an evictable radix leaf: the whole pool
    allocates (evicting the tree), and freeing it restores free_blocks."""
    mgr = eng.kv_cache
    ids = mgr.alloc(mgr.num_blocks)
    if ids is None:
        return False
    mgr.free(ids)
    return mgr.free_blocks == mgr.num_blocks


def _scenario(name, eng):
    """The configuration's submissions on one engine: tokens per request
    (in submission order) and the radix counters."""
    def wait(reqs):
        return [r.wait(timeout=WAIT).tolist() for r in reqs]

    if name == "plain":
        # concurrent ragged rows, a late joiner, then a prefix hit: the
        # 20-token prompt's first two 8-token blocks
        first = [eng.submit(p, n) for p, n in
                 zip(PROMPTS[:4], (10, 14, 8, 12))]
        first[0].wait(timeout=WAIT)
        late = eng.submit(PROMPTS[4], 9)
        toks = wait(first + [late])
        hit = PROMPTS[2][:16] + [1, 2, 3, 4]
        toks += wait([eng.submit(hit, 6)])
    elif name == "chunked":
        # two prompts over the 16-token chunk stream their admission; a
        # prompt sharing three blocks of the 40-token one then admits in
        # one dispatch
        reqs = [eng.submit(p, n) for p, n in
                zip([PROMPTS[5], PROMPTS[1], PROMPTS[6]], (8, 10, 7))]
        toks = wait(reqs)
        toks += wait([eng.submit(PROMPTS[5][:24] + [9] * 6, 5)])
    else:
        # decode_block=4: the first row ends at eos mid-block; alone, so
        # the fused loop's early exit shows in the step counts
        eng.reset_stats()
        toks = wait([eng.submit(PROMPTS[1], 12)])
        steps = dict(eng.loop_stats)
        toks += wait([eng.submit(p, n) for p, n in
                      zip([PROMPTS[0], PROMPTS[3], PROMPTS[2]], (9, 11, 7))])
        return toks, steps
    kv = eng.stats()["kvcache"]
    counters = {k: kv[k] for k in ("hits", "misses", "partial_hit_tokens",
                                   "stores", "stored_blocks")}
    if name == "chunked":
        counters["chunks"] = eng.chunk_stats["chunks"]
    return toks, counters


def test_greedy_streams_match_reference(pair, oracle, eos):
    name, ref, port = pair
    eos_id, eos_step = eos
    ref_toks, ref_counts = _scenario(name, ref)
    port_toks, port_counts = _scenario(name, port)
    assert port_toks == ref_toks
    assert port_counts == ref_counts
    assert no_page_leak(port)
    # ... and equal to the port's InferenceEngine, request by request
    if name == "plain":
        asks = list(zip(PROMPTS[:5], (10, 14, 8, 12, 9))) + [
            (PROMPTS[2][:16] + [1, 2, 3, 4], 6)]
        assert port_counts["hits"] == 1
        assert port_counts["partial_hit_tokens"] == 16
    elif name == "chunked":
        asks = [(PROMPTS[5], 8), (PROMPTS[1], 10), (PROMPTS[6], 7),
                (PROMPTS[5][:24] + [9] * 6, 5)]
        assert port_counts["chunks"] == 4 and port_counts["hits"] == 1
    else:
        asks = [(PROMPTS[1], 12), (PROMPTS[0], 9), (PROMPTS[3], 11),
                (PROMPTS[2], 7)]
        # token 1 at admission, then one fused block that exits after the
        # eos step instead of running all four
        assert port_toks[0][-1] == eos_id
        assert len(port_toks[0]) == eos_step + 1
        assert port_counts == {"host_dispatches": 1,
                               "device_loop_steps": eos_step}
    want = [expected(oracle, p, n, port.eos_id) for p, n in asks]
    assert port_toks == want


def _engine(weights, **kw):
    _, _, cfg, params = weights
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("prompt_buckets", (16, 64))
    kw.setdefault("kv_block_tokens", 8)
    return ContinuousBatchingEngine(cfg, params, device="cpu", **kw)


def test_oversubscribed_pool_requeues_and_completes(weights, oracle):
    """Six pages of 8 tokens, three requests of three pages each: the
    third waits for a completion to free pages, then completes."""
    with _engine(weights, max_batch=3, kv_cache_blocks=6) as eng:
        reqs = [eng.submit(PROMPTS[i][:10] + [i] * (10 - len(PROMPTS[i])),
                           10) for i in (2, 5, 6)]
        got = [r.wait(timeout=WAIT).tolist() for r in reqs]
        assert no_page_leak(eng)
    want = [expected(oracle, PROMPTS[i][:10] + [i] * (10 - len(PROMPTS[i])),
                     10) for i in (2, 5, 6)]
    assert got == want


def _wait_tokens(req, n):
    t_end = time.monotonic() + WAIT
    while len(req.tokens) < n:
        assert time.monotonic() < t_end and not req.done.is_set()
        time.sleep(0.002)


def test_cancel_failure_and_close_return_every_page(weights, monkeypatch):
    eng = _engine(weights, max_batch=2)
    # cancel mid-flight: the slot and its pages free after the step
    long = eng.submit(PROMPTS[5], 50)
    _wait_tokens(long, 2)
    long.cancel()
    assert long.done.wait(WAIT) and long.error is None
    assert 2 <= len(long.tokens) < 50
    # a failed admission fails its request, never the engine
    real = eng._paged_prefill

    def boom(*a, **k):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(eng, "_paged_prefill", boom)
    failed = eng.submit(PROMPTS[2], 5)
    with pytest.raises(RuntimeError, match="injected"):
        failed.wait(WAIT)
    monkeypatch.setattr(eng, "_paged_prefill", real)
    assert len(eng.submit(PROMPTS[0], 4).wait(WAIT)) == 4
    assert no_page_leak(eng)
    # close with a request in flight: it fails, its pages come back
    inflight = eng.submit(PROMPTS[6], 60)
    _wait_tokens(inflight, 1)
    eng.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        inflight.wait(WAIT)
    assert no_page_leak(eng)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(PROMPTS[0], 4)


def test_queue_depth_sheds_with_scheduler_overloaded(weights):
    with _engine(weights, max_batch=1, max_queue_depth=1) as eng:
        busy = eng.submit(PROMPTS[1], 60)
        _wait_tokens(busy, 1)
        waiting = eng.submit(PROMPTS[0], 3)
        with pytest.raises(SchedulerOverloaded, match="queue full") as e:
            eng.submit(PROMPTS[3], 3)
        assert e.value.retry_after_s == 1.0 and e.value.http_code == 503
        busy.cancel()
        assert len(waiting.wait(WAIT)) == 3
        assert eng.stats()["queue_depth"] == 0


def test_request_larger_than_the_pool_is_refused(weights):
    with _engine(weights, kv_cache_blocks=4) as eng:
        with pytest.raises(ValueError, match="pool holds only 4"):
            eng.submit(PROMPTS[2], 20)        # 40 tokens = 5 pages
        with pytest.raises(ValueError, match="exceeds KV-cache capacity"):
            eng.submit(PROMPTS[5], 60)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit(PROMPTS[0], 0)


def test_sampled_rows_and_streams(weights, oracle):
    """Sampled rows score finite logprobs <= 0; a stream yields the same
    greedy tokens as ``generate``, with the logprobs it reports."""
    sampled = SamplingParams(temperature=0.8, top_k=5)
    with _engine(weights, sampling=sampled, seed=3) as eng:
        ids = np.asarray([PROMPTS[2][:9], PROMPTS[1], PROMPTS[6][:9]])
        res = eng.generate(ids, 6, logprobs=True)
        assert res.tokens.shape == res.logprobs.shape == (3, 6)
        assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    with _engine(weights) as eng:
        ids = np.asarray([PROMPTS[1], PROMPTS[2][:9]])
        res = eng.generate(ids, 7, logprobs=True)
        items = list(eng.generate_stream(ids, 7, logprobs=True))
        np.testing.assert_array_equal(np.stack([t for t, _ in items], 1),
                                      res.tokens)
        np.testing.assert_allclose(np.stack([lp for _, lp in items], 1),
                                   res.logprobs, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(
            res.tokens, oracle.generate(ids, 7).tokens)
        stats = eng.stats()
        assert stats["slots"] == 8 and stats["active_slots"] == 0
        assert stats["latency"]["completed"] == 4


@pytest.mark.parametrize("kw,err", [
    (dict(mixed_token_budget=32), "needs prefill_chunk"),
    (dict(prompt_lookup=True), "A11"),
    (dict(kv_dtype="int8", kv_cache_dtype="float8_e4m3fn"),
     "cannot compose"),
    (dict(mesh=SimpleNamespace(shape={"tp": 2})), "A13"),
    (dict(kv_host_tier_bytes=1 << 20), "A12"),
    (dict(kv_layout="dense"), "removed"),
    (dict(attn_backend="cuda"), "CUDA kernels"),
    (dict(attn_backend="xla"), "unknown attn_backend"),
])
def test_engine_refuses_what_this_slice_does_not_port(weights, kw, err):
    with pytest.raises((NotImplementedError, ValueError), match=err):
        _engine(weights, **kw).close()


def test_cuda_is_the_default(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cfg, params = weights
    with pytest.raises(RuntimeError, match="--device cpu"):
        ContinuousBatchingEngine(cfg, params)
