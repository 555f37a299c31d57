"""The torch port's mixed prefill+decode dispatch against the JAX package's.

``llama-test`` in f32, the reference's weights carried across by
``models/bridge.py``.  One reference and one port engine per KV page
width (bf16, int8, int4), each built once: concurrent greedy streams are
equal token for token, and with a fixed arrival order (requests one after
another) so are the ``stats()["mixed"]``, chunk and device-loop counters.
Then the port's own invariants: mixed equals serialized, greedy (with an
eos mid-decode) and sampled (a stream of requests one after another:
tokens equal, logprobs within 1e-5; the reference's own sampled test
fails, so it is not the oracle); decode fusion survives admission; an
injected ``_mixed_step`` failure fails only the packed request; no page
leaks; ``/stats`` and ``serve --mixed-token-budget --kv-dtype`` on the CPU.
"""

import json
import time
import urllib.request

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
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer

GREEDY = SamplingParams(greedy=True)
WAIT = 120
# the reference's mixed test configuration: 8-token chunks, a 24-token
# budget (3 segments), fused decode blocks of 4
KW = dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
          kv_block_tokens=8, prefill_chunk=8, decode_block=4)
MIXED = dict(KW, mixed_token_budget=24)
# cold and disjoint: 27, 4 and 35 tokens (several chunks, one-chunk
# final, several chunks), then a prompt sharing two pages of the first
ASKS = [(list(range(3, 30)), 10), ([9, 8, 7, 6], 8),
        (list(range(50, 85)), 6)]
HIT = (list(range(3, 19)) + [7, 7, 7], 5)


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


def no_page_leak(eng) -> bool:
    """Every page is free or an evictable radix leaf, and no lease is
    held: the whole pool allocates (evicting the tree) and frees back."""
    mgr = eng.kv_cache
    if mgr.used_blocks != mgr.tree.block_count:
        return False
    ids = mgr.alloc(mgr.num_blocks)
    if ids is None:
        return False
    mgr.free(ids)
    return mgr.free_blocks == mgr.num_blocks


def _concurrent(eng):
    reqs = [eng.submit(p, n) for p, n in ASKS]
    return [r.wait(timeout=WAIT).tolist() for r in reqs]


def _sequential(eng):
    """Requests one after another (a fixed arrival order), counters from
    zero: tokens and the counters the two packages share."""
    eng.reset_stats()
    toks = [eng.submit(p, n).wait(timeout=WAIT).tolist()
            for p, n in ASKS + [HIT]]
    st = eng.stats()
    counters = {"mixed": st["mixed"],
                "chunks": eng.chunk_stats["chunks"],
                "interleaved_steps": eng.chunk_stats["interleaved_steps"],
                "loop": dict(eng.loop_stats),
                "kv": {k: st["kvcache"][k] for k in ("hits", "misses",
                                                     "partial_hit_tokens",
                                                     "stored_blocks")},
                "pending_prefill_tokens": st["pending_prefill_tokens"]}
    return toks, counters


@pytest.fixture(scope="module", params=[None, "int8", "int4"])
def runs(request, weights):
    """Both scenarios on a reference and a port mixed engine of one page
    width: {"ref": (...), "port": (...)} plus the port engine's leak
    check."""
    rcfg, rp, cfg, params = weights
    out = {}
    with RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                     kv_dtype=request.param, **MIXED) as ref:
        out["ref"] = (_concurrent(ref), _sequential(ref))
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  kv_dtype=request.param, device="cpu",
                                  **MIXED) as port:
        out["port"] = (_concurrent(port), _sequential(port))
        out["leak_free"] = no_page_leak(port)
    return out


def test_concurrent_greedy_matches_reference(runs):
    assert runs["port"][0] == runs["ref"][0]
    assert runs["leak_free"]


def test_mixed_counters_match_reference(runs):
    """One request at a time: the same tokens and the same dispatches,
    prefill tokens, budget utilization, chunks, steps and radix hit."""
    (rt, rc), (pt, pc) = runs["ref"][1], runs["port"][1]
    assert pt == rt
    assert pc == rc
    # the first and third prompts hit the tree the concurrent run
    # filled, and HIT shares two pages of the first
    assert pc["mixed"]["dispatches"] > 0 and pc["kv"]["hits"] == 3
    assert pc["pending_prefill_tokens"] == 0


def _run(weights, mixed, eos_id=None, sampling=GREEDY, seed=0,
         sequential=False, **kw):
    _, _, cfg, params = weights
    kw = dict(MIXED if mixed else KW, **kw)
    with ContinuousBatchingEngine(cfg, params, sampling=sampling, seed=seed,
                                  eos_id=eos_id, device="cpu", **kw) as eng:
        if sequential:
            outs = []
            for p, n in ASKS:
                r = eng.submit(p, n)
                outs.append((r.wait(timeout=WAIT).tolist(), list(r.lps)))
        else:
            outs = _concurrent(eng)
        assert no_page_leak(eng)
        if mixed:
            assert eng.stats()["mixed"]["dispatches"] > 0
        return outs


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_mixed_equals_serialized_greedy(weights, kv_dtype):
    """Concurrent greedy streams, mixed and serialized, equal; with an
    eos taken from a real stream, one request ends mid-decode while the
    others still admit and decode, and the cuts coincide."""
    base = _run(weights, False, kv_dtype=kv_dtype)
    assert _run(weights, True, kv_dtype=kv_dtype) == base
    eos = base[0][4]
    cut = _run(weights, True, eos_id=eos, kv_dtype=kv_dtype)
    assert cut == _run(weights, False, eos_id=eos, kv_dtype=kv_dtype)
    assert cut[0] == base[0][:base[0].index(eos) + 1]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_sampled_stream_mixed_equals_serialized(weights, kv_dtype):
    """The generator contract: one batch-1 draw per packed final in pack
    order, then the decode block's draws, so a stream of requests one
    after another samples the same tokens mixed and serialized."""
    samp = SamplingParams(temperature=0.9, top_k=40)
    got = _run(weights, True, sampling=samp, seed=7, sequential=True,
               kv_dtype=kv_dtype)
    want = _run(weights, False, sampling=samp, seed=7, sequential=True,
                kv_dtype=kv_dtype)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, lg), (_, lw) in zip(got, want):
        np.testing.assert_allclose(lg, lw, rtol=1e-5, atol=1e-5)
    # a different seed draws differently: the draws are really sampled
    other = _run(weights, True, sampling=samp, seed=8, sequential=True,
                 kv_dtype=kv_dtype)
    assert [t for t, _ in other] != [t for t, _ in got]


def test_decode_fusion_survives_admission(weights):
    """A chunk-streaming prompt submitted while a row decodes packs into
    the decode dispatches (interleaved steps), and dispatches per step
    stay near 1/K instead of one per token."""
    _, _, cfg, params = weights
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  device="cpu", **dict(MIXED, max_batch=2)
                                  ) as eng:
        # long enough to still decode when the second prompt arrives
        a = eng.submit([5, 4, 3, 2], 80)
        t_end = time.monotonic() + WAIT
        while len(a.tokens) < 2:
            assert time.monotonic() < t_end, "row A never started"
            time.sleep(0.002)
        b = eng.submit(list(range(1, 36)), 8)
        a.wait(timeout=WAIT)
        b.wait(timeout=WAIT)
        assert eng.chunk_stats["interleaved_steps"] >= 1
        ls = eng.loop_stats
        assert ls["host_dispatches"] / ls["device_loop_steps"] <= 0.25 + 0.12
        assert no_page_leak(eng)


def test_mixed_failure_fails_only_the_packed_request(weights):
    """A dispatch failure with segments packed fails those requests; the
    engine keeps serving, rows decoding before it keep their streams,
    and no page leaks."""
    _, _, cfg, params = weights
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  device="cpu", **MIXED) as eng:
        want = {}
        for p, n in ASKS[:2]:
            want[len(p)] = eng.submit(p, n).wait(timeout=WAIT).tolist()
        live = eng.submit(*ASKS[1])
        t_end = time.monotonic() + WAIT
        while len(live.tokens) < 1:
            assert time.monotonic() < t_end, "the live row never started"
            time.sleep(0.002)
        orig = eng._mixed_step
        armed = {"on": True}

        def boom(seg_ids, *a, **k):
            if armed["on"] and seg_ids is not None:
                armed["on"] = False
                raise RuntimeError("injected mixed failure")
            return orig(seg_ids, *a, **k)

        eng._mixed_step = boom
        failed = eng.submit(*ASKS[0])
        with pytest.raises(RuntimeError, match="injected mixed failure"):
            failed.wait(timeout=WAIT)
        assert live.wait(timeout=WAIT).tolist() == want[4]
        again = eng.submit(*ASKS[0]).wait(timeout=WAIT).tolist()
        assert again == want[len(ASKS[0][0])]
        assert eng.stats()["pending_prefill_tokens"] == 0
        assert no_page_leak(eng)


@pytest.mark.parametrize("kw,err", [
    (dict(mixed_token_budget=16, prefill_chunk=None), "needs prefill_chunk"),
    (dict(mixed_token_budget=4), "must fit at least one prefill chunk"),
])
def test_budget_validation_matches_reference(weights, kw, err):
    rcfg, rp, cfg, params = weights
    with pytest.raises(ValueError, match=err) as want:
        RefBatching(rcfg, rp, **dict(KW, **kw))
    with pytest.raises(ValueError, match=err) as got:
        ContinuousBatchingEngine(cfg, params, device="cpu", **dict(KW, **kw))
    assert str(got.value) == str(want.value)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as resp:
        return json.loads(resp.read().decode())


def test_stats_route_and_cli_serve_mixed_int8(weights, capsys,
                                              monkeypatch):
    """``serve --batch-slots 4 --kv-block-tokens 8 --prefill-chunk 16
    --decode-block 4 --mixed-token-budget 32 --kv-dtype int8 --device
    cpu`` serves ``llama-test``; its banner names both flags and its
    ``/stats`` carries the mixed fragment."""
    seen = {}

    def serve_briefly(self):
        self.start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/generate",
            data=json.dumps({"prompt_ids": [list(range(1, 40))],
                             "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            seen["tokens"] = json.loads(resp.read().decode())["tokens"]
        seen["stats"] = _get(self.port, "/stats")

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--batch-slots", "4", "--kv-block-tokens", "8",
                     "--prefill-chunk", "16", "--decode-block", "4",
                     "--mixed-token-budget", "32", "--kv-dtype", "int8",
                     "--greedy", "--http-port", "0"]) == 0
    out = capsys.readouterr().out
    assert "kv_dtype=int8 mixed_token_budget=32" in out
    assert np.asarray(seen["tokens"]).shape == (1, 5)
    mixed = seen["stats"]["mixed"]
    assert mixed["token_budget"] == 32 and mixed["dispatches"] > 0
    assert mixed["prefill_tokens"] == 39
    assert seen["stats"]["kvcache"]["page_dtype"] == "int8"
    # --kv-dtype without --batch-slots serves too: the plain engine's
    # prefix pool takes int8 pages
    seen.clear()
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--kv-cache-blocks", "16", "--kv-block-tokens", "8",
                     "--kv-dtype", "int8", "--greedy", "--http-port",
                     "0"]) == 0
    assert "kv_cache=16x8tok paged kv_dtype=int8" in capsys.readouterr().out
    assert np.asarray(seen["tokens"]).shape == (1, 5)


@pytest.mark.slow
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("chunk,budget", [(4, 8), (8, 24), (16, 32)])
def test_mixed_matches_serialized_property_sweep(weights, kv_dtype, chunk,
                                                 budget):
    """Chunk sizes x budgets x page widths, with an eos mid-decode:
    concurrent greedy streams out of the mixed dispatch equal the
    serialized interleave's, and every run ends leak-free."""
    kw = dict(prefill_chunk=chunk, kv_dtype=kv_dtype)
    base = _run(weights, False, **kw)
    assert _run(weights, True, mixed_token_budget=budget, **kw) == base
    eos = base[0][4]
    assert (_run(weights, True, eos_id=eos, mixed_token_budget=budget, **kw)
            == _run(weights, False, eos_id=eos, **kw))
