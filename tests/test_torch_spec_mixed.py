"""The torch port's mixed speculative dispatch against the JAX package's.

``llama-test`` in f32, the reference's weights carried across by
``models/bridge.py``; the draft is ``llama-test`` at 2 layers from
another seed.  Speculative rows packed into the mixed prefill+decode
dispatch (8-token chunks, a 24-token budget, ``decode_block`` 4, K = 3,
adaptive K_row in {1, 2, 3}): with requests one after another the
tokens and the ``speculative`` and ``mixed`` stats fragments equal the
reference engine's; concurrent greedy streams equal the port's
``InferenceEngine``'s for both proposers, with no page left in either
pool; mixed equals serialized under greedy over bf16, int8 and int4
pages; adaptive K walks a low-acceptance row down to bucket 1; the
speculative dispatch ratio survives admission.  Sampled mixed against
serialized pins the port's own invariant (K_row pinned): the same
tokens, as ``test_torch_mixed.py`` does for plain decode, since the
reference's own sampled test fails.
"""

import dataclasses
import time

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

GREEDY = SamplingParams(greedy=True)
WAIT = 120
KW = dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
          kv_block_tokens=8, prefill_chunk=8, decode_block=4, num_draft=3)
MIXED = dict(KW, mixed_token_budget=24)
ASKS = [(list(range(3, 30)), 10), ([9, 8, 7, 6], 8),
        (list(range(50, 85)), 6)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bridge(rp, cfg):
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    return params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    rcfg = ref_get_model_config("llama-test")
    rdcfg = dataclasses.replace(rcfg, num_layers=2)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    rdp = ref_init_full_params(jax.random.PRNGKey(1), rdcfg)
    cfg = get_model_config("llama-test")
    dcfg = dataclasses.replace(cfg, num_layers=2)
    return dict(rcfg=rcfg, rp=rp, rdcfg=rdcfg, rdp=rdp, cfg=cfg,
                p=_bridge(rp, cfg), dcfg=dcfg, dp=_bridge(rdp, dcfg))


@pytest.fixture(scope="module")
def oracle(models):
    return InferenceEngine(models["cfg"], models["p"], max_seq=96,
                           sampling=GREEDY, device="cpu")


def expected(oracle, prompt, n):
    return oracle.generate(np.asarray(prompt)[None, :], n).tokens[0].tolist()


def _engine(models, proposer, **kw):
    kw = {**MIXED, **kw}
    kw.setdefault("sampling", GREEDY)
    prop = (dict(prompt_lookup=True) if proposer == "pld" else
            dict(draft_cfg=models["dcfg"], draft_params=models["dp"]))
    return ContinuousBatchingEngine(models["cfg"], models["p"], device="cpu",
                                    **prop, **kw)


def _assert_idle(eng) -> None:
    """No page leaked: every target page free or an evictable radix
    leaf, and the draft's scratch pool empty."""
    mgr = eng.kv_cache
    ids = mgr.alloc(mgr.num_blocks)
    assert ids is not None
    mgr.free(ids)
    assert mgr.free_blocks == mgr.num_blocks
    if eng._proposer == "draft":
        assert eng._dmgr.used_blocks == 0, eng._dmgr.used_blocks


@pytest.mark.parametrize("proposer", ["pld", "draft"])
def test_sequential_tokens_and_stats_match_reference(models, proposer):
    prop = (dict(prompt_lookup=True) if proposer == "pld" else
            dict(draft_cfg=models["rdcfg"], draft_params=models["rdp"]))
    ref = RefBatching(models["rcfg"], models["rp"],
                      sampling=RefSamplingParams(greedy=True), **prop,
                      **MIXED)
    port = _engine(models, proposer)
    try:
        for p, n in ASKS:
            assert port.submit(p, n).wait(timeout=WAIT).tolist() == \
                ref.submit(p, n).wait(timeout=WAIT).tolist()
        ps, rs = port.stats(), ref.stats()
        for key in ("speculative", "mixed", "device_loop",
                    "chunked_prefill", "steps", "spec_backlog_tokens"):
            assert ps[key] == rs[key], key
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("proposer", ["pld", "draft"])
def test_concurrent_greedy_parity_and_zero_leak(models, oracle, proposer):
    prompts = [[3, 14, 15], list(range(2, 24)), [9, 2, 6, 5, 3, 5]]
    ns = [10, 12, 8]
    with _engine(models, proposer) as eng:
        reqs = [eng.submit(p, n) for p, n in zip(prompts, ns)]
        for p, n, r in zip(prompts, ns, reqs):
            assert r.wait(timeout=WAIT).tolist() == expected(oracle, p, n)
        st = eng.stats()
        assert st["speculative"]["drafted"] > 0
        assert st["speculative"]["adaptive"] is True
        assert st["mixed"]["dispatches"] > 0
        _assert_idle(eng)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_mixed_equals_serialized_greedy(models, kv_dtype):
    """Verify reads and proposals see identically quantized history in
    both dispatches; an eos from a real stream cuts a row mid-decode."""

    def run(mixed, eos=None):
        kw = {} if mixed else {"mixed_token_budget": 0}
        with _engine(models, "pld", kv_dtype=kv_dtype, eos_id=eos,
                     **kw) as eng:
            reqs = [eng.submit(p, n) for p, n in ASKS]
            outs = [r.wait(timeout=WAIT).tolist() for r in reqs]
            _assert_idle(eng)
            return outs

    base = run(False)
    assert run(True) == base
    eos = base[0][4]
    cut = run(True, eos)
    assert cut == run(False, eos)
    assert cut[0] == base[0][:base[0].index(eos) + 1]


def test_adaptive_k_shrinks_on_low_acceptance(models, oracle):
    """A draft that disagrees with the target drives the row's EWMA down
    until K_row sits in bucket 1 (seen in k_row_buckets while the row is
    live), and the stream still equals plain greedy decode."""
    prompt, n = [7, 3, 11], 60
    with _engine(models, "draft", max_batch=2) as eng:
        r = eng.submit(prompt, n)
        saw_small = False
        t_end = time.monotonic() + WAIT
        while not r.done.is_set() and time.monotonic() < t_end:
            sp = eng.stats().get("speculative") or {}
            if (sp.get("k_row_buckets") or {}).get("1", 0) >= 1:
                saw_small = True
                break
            time.sleep(0.002)
        assert r.wait(timeout=WAIT).tolist() == expected(oracle, prompt, n)
        sp = eng.stats()["speculative"]
        assert saw_small, sp
        assert sp["acceptance_rate"] is None or sp["acceptance_rate"] < 0.5
        assert 1 in eng.rounds_by_width
        _assert_idle(eng)


def test_dispatch_ratio_survives_admission(models, oracle):
    """With a chunked prompt admitting, the speculative row keeps its
    fused cadence: dispatches per round stay near 1 / decode_block."""
    with _engine(models, "pld", max_batch=2, mixed_token_budget=40) as eng:
        a = eng.submit([5, 4, 3, 2], 36)
        t_end = time.monotonic() + WAIT
        while len(a.tokens) < 2:
            assert time.monotonic() < t_end, "row A never started"
            time.sleep(0.002)
        b = eng.submit(list(range(1, 36)), 8)
        assert a.wait(timeout=WAIT).tolist() == expected(oracle,
                                                         [5, 4, 3, 2], 36)
        assert b.wait(timeout=WAIT).tolist() == expected(
            oracle, list(range(1, 36)), 8)
        assert eng.chunk_stats["interleaved_steps"] >= 1
        assert eng.stats()["speculative"]["drafted"] > 0
        ls = eng.loop_stats
        assert ls["device_loop_steps"] > 0
        assert ls["host_dispatches"] / ls["device_loop_steps"] <= 1 / 4 + 0.12
        _assert_idle(eng)


@pytest.mark.parametrize("proposer", ["pld", "draft"])
def test_sampled_stream_mixed_equals_serialized(models, proposer):
    """The generator contract with K_row pinned: one batch-1 draw per
    packed final in pack order, then the rounds' draws, so requests one
    after another sample the same tokens mixed and serialized; another
    seed samples others."""
    samp = SamplingParams(temperature=0.9, top_k=40)

    def run(mixed, seed=7):
        kw = {} if mixed else {"mixed_token_budget": 0}
        with _engine(models, proposer, sampling=samp, seed=seed,
                     spec_adaptive=False, **kw) as eng:
            return [eng.submit(p, n).wait(timeout=WAIT).tolist()
                    for p, n in ASKS[:2]]

    got = run(True)
    assert got == run(False)
    assert run(True, seed=8) != got
