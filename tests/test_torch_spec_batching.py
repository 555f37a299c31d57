"""The torch port's speculative batching (serialized dispatch) against the
JAX package's.

``llama-test`` in f32, the reference's weights carried across by
``models/bridge.py``; the draft is ``llama-test`` at 2 layers from
another seed.  For each proposer (draft model, prompt lookup) one
reference and one port engine of the same configuration
(``decode_block`` 3, chunked admission, K = 3, an eos that lands inside
a round), built once: requests one after another, then a concurrent
batch with a late joiner; greedy tokens equal the reference engine's and
the port's ``InferenceEngine``'s, and the ``speculative`` stats fragment
of the sequential part equals the reference's.  Then the port's own
invariants: the default configuration, a self-draft accepting
everything (greedy and sampled), the stream, logprobs refused, the
refusals, the pool bound with the rounds' slack and the draft pool, and
no page left in either pool after cancels and close.
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

MAX_SEQ = 96
GREEDY = SamplingParams(greedy=True)
WAIT = 120
KW = dict(max_seq=MAX_SEQ, max_batch=4, prompt_buckets=(16, 64),
          kv_block_tokens=8, num_draft=3, decode_block=3, prefill_chunk=8)
# one after another: a short prompt, a 19-token prompt (two chunks and a
# final), a one-token prompt
SEQUENTIAL = [([3, 14, 15, 92, 65], 12), (list(range(3, 22)), 10),
              ([1], 8)]


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
    return InferenceEngine(models["cfg"], models["p"], max_seq=MAX_SEQ,
                           sampling=GREEDY, device="cpu")


def expected(oracle, prompt, n, eos=None):
    toks = oracle.generate(np.asarray(prompt)[None, :], n).tokens[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[:toks.index(eos) + 1]
    return toks


@pytest.fixture(scope="module")
def eos(oracle):
    """The 5th greedy token of the first sequential prompt: it ends that
    row inside a round."""
    return expected(oracle, *SEQUENTIAL[0])[4]


def _proposer(models, mode, ref=False):
    if mode == "pld":
        return dict(prompt_lookup=True)
    return (dict(draft_cfg=models["rdcfg"], draft_params=models["rdp"])
            if ref else dict(draft_cfg=models["dcfg"],
                             draft_params=models["dp"]))


def _port(models, mode, **kw):
    kw = {**KW, **kw}
    kw.setdefault("sampling", GREEDY)
    return ContinuousBatchingEngine(models["cfg"], models["p"], device="cpu",
                                    **_proposer(models, mode), **kw)


def _pool_idle(eng) -> bool:
    """Every target page free or an evictable radix leaf, and the draft's
    scratch pool empty."""
    mgr = eng.kv_cache
    ids = mgr.alloc(mgr.num_blocks)
    if ids is None:
        return False
    mgr.free(ids)
    draft_ok = (eng._proposer != "draft"
                or eng._dmgr.free_blocks == eng._dmgr.num_blocks)
    return mgr.free_blocks == mgr.num_blocks and draft_ok


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_streams_and_stats_match_reference(models, oracle, eos, mode):
    ref = RefBatching(models["rcfg"], models["rp"],
                      sampling=RefSamplingParams(greedy=True), eos_id=eos,
                      **_proposer(models, mode, ref=True), **KW)
    port = _port(models, mode, eos_id=eos)
    try:
        for prompt, n in SEQUENTIAL:
            got = port.submit(prompt, n).wait(timeout=WAIT).tolist()
            want = ref.submit(prompt, n).wait(timeout=WAIT).tolist()
            assert got == want == expected(oracle, prompt, n, eos)
        ps, rs = port.stats(), ref.stats()
        assert ps["speculative"] == rs["speculative"]
        assert ps["speculative"]["proposer"] == (
            "draft" if mode == "draft" else "prompt_lookup")
        for key in ("device_loop", "chunked_prefill", "steps",
                    "spec_backlog_tokens"):
            assert ps[key] == rs[key], key
        assert ps["latency"]["completed"] == rs["latency"]["completed"] == 3
        # concurrent, with a late joiner between rounds
        for eng in (port, ref):
            first = eng.submit([5, 4, 3, 2], 30)
            t_end = time.monotonic() + WAIT
            while len(first.tokens) < 3:
                assert time.monotonic() < t_end, "first request stalled"
                time.sleep(0.002)
            late = [eng.submit(p, n) for p, n in
                    (([8, 8, 1], 9), (list(range(40, 59)), 7))]
            for (p, n), r in zip((([5, 4, 3, 2], 30), ([8, 8, 1], 9),
                                  (list(range(40, 59)), 7)),
                                 [first] + late):
                assert r.wait(timeout=WAIT).tolist() == expected(
                    oracle, p, n, eos)
        assert port.stats()["chunked_prefill"]["interleaved_steps"] >= 1
        assert _pool_idle(port)
    finally:
        port.close()
        ref.close()
    assert _pool_idle(port)


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_default_configuration_matches_target_only(models, oracle, mode):
    with _port(models, mode, decode_block=1, prefill_chunk=None,
               num_draft=4) as eng:
        prompt = [3, 14, 15, 92, 65]
        assert eng.submit(prompt, 12).wait(timeout=WAIT).tolist() == \
            expected(oracle, prompt, 12)
        st = eng.stats()["speculative"]
        assert st["rounds"] >= 1 and st["num_draft"] == 4
        assert st["k_row_buckets"] == {"1": 0, "2": 0, "4": 0}


@pytest.mark.parametrize("samp", [GREEDY, SamplingParams(temperature=0.9,
                                                          top_k=0)])
def test_self_draft_accepts_everything(models, samp):
    """Draft == target: every proposal is accepted, and a row advances by
    K + 1 a round (per-row advance, no lockstep minimum)."""
    with ContinuousBatchingEngine(
            models["cfg"], models["p"], max_seq=MAX_SEQ, max_batch=2,
            sampling=samp, prompt_buckets=(16,), draft_cfg=models["cfg"],
            draft_params=models["p"], num_draft=4, device="cpu") as eng:
        a = eng.submit([3, 1, 4], 21).wait(timeout=WAIT)
        st = eng.stats()["speculative"]
        assert a.shape == (21,) and st["acceptance_rate"] == 1.0
        if samp.greedy:
            # 1 prefill token + 20 from 4 all-accept rounds
            assert st["rounds"] == 4
        else:
            b = eng.submit([5, 6], 12).wait(timeout=WAIT)
            assert ((b >= 0) & (b < 256)).all()
            assert eng.stats()["speculative"]["acceptance_rate"] == 1.0


def test_stream_matches_plain_stream_and_logprobs_refused(models):
    prompt = np.asarray([3, 14, 15, 92, 65])
    with ContinuousBatchingEngine(models["cfg"], models["p"],
                                  max_seq=MAX_SEQ, max_batch=2,
                                  sampling=GREEDY, prompt_buckets=(16,),
                                  device="cpu") as plain:
        want = [t[0] for t in plain.generate_stream(prompt, 12)]
    for mode in ("draft", "pld"):
        with _port(models, mode) as eng:
            assert [t[0] for t in eng.generate_stream(prompt, 12)] == want
            with pytest.raises(ValueError, match="logprobs"):
                eng.generate(np.asarray([[1, 2, 3]]), 4, logprobs=True)
            res = eng.generate(np.asarray([[1, 2, 3]]), 4)
            assert res.logprobs is None and res.tokens.shape == (1, 4)


def test_refusals(models):
    cfg, p = models["cfg"], models["p"]
    bad = dataclasses.replace(models["dcfg"], vocab_size=cfg.vocab_size + 1)
    for kw, err in ((dict(draft_cfg=bad, draft_params=models["dp"]),
                     "vocab"),
                    (dict(prompt_lookup=True, draft_cfg=models["dcfg"],
                          draft_params=models["dp"]), "exclusive"),
                    (dict(draft_cfg=models["dcfg"]), "go together"),
                    (dict(prompt_lookup=True, num_draft=0), "num_draft")):
        with pytest.raises(ValueError, match=err):
            ContinuousBatchingEngine(cfg, p, max_seq=MAX_SEQ, max_batch=2,
                                     device="cpu", **kw)


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_pool_bound_counts_the_rounds_slack(models, mode):
    """Reservations carry decode_block * (K+1) slack tokens: a request
    that fits its pages without the slack is refused with it (the draft
    pool binds too), and the table width covers the slack."""
    with _port(models, mode, kv_cache_blocks=4) as eng:
        assert eng._slack_tokens == KW["decode_block"] * (KW["num_draft"]
                                                          + 1)
        assert eng._table_width * 8 >= MAX_SEQ + eng._slack_tokens
        with pytest.raises(ValueError, match="slack 12"):
            eng.submit(list(range(10)), 20)       # 30 tokens: 4 pages
        got = eng.submit(list(range(8)), 12).wait(timeout=WAIT)
        assert got.shape == (12,)                 # 20 + 12 = 4 pages


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_cancel_and_close_return_every_page(models, mode):
    eng = _port(models, mode)
    try:
        a = eng.submit(list(range(3, 30)), 40)
        b = eng.submit([5, 5, 5], 40)
        t_end = time.monotonic() + WAIT
        while len(a.tokens) < 2:
            assert time.monotonic() < t_end, "request stalled"
            time.sleep(0.002)
        a.cancel()
        b.wait(timeout=WAIT)
        assert a.done.wait(WAIT)
        assert _pool_idle(eng)
        c = eng.submit(list(range(20)), 60)
    finally:
        eng.close()
    assert c.done.is_set() and _pool_idle(eng)


def test_sampled_streams_are_seeded(models):
    """One generator seeded with ``seed``: the same seed samples the same
    tokens, another seed other ones."""
    samp = SamplingParams(temperature=0.9, top_k=40)

    def run(seed):
        with _port(models, "draft", sampling=samp, seed=seed) as eng:
            return [eng.submit(p, n).wait(timeout=WAIT).tolist()
                    for p, n in SEQUENTIAL]

    first = run(7)
    assert run(7) == first and run(8) != first


def test_freed_slot_draft_rows_drop_their_writes(models, oracle):
    """A finished row's draft table goes back to sentinel with its target
    table, as the reference's does: every round runs the draft's steps
    over all B rows, so a stale table would write the idle row's K/V into
    draft pages the free list hands to a late joiner.  Self-draft accepts
    everything only while the joiner's draft cache is intact."""
    kw = dict(max_seq=MAX_SEQ, max_batch=3, prompt_buckets=(16, 64),
              kv_block_tokens=8, num_draft=3, decode_block=2)
    ref = RefBatching(models["rcfg"], models["rp"],
                      sampling=RefSamplingParams(greedy=True),
                      draft_cfg=models["rcfg"], draft_params=models["rp"],
                      **kw)
    port = ContinuousBatchingEngine(
        models["cfg"], models["p"], sampling=GREEDY, device="cpu",
        draft_cfg=models["cfg"], draft_params=models["p"], **kw)
    first = [([3, 1, 4, 1, 5], 12), (list(range(3, 20)), 60),
             ([9, 2, 6, 5, 3], 12)]
    joiner = (list(range(30, 45)), 24)
    try:
        for eng in (port, ref):
            reqs = [eng.submit(p, n) for p, n in first]
            for (p, n), r in list(zip(first, reqs))[::2]:
                assert r.wait(timeout=WAIT).tolist() == expected(oracle, p, n)
            # the port's joiner is admitted into the lowest free slot, on
            # pages the finished rows gave back, while another freed slot
            # stays idle (the reference's fused rounds may finish the long
            # row first)
            assert eng is ref or not reqs[1].done.is_set(), \
                "long row ended early"
            got = eng.submit(*joiner).wait(timeout=WAIT).tolist()
            assert got == expected(oracle, *joiner)
            assert reqs[1].wait(timeout=WAIT).tolist() == expected(
                oracle, *first[1])
            free = [i for i, s in enumerate(eng._slots) if s is None]
            assert free == [0, 1, 2]
            assert (eng._dtables == eng._dpage_sentinel).all()
            assert (eng._tables == eng._page_sentinel).all()
        ps, rs = port.stats()["speculative"], ref.stats()["speculative"]
        assert ps["acceptance_rate"] == rs["acceptance_rate"] == 1.0
        assert ps["accepted"] == ps["drafted"] > 0
        assert (port._dmgr.free_blocks == port._dmgr.num_blocks
                == ref._dmgr.free_blocks == ref._dmgr.num_blocks)
        assert _pool_idle(port)
    finally:
        port.close()
        ref.close()
