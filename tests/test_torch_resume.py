"""The port's gateway-failover resume against the JAX package's.

``ContinuousBatchingEngine.submit_resumed`` / ``generate_stream(...,
resume=...)`` and the HTTP ``resume`` field.  A greedy stream cut after
k delivered tokens and resumed on a survivor equals the reference's
unfailed stream, at every cut, serialized and in the mixed dispatch;
the ``resumed`` stats fragment and the refusals equal the reference's.
Sampled resumption rewinds the port's generator to its constructor seed
before the request's first draw, so a sampled stream resumes equal to
the port's own unfailed one (the port's draws are its own, not the
reference's).  Over HTTP, the validations answer the reference
server's codes and messages, and a resumed stream numbers its steps
from k.  ``llama-test`` in f32 on the CPU.
"""

import json
from http.client import HTTPConnection

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
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.telemetry.slo import (
    SloLedger, set_slo_ledger)

GREEDY = SamplingParams(greedy=True)
SAMPLED = SamplingParams(temperature=0.9, top_k=40)
PROMPT = list(range(3, 24))
N = 10
WAIT = 120
KW = dict(seed=7, max_seq=96, max_batch=4, prompt_buckets=(16, 48),
          kv_block_tokens=8)


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


def _port(weights, **kw):
    _, _, cfg, params = weights
    return ContinuousBatchingEngine(cfg, params, device="cpu",
                                    **{**KW, "sampling": GREEDY, **kw})


def _ref(weights, **kw):
    rcfg, rp, _, _ = weights
    return RefBatching(rcfg, rp, **{
        **KW, "sampling": RefSamplingParams(greedy=True), **kw})


def _stream(eng, prompt=PROMPT, n=N, resume=None):
    ids = np.asarray(prompt, np.int32)[None, :]
    return [int(t[0]) for t in eng.generate_stream(ids, n, resume=resume)]


def _resume_at(eng, ref, k, prompt=PROMPT, n=N):
    resume = {"delivered_tokens": ref[:k], "rng_step_offset": k}
    return ref[:k] + _stream(eng, prompt, n, resume=resume)


def _no_leak(eng):
    mgr = eng.kv_cache
    assert mgr.used_blocks == mgr.tree.block_count
    assert mgr.debug_state()["leased_nodes"] == 0


@pytest.mark.parametrize("mode", [
    dict(),
    dict(prefill_chunk=8, mixed_token_budget=16, decode_block=2),
], ids=["serialized", "mixed"])
def test_greedy_resume_equals_reference(weights, mode):
    """One warm survivor serves every cut: delivered + suffix equals the
    reference's unfailed stream, and the ``resumed`` fragment after each
    cut is the reference engine's."""
    port, ref = _port(weights, **mode), _ref(weights, **mode)
    try:
        want = _stream(ref)
        assert _stream(port) == want and len(want) == N
        for k in (1, N // 2, N - 1):
            assert _resume_at(port, want, k) == want
            assert _resume_at(ref, want, k) == want
            assert port.stats()["resumed"] == ref.stats()["resumed"]
        assert port.stats()["resumed"]["diverged"] == 0
        _no_leak(port)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("mode", [
    dict(),
    dict(prefill_chunk=8, mixed_token_budget=16, decode_block=2),
    dict(kv_dtype="int8"),
], ids=["serialized", "mixed", "int8"])
def test_sampled_resume_every_cut_equals_unfailed(weights, mode):
    """The generator rewind: for every cut k in [1, N) a sampled stream
    resumes equal to the unfailed run of a fresh engine of the same seed
    (the draws before the cut are irrelevant)."""
    with _port(weights, sampling=SAMPLED, **mode) as eng:
        want = _stream(eng)
    with _port(weights, sampling=SAMPLED, **mode) as eng:
        for k in range(1, N):
            assert _resume_at(eng, want, k) == want, k
        st = eng.stats()["resumed"]
        assert st == {"requests": N - 1, "diverged": 0,
                      "replayed_tokens": sum(range(1, N))}
        _no_leak(eng)


def test_divergence_and_validation_equal_reference(weights):
    """A journal the survivor cannot re-derive fails the request at the
    first mismatched token (the engine serves on), and the refusals are
    the reference's."""
    port, ref = _port(weights, eos_id=5), _ref(weights, eos_id=5)
    try:
        want = _stream(ref)
        bogus = [t + 1 for t in want[:3]]
        for eng in (port, ref):
            req = eng.submit_resumed(PROMPT, N, bogus)
            with pytest.raises(RuntimeError, match="diverged") as err:
                req.wait(timeout=WAIT)
        assert port.stats()["resumed"] == ref.stats()["resumed"]
        assert _stream(port) == want
        _no_leak(port)
        for args in (([], N), ([7, 8, 9], 3), ([7, 5], N)):
            msgs = []
            for eng in (port, ref):
                with pytest.raises(ValueError) as err:
                    eng.submit_resumed(PROMPT, args[1], args[0])
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]
        ids = np.asarray([PROMPT, PROMPT], np.int32)
        for resume in ({"delivered_tokens": [7], "rng_step_offset": 1},
                       {"delivered_tokens": [], "rng_step_offset": 0},
                       {"delivered_tokens": [7, 8], "rng_step_offset": 1}):
            msgs = []
            for eng in (port, ref):
                rows = ids if resume["delivered_tokens"] == [7] else ids[:1]
                with pytest.raises(ValueError) as err:
                    list(eng.generate_stream(rows, N, resume=resume))
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]
    finally:
        port.close()
        ref.close()


def test_resume_pause_books_into_the_slo_decomposition(weights):
    led = SloLedger(ttft_slo_ms=10_000, tpot_slo_ms=10_000)
    set_slo_ledger(led)
    try:
        with _port(weights) as eng:
            want = _stream(eng)
            assert _resume_at(eng, want, N // 2) == want
        recs = [r for r in led.recent(16) if r.get("resumed")]
        assert len(recs) == 1
        rec = recs[0]
        assert rec["resume_pause_s"] > 0.0
        lhs = (rec["ttft_s"] + rec["per_token_s"] * (rec["tokens"] - 1)
               + rec["migration_pause_s"] + rec["resume_pause_s"])
        assert lhs == pytest.approx(rec["e2e_s"], rel=1e-6)
        assert led.summary()["tenants"]["default"]["resumed"] == 1
    finally:
        set_slo_ledger(None)


def _post(port, body):
    conn = HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read().decode()
        if resp.status != 200:
            return resp.status, json.loads(data)
        return 200, [json.loads(ln) for ln in data.splitlines() if ln]
    finally:
        conn.close()


def test_http_resume_answers_as_the_reference_server(weights):
    """Each refusal of the ``resume`` field is the reference server's
    (code and message) over a batching engine and over a plain engine;
    a valid resume streams the suffix numbered from k, equal to the
    reference server's."""
    rcfg, rp, cfg, params = weights
    port_b, ref_b = _port(weights), _ref(weights)
    port_p = InferenceEngine(cfg, params, max_seq=96, sampling=GREEDY,
                             device="cpu")
    ref_p = RefEngine(rcfg, rp, max_seq=96,
                      sampling=RefSamplingParams(greedy=True))
    servers = [InferenceHTTPServer(port_b, port=0), RefServer(ref_b, port=0),
               InferenceHTTPServer(port_p, port=0), RefServer(ref_p, port=0)]
    for s in servers:
        s.start()
    try:
        want = _stream(ref_b)
        ok = {"delivered_tokens": want[:4], "rng_step_offset": 4}
        base = {"prompt_ids": [PROMPT], "max_new_tokens": N, "stream": True}
        bodies = [dict(base, stream=False, resume=ok),
                  dict(base, stop=["x"], resume=ok),
                  dict(base, logprobs=True, resume=ok),
                  dict(base, resume=[1, 2]),
                  dict(base, resume={"delivered_tokens": []}),
                  dict(base, resume={"delivered_tokens": ["a"]}),
                  dict(base, resume={"delivered_tokens": [1, 2],
                                     "rng_step_offset": 5})]
        for body in bodies:
            got = [_post(s.port, body) for s in servers[:2]]
            assert got[0] == got[1] and got[0][0] in (400, 501), body
        # a plain engine has no resume path: the same 501 in both
        got = [_post(s.port, dict(base, resume=ok)) for s in servers[2:]]
        assert got[0] == got[1] and got[0][0] == 501
        got = [_post(s.port, dict(base, resume=ok)) for s in servers[:2]]
        assert got[0] == got[1] and got[0][0] == 200
        assert [ln["step"] for ln in got[0][1]] == list(range(4, N))
        assert [ln["tokens"][0] for ln in got[0][1]] == want[4:]
    finally:
        for s in servers:
            s.shutdown()
        port_b.close()
        ref_b.close()
