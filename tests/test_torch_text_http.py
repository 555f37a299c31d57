"""Text prompts, stop strings and the telemetry routes over HTTP: the
port's servers against the JAX package's, same weights, same tokenizer.

A plain server (``InferenceEngine``) and a 4-slot batching server
(``ContinuousBatchingEngine``) on each side, all on ``llama-test`` with
the bridge's weights and one crafted 256-piece sentencepiece model.
Text prompts, stop strings (blocking and streamed, with logprobs,
several stops, a stop across tokens, one never hit, an eos) and the
validation answers give equal JSON; ``/metrics`` counters that do not
depend on time move alike; ``/timeline``, ``/debugz`` and ``/trace``
have the reference's shape; a streamed stop frees the batching slot.

The reference's batching engine has no streamed logprobs (its server
answers 501 to ``stream`` or ``stop`` with ``logprobs``; the port's
streams them, ROADMAP C): those answers are held to the reference's
plain server instead.
"""

import itertools
import json
import string
import time
import urllib.error
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
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu.telemetry import slo as ref_slo
from distributed_inference_demo_tpu.tokenizer import Tokenizer as RefTokenizer
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
from distributed_inference_demo_tpu_torch.sp_tokenizer import (
    CONTROL, NORMAL, UNKNOWN, build_model_proto)
from distributed_inference_demo_tpu_torch.telemetry import slo
from distributed_inference_demo_tpu_torch.tokenizer import Tokenizer

PROMPT = "the cat sat on the mat"
MAX_NEW = 10
BATCH_KW = dict(max_seq=64, max_batch=4, prompt_buckets=(16, 64),
                kv_block_tokens=8)
KINDS = ["plain", "batching"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _model_blob() -> bytes:
    """256 unigram pieces, so every llama-test id decodes to text:
    specials, words, letters with and without the word marker, and
    letter pairs."""
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL), ("▁", -40.0, NORMAL)]
    words = ["hello", "world", "the", "cat", "sat", "on", "mat", "a"]
    pieces += [(f"▁{w}", -float(i + 1), NORMAL) for i, w in enumerate(words)]
    pieces += [(f"▁{c}", -20.0, NORMAL) for c in string.ascii_lowercase]
    pieces += [(c, -30.0, NORMAL) for c in string.ascii_lowercase]
    pairs = ("".join(p) for p in itertools.product(string.ascii_lowercase,
                                                    repeat=2))
    while len(pieces) < 256:
        pieces.append((next(pairs), -25.0, NORMAL))
    return build_model_proto(pieces)


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _parse(code, body):
    if code != 200:
        return code, json.loads(body)
    lines = [json.loads(ln) for ln in body.splitlines() if ln.strip()]
    return code, lines[0] if len(lines) == 1 else lines


def _assert_same(port, ref, path="$"):
    """Equal JSON, logprobs within 2e-4."""
    assert type(port) is type(ref), (path, port, ref)
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            if k == "logprobs":
                np.testing.assert_allclose(
                    np.asarray(port[k], float), np.asarray(ref[k], float),
                    atol=2e-4, err_msg=path)
            else:
                _assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), (path, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, (path, port, ref)


@pytest.fixture(scope="module")
def tok():
    blob = _model_blob()
    return Tokenizer.from_sentencepiece(blob), RefTokenizer.from_sentencepiece(
        blob)


@pytest.fixture(scope="module")
def servers(tok):
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    p = params_from_numpy(tree, cfg, "cpu")
    slo.set_slo_ledger(None)
    ref_slo.set_slo_ledger(None)
    engines = {
        "port": {"plain": InferenceEngine(
                     cfg, p, max_seq=64, sampling=SamplingParams(greedy=True),
                     device="cpu"),
                 "batching": ContinuousBatchingEngine(
                     cfg, p, sampling=SamplingParams(greedy=True),
                     device="cpu", **BATCH_KW)},
        "ref": {"plain": RefEngine(
                    rcfg, rp, max_seq=64,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="jnp"),
                "batching": RefBatching(
                    rcfg, rp, sampling=RefSamplingParams(greedy=True),
                    **BATCH_KW)}}
    made = {"port": InferenceHTTPServer, "ref": RefServer}
    srv = {side: {kind: made[side](eng, tokenizer=tok[side == "ref"],
                                   model_name="llama-test")
                  for kind, eng in engines[side].items()}
           for side in engines}
    for side in srv.values():
        for s in side.values():
            s.start()
    yield ({side: {k: s.port for k, s in d.items()} for side, d in
            srv.items()}, engines)
    for side in srv.values():
        for s in side.values():
            s.shutdown()
    engines["port"]["batching"].close()
    engines["ref"]["batching"].close()


@pytest.fixture(scope="module")
def base(servers, tok):
    """The plain greedy run with no stop: tokens, text, and each token's
    cumulative text length."""
    ports, _ = servers
    code, out = _parse(*_post(ports["port"]["plain"],
                              {"prompt": PROMPT, "max_new_tokens": MAX_NEW}))
    assert code == 200
    toks, text = out["tokens"][0], out["text"][0]
    ends = [len(tok[0].decode(toks[:i + 1])) for i in range(len(toks))]
    assert len(text) >= 8, text
    return toks, text, ends


def test_text_prompt_is_the_encoded_ids(servers, tok):
    ports, _ = servers
    ids = tok[0].encode(PROMPT)
    assert ids == tok[1].encode(PROMPT)
    for kind in KINDS:
        a = _parse(*_post(ports["port"][kind], {"prompt": PROMPT,
                                                "max_new_tokens": MAX_NEW}))
        b = _parse(*_post(ports["port"][kind], {"prompt_ids": [ids],
                                                "max_new_tokens": MAX_NEW}))
        assert a == b
        assert a[1]["text"] == [tok[0].decode(a[1]["tokens"][0])]


@pytest.mark.parametrize("logprobs", [False, True])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_text_prompt_equals_reference(servers, kind, stream, logprobs):
    ports, _ = servers
    body = {"prompt": PROMPT, "max_new_tokens": MAX_NEW,
            "logprobs": logprobs, "stream": stream}
    ref_kind = "plain" if (kind == "batching" and stream and logprobs) \
        else kind
    port = _parse(*_post(ports["port"][kind], body))
    ref = _parse(*_post(ports["ref"][ref_kind], body))
    assert port[0] == 200
    _assert_same(port, ref)
    if stream:
        blocking = _parse(*_post(ports["port"][kind],
                                 dict(body, stream=False)))[1]
        deltas = "".join(ln["text"][0] for ln in port[1])
        assert deltas == blocking["text"][0]


def _stop_case(case, toks, text, ends):
    """(stop, eos_id) for each case, from the run with no stop."""
    def first_unique(start, n):
        for k in range(start, len(text) - n + 1):
            if text.find(text[k:k + n]) == k:
                return text[k:k + n]
        raise AssertionError(f"no unique substring in {text!r}")

    mid = first_unique(len(text) // 2, 3)
    if case == "mid":
        return mid, None
    if case == "several":
        return ["QQQ", mid, first_unique(len(text) - 3, 2)], None
    if case == "spanning":
        for b in ends[1:-1]:
            if b >= 2 and text.find(text[b - 1:b + 1]) == b - 1 \
                    and b - 1 not in ends:
                return text[b - 1:b + 1], None
        return text[ends[1] - 1:ends[1] + 1], None
    if case == "never":
        return ["QQQ", "ZZ"], None
    return "QQQ", toks[4]                    # eos


STOP_CASES = ["mid", "several", "spanning", "never", "eos"]


@pytest.mark.parametrize("mode", ["blocking", "stream", "blocking_lp",
                                  "stream_lp"])
@pytest.mark.parametrize("case", STOP_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_stop_strings_equal_reference(servers, base, kind, case, mode):
    ports, engines = servers
    toks, text, ends = base
    stop, eos = _stop_case(case, toks, text, ends)
    body = {"prompt": PROMPT, "max_new_tokens": MAX_NEW, "stop": stop,
            "stream": mode.startswith("stream"),
            "logprobs": mode.endswith("_lp")}
    ref_kind = "plain" if (kind == "batching" and body["logprobs"]) \
        else kind
    for side, k in (("port", kind), ("ref", ref_kind)):
        engines[side][k].eos_id = eos
    try:
        port = _parse(*_post(ports["port"][kind], body))
        ref = _parse(*_post(ports["ref"][ref_kind], body))
    finally:
        for side, k in (("port", kind), ("ref", ref_kind)):
            engines[side][k].eos_id = None
    assert port[0] == 200, port
    _assert_same(port, ref)
    final = port[1][-1] if body["stream"] else port[1]
    got = final["tokens"][0]
    assert got == toks[:len(got)]
    reason = final["stop_reason"][0]
    if case == "eos":
        assert reason == "eos" and got == toks[:toks.index(eos) + 1]
    elif case == "never":
        assert reason == "length" and got == toks
    else:
        stops = [stop] if isinstance(stop, str) else stop
        cut = min(text.find(s) for s in stops if s in text)
        assert reason == "stop"
        out_text = ("".join(ln["text"][0] for ln in port[1][:-1])
                    if body["stream"] else final["text"][0])
        assert out_text == text[:cut]
    if body["logprobs"]:
        assert len(final["logprobs"][0]) == len(got)


@pytest.mark.parametrize("kind", KINDS)
def test_validation_answers_equal_reference(servers, kind):
    ports, engines = servers
    for stop in ("", [], 5, ["a", ""]):
        body = {"prompt": PROMPT, "max_new_tokens": 4, "stop": stop}
        port = _post(ports["port"][kind], body)
        ref = _post(ports["ref"][kind], body)
        assert port[0] == ref[0] == 400
        assert json.loads(port[1]) == json.loads(ref[1])
    # a server with no tokenizer: a text prompt is a 400, a stop a 501
    bare = {"port": InferenceHTTPServer(engines["port"][kind]),
            "ref": RefServer(engines["ref"][kind])}
    for s in bare.values():
        s.start()
    try:
        for body in ({"prompt": PROMPT, "max_new_tokens": 4},
                     {"prompt_ids": [[5, 6, 7]], "max_new_tokens": 4,
                      "stop": "x"},
                     {"max_new_tokens": 4}):
            port = _post(bare["port"].port, body)
            ref = _post(bare["ref"].port, body)
            assert port[0] == ref[0] and port[0] in (400, 501)
            assert json.loads(port[1]) == json.loads(ref[1])
    finally:
        for s in bare.values():
            s.shutdown()
    # resume answers as the reference server does (a 400 for an empty
    # journal on the batching engine, a 501 on the plain one), and so
    # does an image sent to a text backend (the reference's 501)
    for body in ({"prompt": PROMPT, "stream": True, "resume": {}},
                 {"prompt": PROMPT, "stream": True, "image": {}},
                 {"prompt": PROMPT, "image": {}}):
        port, ref = (_post(ports[s][kind], body) for s in ("port", "ref"))
        assert port[0] == ref[0] and port[0] in (400, 501)
        assert json.loads(port[1]) == json.loads(ref[1])
        assert "not yet ported" not in port[1]


def _settle(want: dict) -> None:
    """Wait until each side's SLO ledger holds ``want[side]`` timelines:
    a request's timeline (and its spans) closes on the scheduler thread
    just after its answer is released."""
    ledgers = {"port": slo.get_slo_ledger, "ref": ref_slo.get_slo_ledger}
    deadline = time.monotonic() + 30
    while any(len(ledgers[s]().recent(1024)) < n for s, n in want.items()):
        assert time.monotonic() < deadline, "timelines did not close"
        time.sleep(0.01)


def _counters(text: str) -> dict:
    """The samples of the time-independent counters in an exposition."""
    keep = ("dwt_http_requests_total", "dwt_http_generated_tokens_total",
            "dwt_batching_completed_requests_total")
    out = {}
    for ln in text.splitlines():
        if ln.startswith(keep):
            key, val = ln.rsplit(" ", 1)
            out[key] = float(val)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_metrics_timeline_debugz_move_like_the_reference(servers, kind):
    ports, _ = servers
    before, tl_before = {}, {}
    for side in ("port", "ref"):
        code, text = _get(ports[side][kind], "/metrics")
        assert code == 200
        before[side] = _counters(text)
        tl_before[side] = json.loads(
            _get(ports[side][kind], "/timeline?n=1024")[1])
    for body in ({"prompt": PROMPT, "max_new_tokens": MAX_NEW},
                 {"prompt": PROMPT, "max_new_tokens": 6, "stream": True},
                 {"prompt_ids": [[5, 6, 7]], "max_new_tokens": 3,
                  "tenant": "acme"},
                 {"prompt_ids": [[1] * 60], "max_new_tokens": 10}):
        codes = [_post(ports[side][kind], body)[0]
                 for side in ("port", "ref")]
        assert codes[0] == codes[1]
    served = 3 if kind == "batching" else 0
    _settle({s: len(tl_before[s]["recent"]) + served for s in tl_before})
    delta, tl = {}, {}
    for side in ("port", "ref"):
        code, text = _get(ports[side][kind], "/metrics")
        after = _counters(text)
        delta[side] = {k: v - before[side].get(k, 0.0)
                       for k, v in after.items()
                       if v != before[side].get(k, 0.0)}
        assert all(ln.startswith(("#", "dwt_")) for ln in text.splitlines()
                   if ln)
        tl[side] = json.loads(_get(ports[side][kind], "/timeline?n=1024")[1])
    assert delta["port"] == delta["ref"]
    assert delta["port"][
        'dwt_http_requests_total{route="/generate",code="200"}'] == 2
    new = {s: tl[s]["recent"][len(tl_before[s]["recent"]):]
           for s in tl}
    assert len(new["port"]) == len(new["ref"]) == served
    assert sorted(tl["port"]) == sorted(tl["ref"])
    for p, r in zip(new["port"], new["ref"]):
        assert sorted(p) == sorted(r)
        assert (p["tenant"], p["tokens"]) == (r["tenant"], r["tokens"])
        assert p["ttft_s"] <= p["e2e_s"]
    debugz = {s: json.loads(_get(ports[s][kind], "/debugz")[1])
              for s in ("port", "ref")}
    assert sorted(debugz["port"]) == sorted(debugz["ref"])
    assert (sorted(debugz["port"]["backend"])
            == sorted(debugz["ref"]["backend"]))
    for s in ("port", "ref"):
        code, sketch = _get(ports[s][kind], "/sketch")
        assert code == 200 and sketch == _get(ports[s][kind], "/sketch")[1]


def test_trace_spans_of_a_traced_request(servers):
    ports, _ = servers
    spans = {}
    for side in ("port", "ref"):
        _get(ports[side]["batching"], "/trace")          # drain
        ledger = (slo if side == "port" else ref_slo).get_slo_ledger()
        closed = len(ledger.recent(1024))
        for stream in (False, True):
            code, _ = _post(ports[side]["batching"],
                            {"prompt": PROMPT, "max_new_tokens": MAX_NEW,
                             "stream": stream},
                            headers={"X-DWT-Trace-Id": f"{0xbeef + stream:x}",
                                     "X-DWT-Tenant": "acme"})
            assert code == 200
        _settle({side: closed + 2})
        code, body = _get(ports[side]["batching"], "/trace")
        assert code == 200
        spans[side] = [e for e in json.loads(body)["traceEvents"]
                       if e["ph"] == "X"]
    names = {s: sorted((e["name"], e["args"]["trace_id"], e["args"]["tenant"])
                       for e in spans[s]) for s in spans}
    assert names["port"] == names["ref"]
    assert sorted({n for n, *_ in names["port"]}) == ["engine.decode",
                                                      "engine.prefill"]
    records = {r["trace_id"]: r for r in json.loads(
        _get(ports["port"]["batching"], "/timeline?n=1024")[1])["recent"]}
    for e in spans["port"]:
        assert e["dur"] <= records[e["args"]["trace_id"]]["e2e_s"] * 1e6 + 1


def test_a_streamed_stop_frees_the_batching_slot(servers, base):
    ports, engines = servers
    toks, text, ends = base
    stop, _ = _stop_case("mid", toks, text, ends)
    eng = engines["port"]["batching"]
    code, body = _post(ports["port"]["batching"],
                       {"prompt": PROMPT, "max_new_tokens": 40,
                        "stop": stop, "stream": True})
    assert code == 200 and json.loads(
        body.splitlines()[-1])["stop_reason"] == ["stop"]
    deadline = time.monotonic() + 30
    while eng.stats()["active_slots"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.stats()["active_slots"] == 0
    mgr = eng.kv_cache
    snap = mgr.snapshot()
    assert snap["blocks_used"] == snap["tree_blocks"]
    ids = mgr.alloc(mgr.num_blocks)          # every page frees or evicts
    assert ids is not None
    mgr.free(ids)
    assert mgr.free_blocks == mgr.num_blocks
