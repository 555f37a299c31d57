"""The speculative serve modes and ``generate`` flags of the port's CLI
against the JAX package's, same weights.

``llama-test`` in f32, the reference's weights carried across by
``models/bridge.py``; the draft is ``llama-test`` at 2 layers from
another seed.  A port and a reference ``InferenceHTTPServer`` over a
``SpeculativeBackend`` (draft model, prompt lookup) and over a batching
engine with each proposer answer the same greedy requests, blocking and
streamed, with the same tokens and the same ``/stats``; logprobs are
refused alike.  The CLI: ``serve --draft-model`` / ``--prompt-lookup`` /
``--batch-slots`` with each proposer print their banners and serve; its
refusals equal the reference's; ``generate`` with each flag prints the
reference CLI's JSON.  The ``speculative`` fragment reaches ``/metrics``,
and a collapsing draft trips ``accept_collapse``.
"""

import dataclasses
import io
import json
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu import cli as ref_cli
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu.runtime.prompt_lookup import \
    PromptLookupEngine as RefPromptLookup
from distributed_inference_demo_tpu.runtime.speculative import (
    SpeculativeBackend as RefBackend, SpeculativeEngine as RefSpeculative)
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.runtime.prompt_lookup import \
    PromptLookupEngine
from distributed_inference_demo_tpu_torch.runtime.speculative import (
    SpeculativeBackend, SpeculativeEngine)

MAX_SEQ = 96
GREEDY = SamplingParams(greedy=True)
BATCH_KW = dict(max_seq=MAX_SEQ, max_batch=4, prompt_buckets=(16, 64),
                kv_block_tokens=8, num_draft=3, decode_block=2)
REQUESTS = [[3, 14, 15, 92, 65], list(range(3, 22))]
ENGINE_ARGS = ["--model", "llama-test", "--max-seq", "64", "--greedy"]


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


def _request(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _answers(server_cls, backend):
    """Blocking and streamed answers to REQUESTS one after another, the
    logprobs answer, then ``/stats``."""
    server = server_cls(backend, host="127.0.0.1", port=0,
                        model_name="llama-test", default_max_new=8)
    server.start()
    try:
        out = []
        for ids in REQUESTS:
            code, text = _request(server.port, "/generate",
                                  {"prompt_ids": [ids],
                                   "max_new_tokens": 10})
            assert code == 200, text
            code, stream = _request(server.port, "/generate",
                                    {"prompt_ids": [ids],
                                     "max_new_tokens": 10, "stream": True})
            assert code == 200, stream
            out.append((json.loads(text), [json.loads(ln) for ln in
                                           stream.splitlines()
                                           if ln.strip()]))
        lp = _request(server.port, "/generate",
                      {"prompt_ids": [REQUESTS[0]], "max_new_tokens": 4,
                       "logprobs": True})
        stats = json.loads(_request(server.port, "/stats")[1])
    finally:
        server.shutdown()
    return out, lp, stats


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_speculative_servers_equal_reference(models, mode):
    m = models
    if mode == "draft":
        port = SpeculativeEngine(m["cfg"], m["p"], m["dcfg"], m["dp"],
                                 max_seq=MAX_SEQ, sampling=GREEDY,
                                 device="cpu")
        ref = RefSpeculative(m["rcfg"], m["rp"], m["rdcfg"], m["rdp"],
                             max_seq=MAX_SEQ,
                             sampling=RefSamplingParams(greedy=True))
    else:
        port = PromptLookupEngine(m["cfg"], m["p"], max_seq=MAX_SEQ,
                                  sampling=GREEDY, device="cpu")
        ref = RefPromptLookup(m["rcfg"], m["rp"], max_seq=MAX_SEQ,
                              sampling=RefSamplingParams(greedy=True))
    got, glp, gstats = _answers(InferenceHTTPServer, SpeculativeBackend(port))
    want, wlp, wstats = _answers(RefServer, RefBackend(ref))
    assert got == want
    for blocking, stream in got:
        assert [ln["tokens"][0] for ln in stream] == blocking["tokens"][0]
    assert glp == wlp and glp[0] == 501
    assert gstats == wstats and gstats["speculative"]["rounds"] >= 1


@pytest.mark.parametrize("mode", ["draft", "pld"])
def test_batching_servers_equal_reference(models, mode):
    m = models
    if mode == "draft":
        pk = dict(draft_cfg=m["dcfg"], draft_params=m["dp"])
        rk = dict(draft_cfg=m["rdcfg"], draft_params=m["rdp"])
    else:
        pk = rk = dict(prompt_lookup=True)
    port = ContinuousBatchingEngine(m["cfg"], m["p"], sampling=GREEDY,
                                    device="cpu", **pk, **BATCH_KW)
    ref = RefBatching(m["rcfg"], m["rp"],
                      sampling=RefSamplingParams(greedy=True), **rk,
                      **BATCH_KW)
    try:
        got, glp, gstats = _answers(InferenceHTTPServer, port)
        want, wlp, wstats = _answers(RefServer, ref)
    finally:
        port.close()
        ref.close()
    assert got == want
    assert glp == wlp and glp[0] == 400 and "logprobs" in glp[1]
    assert gstats["speculative"] == wstats["speculative"]
    assert gstats["spec_backlog_tokens"] == wstats["spec_backlog_tokens"]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture()
def bridged(models, monkeypatch):
    """The port CLI's engines get the reference's seed-0 weights, the
    draft too (the reference CLI draws the draft from the same seed)."""
    cfg, p = models["cfg"], models["p"]
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, p))
    monkeypatch.setattr(cli, "_draft_params", lambda args, device: (cfg, p))


@pytest.mark.parametrize("flag", [["--draft-model", "llama-test"],
                                  ["--prompt-lookup"]])
def test_generate_equals_reference(bridged, flag):
    tail = ["--prompt-ids", "5,17,42,7,5,17,42", "--max-new-tokens", "9",
            *flag]
    rc, out, _ = _run(cli.main, ["generate", *ENGINE_ARGS, "--device",
                                 "cpu", *tail])
    rrc, rout, _ = _run(ref_cli.main, ["generate", *ENGINE_ARGS,
                                       "--attn-backend", "jnp", *tail])
    assert rc == rrc == 0
    port, ref = json.loads(out), json.loads(rout)
    assert sorted(port) == sorted(ref)
    assert port["tokens"] == ref["tokens"]
    assert port["speculative"] == ref["speculative"]


def test_cli_serve_modes_and_refusals(bridged, monkeypatch):
    health = []

    def serve_briefly(self):
        self.start()
        code, text = _request(self.port, "/health")
        health.append(json.loads(text))

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    serve = ["serve", *ENGINE_ARGS, "--device", "cpu", "--http-port", "0"]
    for extra, banner, backend in (
            (["--draft-model", "llama-test"],
             "SERVE_SPECULATIVE llama-test draft=llama-test k=4",
             "SpeculativeBackend"),
            (["--prompt-lookup", "--num-draft", "3"],
             "SERVE_PROMPT_LOOKUP llama-test k=3", "SpeculativeBackend"),
            (["--batch-slots", "2", "--draft-model", "llama-test"],
             "draft=llama-test k=4 k_adaptive", "ContinuousBatchingEngine"),
            (["--batch-slots", "2", "--prompt-lookup",
              "--no-spec-adaptive"], "prompt_lookup k=4",
             "ContinuousBatchingEngine")):
        rc, out, err = _run(cli.main, serve + extra)
        assert rc == 0, err
        assert banner in out and "HTTP_READY" in out
        assert health[-1]["backend"] == backend
    assert "k_adaptive" not in out
    # refusals, as the reference's
    for extra, msg in (
            (["--draft-model", "llama-test", "--prompt-lookup"],
             "choose one serve mode, got --draft-model + --prompt-lookup"),
            (["--no-spec-adaptive"], "--no-spec-adaptive requires"),
            (["--draft-model", "llama-test", "--stream-block", "2"],
             "--stream-block is not supported with --draft-model")):
        rc, _, err = _run(cli.main, serve + extra)
        assert rc == 1 and msg in err
    rc, _, err = _run(cli.main, ["generate", *ENGINE_ARGS, "--device", "cpu",
                                 "--prompt-ids", "1,2", "--prompt-lookup",
                                 "--draft-model", "llama-test"])
    rrc, _, rerr = _run(ref_cli.main, ["generate", *ENGINE_ARGS,
                                       "--prompt-ids", "1,2",
                                       "--prompt-lookup", "--draft-model",
                                       "llama-test"])
    assert rc == rrc == 1 and err == rerr


def test_metrics_bridge_and_accept_collapse(models):
    """The ``speculative`` fragment reaches ``/metrics`` through the
    telemetry catalog's bridge, and a draft that never agrees with the
    target trips the anomaly detector's ``accept_collapse``."""
    from distributed_inference_demo_tpu_torch.telemetry.anomaly import \
        AnomalyDetector
    m = models
    with ContinuousBatchingEngine(m["cfg"], m["p"], sampling=GREEDY,
                                  device="cpu", draft_cfg=m["dcfg"],
                                  draft_params=m["dp"], **BATCH_KW) as eng:
        for p in ([3, 14, 15], [9, 2, 6, 5], [7, 7, 1]):
            eng.submit(p, 32).wait(timeout=120)
        stats = eng.stats()
        server = InferenceHTTPServer(eng, host="127.0.0.1", port=0)
        server.start()
        try:
            code, text = _request(server.port, "/metrics")
        finally:
            server.shutdown()
    sp = stats["speculative"]
    assert code == 200
    series = {ln.split()[0]: float(ln.split()[1]) for ln in
              text.splitlines() if ln.startswith("dwt_speculative_")}
    assert series["dwt_speculative_rounds_total"] == sp["rounds"]
    assert series["dwt_speculative_drafted_tokens_total"] == sp["drafted"]
    assert series["dwt_speculative_accepted_tokens_total"] == sp["accepted"]
    assert series["dwt_speculative_accept_ratio"] == sp["acceptance_rate"]
    det = AnomalyDetector()
    assert sp["rounds"] * sp["num_draft"] >= det.thresholds.accept_min_drafted
    fired = [a for _ in range(det.thresholds.sustain)
             for a in det.observe(stats)]
    assert [a.kind for a in fired] == ["accept_collapse"]
