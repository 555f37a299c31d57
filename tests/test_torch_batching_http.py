"""``serve --batch-slots``: the port's HTTP server over its
``ContinuousBatchingEngine`` against the JAX package's, same weights.

One greedy ``/generate``, blocking (with logprobs) and streamed, returns
the same token ids in the same JSON and JSONL shapes from both servers;
concurrent requests complete with the tokens each gets alone; a full
admission queue answers 503 with Retry-After; and the CLI's batching
flags reach the engine.
"""

import json
import os
import threading
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
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer

ENGINE_KW = dict(max_seq=64, max_batch=4, prompt_buckets=(16, 64),
                 kv_block_tokens=8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _request(port, path, body=None):
    """(status, body text, headers)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


@pytest.fixture(scope="module")
def params():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def servers(params):
    rcfg, rp, cfg, p = params
    ref_eng = RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                          **ENGINE_KW)
    port_eng = ContinuousBatchingEngine(cfg, p,
                                        sampling=SamplingParams(greedy=True),
                                        device="cpu", **ENGINE_KW)
    ref = RefServer(ref_eng, model_name="llama-test")
    port = InferenceHTTPServer(port_eng, model_name="llama-test")
    ref.start()
    port.start()
    yield ref.port, port.port, port_eng
    port.shutdown()
    ref.shutdown()
    port_eng.close()
    ref_eng.close()


PROMPT = [5, 17, 99, 3, 42, 7, 250, 1, 9, 14]


@pytest.mark.parametrize("stream", [False, True])
def test_generate_matches_reference_server(servers, stream):
    ref_port, port, _ = servers
    body = {"prompt_ids": [PROMPT], "max_new_tokens": 6}
    if stream:
        body["stream"] = True
    else:
        body["logprobs"] = True
    (rc, rbody, _), (pc, pbody, _) = (_request(p, "/generate", body)
                                      for p in (ref_port, port))
    assert rc == pc == 200
    if stream:
        rlines = [json.loads(ln) for ln in rbody.splitlines()]
        plines = [json.loads(ln) for ln in pbody.splitlines()]
        assert [sorted(ln) for ln in plines] == [sorted(ln) for ln in rlines]
        assert plines == rlines
        assert [ln["step"] for ln in plines] == list(range(6))
    else:
        r, p = json.loads(rbody), json.loads(pbody)
        assert sorted(p) == sorted(r) == ["logprobs", "tokens"]
        assert p["tokens"] == r["tokens"]
        np.testing.assert_allclose(p["logprobs"], r["logprobs"], atol=2e-4)


def test_concurrent_requests_complete(servers):
    """Six requests at once batch in the port engine and each gets the
    tokens the reference server gives it alone."""
    ref_port, port, _ = servers
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, n).tolist() for n in (3, 12, 20, 7, 30, 5)]
    got = [None] * len(prompts)

    def one(i):
        got[i] = _request(port, "/generate", {"prompt_ids": [prompts[i]],
                                              "max_new_tokens": 8})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, p in enumerate(prompts):
        code, body, _ = got[i]
        assert code == 200
        rc, rbody, _ = _request(ref_port, "/generate",
                                {"prompt_ids": [p], "max_new_tokens": 8})
        assert rc == 200
        assert json.loads(body)["tokens"] == json.loads(rbody)["tokens"]


def test_health_stats_and_streamed_logprobs(servers):
    ref_port, port, _ = servers
    (rc, rh, _), (pc, ph, _) = (_request(p, "/health")
                                for p in (ref_port, port))
    rh, ph = json.loads(rh), json.loads(ph)
    assert rc == pc == 200 and sorted(ph) == sorted(rh)
    assert ph["backend"] == rh["backend"] == "ContinuousBatchingEngine"
    rs = json.loads(_request(ref_port, "/stats")[1])
    ps = json.loads(_request(port, "/stats")[1])
    assert set(ps) <= set(rs)
    for key in ("slots", "kv_layout", "queue_depth", "active_slots"):
        assert ps[key] == rs[key]
    assert set(ps["kvcache"]) == set(rs["kvcache"])
    assert ps["kvcache"]["blocks_total"] == rs["kvcache"]["blocks_total"]
    assert set(ps["device_loop"]) == set(rs["device_loop"])
    # the port also streams logprobs, one per step
    code, body, _ = _request(port, "/generate", {
        "prompt_ids": [PROMPT], "max_new_tokens": 4, "stream": True,
        "logprobs": True})
    lines = [json.loads(ln) for ln in body.splitlines()]
    assert code == 200 and len(lines) == 4
    assert all(len(ln["logprobs"]) == 1 and ln["logprobs"][0] <= 0
               for ln in lines)


def test_full_admission_queue_answers_503(params):
    _, _, cfg, p = params
    eng = ContinuousBatchingEngine(cfg, p, sampling=SamplingParams(
        greedy=True), device="cpu", max_queue_depth=1,
        **dict(ENGINE_KW, max_batch=1))
    server = InferenceHTTPServer(eng, model_name="llama-test")
    server.start()
    try:
        busy = eng.submit(PROMPT, 50)
        t_end = time.monotonic() + 120
        while not busy.tokens:
            assert time.monotonic() < t_end
            time.sleep(0.002)
        waiting = eng.submit([1, 2, 3], 2)
        for stream in (False, True):
            code, body, headers = _request(server.port, "/generate", {
                "prompt_ids": [[4, 5, 6]], "max_new_tokens": 2,
                "stream": stream})
            assert code == 503 and "queue full" in body
            assert headers["Retry-After"] == "1"
        busy.cancel()
        assert len(waiting.wait(120)) == 2
    finally:
        server.shutdown()
        eng.close()


def test_cli_batching_flags(capsys, monkeypatch):
    args = cli._serve_parser().parse_args([
        "--model", "llama-test", "--device", "cpu", "--batch-slots", "2",
        "--kv-cache-blocks", "40", "--kv-block-tokens", "8",
        "--decode-block", "2", "--prefill-chunk", "16",
        "--admission-queue-depth", "3", "--max-seq", "64"])
    _, eng = cli.build_batching_engine(args)
    try:
        assert (eng.max_batch, eng.kv_cache.num_blocks,
                eng.kv_cache.block_tokens, eng.decode_block,
                eng.prefill_chunk, eng.max_queue_depth) == (2, 40, 8, 2,
                                                            16, 3)
    finally:
        eng.close()
    # serve prints its banner and serves until stopped: here it answers
    # one /health and stops
    health = []

    def serve_briefly(self):
        self.start()
        health.append(json.loads(_request(self.port, "/health")[1]))

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--batch-slots", "2", "--http-port", "0"]) == 0
    assert health[0]["backend"] == "ContinuousBatchingEngine"
    out = capsys.readouterr().out
    assert "SERVE_BATCHING llama-test slots=2 kv_cache=" in out
    assert "HTTP_READY http://127.0.0.1:" in out
    # a second K knob is refused, as in the reference
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--batch-slots", "2", "--stream-block", "4"]) == 1
    assert "--decode-block" in capsys.readouterr().err
    # tp under a draft model is served, and refused as the reference
    # refuses it; --sp pairs with no other serve mode (the reference's
    # texts)
    for extra, err in (
            (["--batch-slots", "2", "--tp", "2", "--draft-model",
              "llama-test", "--stream-block", "4"],
             "--stream-block is not supported with --batch-slots (use "
             "--decode-block)"),
            (["--sp", "2", "--batch-slots", "2"],
             "choose one serve mode, got --batch-slots + --sp")):
        assert cli.main(["serve", "--model", "llama-test", "--device",
                         "cpu", *extra]) == 1
        assert err in capsys.readouterr().err
    # the tier flags are served; a disk segment without the host ring
    # above it is the reference's own refusal (the flags set their env
    # knobs: cleared here, whatever the outcome, and any earlier value
    # restored by monkeypatch)
    knobs = ("DWT_KV_DISK_TIER_PATH", "DWT_KV_DISK_TIER_BYTES")
    for knob in knobs:
        monkeypatch.delenv(knob, raising=False)
    try:
        assert cli.main(["serve", "--model", "llama-test", "--device",
                         "cpu", "--batch-slots", "2", "--kv-disk-tier-path",
                         "/x", "--kv-disk-tier-bytes", "1024"]) == 1
    finally:
        for knob in knobs:
            os.environ.pop(knob, None)
    assert "BELOW the host ring" in capsys.readouterr().err
    # the plain engine's prefix pool is ported: --kv-cache-blocks serves
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--kv-cache-blocks", "4", "--http-port", "0"]) == 0
    assert "kv_cache=4x16tok paged" in capsys.readouterr().out
