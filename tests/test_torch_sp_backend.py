"""``serve --sp``: the torch port's ``SequenceParallelBackend`` against
the JAX package's engine and CLI, over one sp=2 mesh of processes (rank
0 here, one spawned follower, gloo) shared by the module.

Greedy tokens through the sp HTTP backend, ring and Ulysses, equal the
reference engine's on the same weights; bad prompts are clean 400s with
the reference's texts; ``/stats`` shows the queue; a second client past
the bound gets 429 + Retry-After while the first waits; streaming is
incremental and equal to the fused path (a partial final block, the
capacity edge, float8 caches, eos); the CLI's pairing rules give the
reference's texts; ``generate`` and ``serve --sp 2`` run on the CPU.
"""

import http.client
import json
import threading
import time
import urllib.request

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
from distributed_inference_demo_tpu.parallel.sequence import \
    validate_sp_prompt as ref_validate_sp_prompt
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_sp_mesh
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.runtime.sp_backend import \
    SequenceParallelBackend

GREEDY = SamplingParams(greedy=True)
RGREEDY = RefSamplingParams(greedy=True)
PROMPT = [[5, 17, 42, 7, 9, 2, 30, 11]]          # len 8, divides sp=2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    with local_sp_mesh(2, device="cpu", timeout_s=120) as m:
        yield m


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a)
                                       for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


def _oracle(weights, prompt, n, **kw):
    rcfg, rp, _, _ = weights
    return RefEngine(rcfg, rp, max_seq=32, sampling=RGREEDY, **kw
                     ).generate(np.asarray(prompt), n).tokens


def _backend(weights, mesh, **kw):
    _, _, cfg, params = weights
    return SequenceParallelBackend(cfg, params, mesh,
                                   **dict(dict(max_seq=32, sampling=GREEDY),
                                          **kw))


@pytest.fixture(scope="module", params=["ring", "ulysses"])
def sp_server(request, weights, mesh):
    backend = _backend(weights, mesh, strategy=request.param)
    server = InferenceHTTPServer(backend, port=0, model_name="llama-test")
    server.start()
    yield server, backend
    server.shutdown()


def _req(server, method, path, body=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, data, headers


def test_sp_serve_matches_reference_engine(sp_server, weights):
    server, _ = sp_server
    status, data, _ = _req(server, "POST", "/generate",
                           {"prompt_ids": PROMPT, "max_new_tokens": 4})
    assert status == 200
    assert json.loads(data)["tokens"] == _oracle(weights, PROMPT, 4).tolist()


def _ref_error(plen, num_new):
    with pytest.raises(ValueError) as want:
        ref_validate_sp_prompt(plen, 2, 32, num_new)
    return str(want.value)


def test_sp_serve_rejects_indivisible_prompt(sp_server):
    server, _ = sp_server
    status, data, _ = _req(server, "POST", "/generate",
                           {"prompt_ids": [[1, 2, 3]], "max_new_tokens": 4})
    assert status == 400
    assert json.loads(data)["error"] == _ref_error(3, 4)


def test_sp_serve_rejects_over_capacity(sp_server):
    server, _ = sp_server
    status, data, _ = _req(server, "POST", "/generate",
                           {"prompt_ids": [list(range(30))],
                            "max_new_tokens": 10})
    assert status == 400
    assert json.loads(data)["error"] == _ref_error(30, 10)


def test_sp_serve_stats(sp_server):
    server, backend = sp_server
    status, data, _ = _req(server, "GET", "/stats")
    assert status == 200
    body = json.loads(data)
    assert body["mode"] == "sequence_parallel" and body["sp"] == 2
    assert body["strategy"] == backend.strategy
    assert body["queue_depth"] == 0 and body["busy"] is False
    assert body["queue_bound"] == backend.max_queue_depth == 8


def test_sp_serve_streaming(sp_server, weights):
    server, _ = sp_server
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    conn.request("POST", "/generate",
                 body=json.dumps({"prompt_ids": PROMPT, "max_new_tokens": 4,
                                  "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    lines = [json.loads(ln) for ln in resp.read().decode().splitlines()
             if ln.strip()]
    conn.close()
    assert ([ln["tokens"][0] for ln in lines]
            == _oracle(weights, PROMPT, 4)[0].tolist())


def test_sp_backend_bounds_compiled_variants(sp_server):
    _, backend = sp_server
    for n in range(1, backend.MAX_COMPILED_VARIANTS + 3):
        backend._fn(n)
    assert len(backend._fns) == backend.MAX_COMPILED_VARIANTS


def test_sp_queue_two_clients_visibility_and_429(weights, mesh):
    """While one request holds the sp lock, a second client shows on
    /stats and, past the bound, a third gets 429 + Retry-After at once
    (blocking and streaming alike); the queued client completes."""
    backend = _backend(weights, mesh, strategy="ring", max_queue_depth=1)
    server = InferenceHTTPServer(backend, port=0, model_name="llama-test")
    server.start()
    body = {"prompt_ids": PROMPT, "max_new_tokens": 2}
    try:
        backend._admit()
        backend._lock.acquire()
        try:
            results = {}
            t = threading.Thread(target=lambda: results.update(
                a=_req(server, "POST", "/generate", body)), daemon=True)
            t.start()
            deadline = time.monotonic() + 30
            while True:
                stats = json.loads(_req(server, "GET", "/stats")[1])
                if stats["queue_depth"] >= 1:
                    break
                assert time.monotonic() < deadline, "A never queued"
                time.sleep(0.02)
            assert stats["busy"] is True and stats["queue_bound"] == 1
            status, data, headers = _req(server, "POST", "/generate", body)
            assert status == 429 and int(headers["Retry-After"]) >= 1
            assert "queue full" in json.loads(data)["error"]
            status, _, headers = _req(server, "POST", "/generate",
                                      dict(body, stream=True))
            assert status == 429 and "Retry-After" in headers
        finally:
            backend._lock.release()
        t.join(timeout=60)
        assert results["a"][0] == 200
        backend._leave()
        stats = json.loads(_req(server, "GET", "/stats")[1])
        assert stats["queue_depth"] == 0 and stats["busy"] is False
    finally:
        server.shutdown()


def test_sp_backend_rejects_bad_config_at_construction(weights, mesh):
    with pytest.raises(ValueError, match="max_seq=33 not divisible by sp"):
        _backend(weights, mesh, max_seq=33)
    with pytest.raises(ValueError, match="unknown sp strategy"):
        _backend(weights, mesh, strategy="tree")


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_backend_fp8_cache_matches_fp8_engine(strategy, weights, mesh):
    want = _oracle(weights, PROMPT, 6, kv_cache_dtype="float8_e4m3fn")
    backend = _backend(weights, mesh, strategy=strategy,
                       kv_cache_dtype="float8_e4m3fn")
    np.testing.assert_array_equal(backend.generate(np.asarray(PROMPT),
                                                   6).tokens, want)
    backend.STREAM_BLOCK = 4
    got = np.stack(list(backend.generate_stream(np.asarray(PROMPT), 6)), 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_stream_fns_greedy_parity_and_partial_block(strategy, weights,
                                                       mesh):
    """The step-split stream equals the fused generate for greedy: below a
    block, a partial final block, several blocks, and the capacity edge
    (prompt + new == max_seq)."""
    backend = _backend(weights, mesh, strategy=strategy)
    backend.STREAM_BLOCK = 4
    _, _, cfg, _ = weights
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 16))
    for num_new in (3, 6, 13, 16):
        want = backend.generate(prompt, num_new).tokens
        got = np.stack(list(backend.generate_stream(prompt, num_new)), 1)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _oracle(weights, prompt, 16))


def test_sp_stream_is_incremental(weights, mesh):
    """Token #1 arrives after the prefill alone; an abandoned stream
    frees the lock and its state on every rank; one pair serves every
    max_new_tokens."""
    backend = _backend(weights, mesh, strategy="ring")
    backend.STREAM_BLOCK = 4
    prompt = np.asarray(PROMPT)
    handles = len(mesh.objects)
    gen = backend.generate_stream(prompt, 12)
    assert next(gen).shape == (1,)
    gen.close()
    assert not backend._lock.locked() and len(mesh.objects) == handles
    assert backend.generate(prompt, 4).tokens.shape == (1, 4)
    pair = backend._stream_pair
    got6 = np.stack(list(backend.generate_stream(prompt, 6)), 1)
    got9 = np.stack(list(backend.generate_stream(prompt, 9)), 1)
    np.testing.assert_array_equal(got6, got9[:, :6])
    assert backend._stream_pair is pair


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_backend_eos_matches_engine_and_stops_early(strategy, weights,
                                                       mesh):
    ref = _oracle(weights, PROMPT, 10)
    eos = int(ref[0, 2])
    want = _oracle(weights, PROMPT, 10, eos_id=eos)
    backend = _backend(weights, mesh, strategy=strategy, eos_id=eos)
    backend.STREAM_BLOCK = 4
    np.testing.assert_array_equal(
        backend.generate(np.asarray(PROMPT), 10).tokens, want)
    steps = list(backend.generate_stream(np.asarray(PROMPT), 10))
    assert len(steps) == 3 and int(steps[-1][0]) == eos
    np.testing.assert_array_equal(np.stack(steps, 1), want[:, :3])


def test_sp_backend_instant_eos_reports_prefill_seconds(weights, mesh):
    first = int(_oracle(weights, PROMPT, 1)[0, 0])
    backend = _backend(weights, mesh, strategy="ring", eos_id=first)
    res = backend.generate(np.asarray(PROMPT), 10)
    assert res.tokens[0, 0] == first and res.seconds > 0.0
    assert res.tokens_per_second == res.tokens_per_second
    assert backend.generate(np.asarray(PROMPT), 1).seconds > 0.0


def test_sp_serve_mode_pairing_rules_equal_reference(capsys):
    base = ["serve", "--model", "llama-test", "--sp", "2"]
    for extra in (["--batch-slots", "2"], ["--draft-model", "llama-test"],
                  ["--prompt-lookup"], ["--chain", "w@127.0.0.1:1"],
                  ["--tp", "2"], ["--prefill-chunk", "4"],
                  ["--stream-block", "4"], ["--kv-cache-blocks", "8"]):
        assert cli.main(base + ["--device", "cpu"] + extra) == 1
        err = capsys.readouterr().err
        assert ref_cli.main(base + extra) == 1
        assert err == capsys.readouterr().err and err, extra


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_cli_generate_and_serve_sp2(strategy, weights, capsys, monkeypatch):
    """``generate --sp 2`` prints the reference engine's greedy tokens
    under both strategies; ``serve --sp 2`` answers over HTTP."""
    _, _, cfg, params = weights
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, params))
    flags = ["--model", "llama-test", "--device", "cpu", "--greedy",
             "--max-seq", "32", "--sp", "2", "--sp-strategy", strategy]
    assert cli.main(["generate", *flags, "--prompt-ids",
                     ",".join(map(str, PROMPT[0])),
                     "--max-new-tokens", "5"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = _oracle(weights, PROMPT, 5).tolist()
    assert out["tokens"] == want
    assert (out["sp"], out["sp_strategy"]) == (2, strategy)
    answers = []

    def serve_briefly(self):
        self.start()
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}/generate",
            data=json.dumps({"prompt_ids": PROMPT,
                             "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers.append(json.loads(r.read())["tokens"])

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    assert cli.main(["serve", *flags, "--http-port", "0"]) == 0
    assert f"SERVE_SP llama-test sp=2 strategy={strategy} max_seq=32" in \
        capsys.readouterr().out
    assert answers == [want]
