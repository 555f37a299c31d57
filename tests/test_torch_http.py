"""The torch port's HTTP server against the JAX package's, same weights.

One greedy ``/generate``, blocking and streaming, to each server returns
the same token ids in the same JSON shape.
"""

import json
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
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny shapes gain nothing from many intra-op threads; cap them so
    parallel test workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _request(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def servers():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    ref = RefServer(RefEngine(rcfg, rp, max_seq=64,
                              sampling=RefSamplingParams(greedy=True),
                              attn_backend="jnp"),
                    model_name="llama-test")
    port = InferenceHTTPServer(
        InferenceEngine(cfg, params_from_numpy(tree, cfg, "cpu"), max_seq=64,
                        sampling=SamplingParams(greedy=True), device="cpu"),
        model_name="llama-test")
    ref.start()
    port.start()
    yield ref.port, port.port
    port.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("stream", [False, True])
def test_generate_matches_reference_server(servers, stream):
    body = {"prompt_ids": [[5, 17, 99, 3, 42, 7, 250, 1]],
            "max_new_tokens": 6, "logprobs": True}
    if stream:
        body["stream"] = True
    (rc, rbody), (pc, pbody) = (_request(p, "/generate", body)
                                for p in servers)
    assert rc == pc == 200
    if stream:
        rlines = [json.loads(ln) for ln in rbody.splitlines()]
        plines = [json.loads(ln) for ln in pbody.splitlines()]
        assert [sorted(ln) for ln in plines] == [sorted(ln) for ln in rlines]
        assert ([ln["tokens"] for ln in plines]
                == [ln["tokens"] for ln in rlines])
        assert [ln["step"] for ln in plines] == list(range(6))
        np.testing.assert_allclose([ln["logprobs"] for ln in plines],
                                   [ln["logprobs"] for ln in rlines],
                                   atol=2e-4)
    else:
        r, p = json.loads(rbody), json.loads(pbody)
        assert sorted(p) == sorted(r) == ["logprobs", "tokens"]
        assert p["tokens"] == r["tokens"]
        np.testing.assert_allclose(p["logprobs"], r["logprobs"], atol=2e-4)


def test_health_stats_and_unported_routes(servers):
    ref_port, port = servers
    (rc, rh), (pc, ph) = (_request(p, "/health") for p in servers)
    rh, ph = json.loads(rh), json.loads(ph)
    assert rc == pc == 200 and sorted(ph) == sorted(rh)
    assert ph["device"] == "cpu" and ph["max_seq"] == rh["max_seq"] == 64
    assert (json.loads(_request(port, "/stats")[1])
            == json.loads(_request(ref_port, "/stats")[1]))
    for path in ("/metrics", "/trace", "/debugz"):
        code, body = _request(port, path)
        assert code == 501 and "not yet ported" in body
    code, body = _request(port, "/generate", {"prompt_ids": [[1, 2]],
                                              "stop": ["x"]})
    assert code == 501 and "not yet ported" in body
    code, _ = _request(port, "/generate", {"prompt_ids": [[1] * 60],
                                           "max_new_tokens": 10})
    assert code == 400          # past the KV capacity, as the reference
    code, body = _request(port, "/classify", {"prompt_ids": [[1, 2, 3]],
                                              "label_token_ids": [4, 9]})
    assert code == 200 and len(json.loads(body)["labels"]) == 1


def test_cli_serve_flags(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["serve", "--model", "llama-test"])
    assert cli.main(["serve", "--model", "llama-test", "--batch-slots",
                     "4", "--kv-host-tier-bytes", "1048576"]) == 1
    assert "not yet ported" in capsys.readouterr().err
    assert cli.main(["worker", "--model", "llama-test"]) == 1
    assert "not yet ported" in capsys.readouterr().err
