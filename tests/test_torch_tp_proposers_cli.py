"""``serve``, ``generate`` and ``bench`` of the torch port with ``--tp 2``
and a proposer, on the CPU.

``serve --tp 2`` with a draft model and with 2-slot prompt-lookup
batching answers ``POST /generate`` with the
JAX package's greedy tokens (``llama-test`` in f32 on the reference's
weights, carried across by ``models/bridge.py``); ``generate --tp 2
--prompt-lookup`` prints them too, and ``bench --tp 2 --draft-model``
times the speculative engine beside its baseline on the same mesh.  No
follower outlives a command.
"""

import json
import multiprocessing
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
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _models():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return dict(rcfg=rcfg, rp=rp, cfg=cfg,
                p=params_from_numpy(tree, cfg, "cpu"))


def _followers():
    return {p for p in multiprocessing.active_children()
            if p.name.startswith("mesh-follower")}


def _post(server, prompt, n):
    body = json.dumps({"prompt_ids": [prompt],
                       "max_new_tokens": n}).encode()
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_cli_tp2_with_proposers(capsys, monkeypatch):
    """``serve --tp 2`` with a draft model and with 2-slot prompt-lookup
    batching answers the reference engine's greedy tokens; ``generate``
    and ``bench`` take ``--tp 2`` with a proposer; no follower outlives
    a command."""
    m = _models()
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), m["cfg"],
                                      m["p"]))
    answers = []

    def serve_briefly(self):
        self.start()
        answers.append(_post(self, [5, 17, 42, 7, 5, 17], 8))

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    before = _followers()
    base = ["serve", "--model", "llama-test", "--device", "cpu", "--greedy",
            "--tp", "2", "--http-port", "0", "--max-seq", "64"]
    for extra in (["--draft-model", "llama-test"],
                  ["--prompt-lookup", "--batch-slots", "2",
                   "--kv-block-tokens", "4"]):
        assert cli.main(base + extra) == 0
    out = capsys.readouterr().out
    assert out.count("MESH mesh tp=2 backend=gloo") == 2
    assert "SERVE_SPECULATIVE llama-test draft=llama-test" in out
    assert "SERVE_BATCHING llama-test slots=2" in out
    assert "prompt_lookup k=4" in out
    want = RefEngine(m["rcfg"], m["rp"], max_seq=64,
                     sampling=RefSamplingParams(greedy=True)).generate(
        np.asarray([[5, 17, 42, 7, 5, 17]]), 8).tokens.tolist()
    assert [a["tokens"] for a in answers] == [want] * 2
    gen = ["generate", "--model", "llama-test", "--device", "cpu",
           "--greedy", "--prompt-ids", "5,17,42,7,5,17", "--max-new-tokens",
           "8", "--max-seq", "64", "--tp", "2"]
    assert cli.main(gen + ["--prompt-lookup"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["tokens"] == want and got["speculative"]["rounds"] >= 1
    assert cli.main(["bench", "--model", "llama-test", "--device", "cpu",
                     "--greedy", "--batch", "1", "--prompt-len", "8",
                     "--max-new-tokens", "4", "--max-seq", "64", "--tp",
                     "2", "--draft-model", "llama-test"]) == 0
    bench = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert bench["speculative"]["rounds"] >= 1
    t_end = time.monotonic() + 30
    while _followers() - before and time.monotonic() < t_end:
        time.sleep(0.05)
    assert not _followers() - before
