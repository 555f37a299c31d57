"""``serve --vision``: the port's multimodal HTTP surface against the JAX
package's.

The reference's ``tests/test_vision_serve.py`` cases, each answer of the
port's ``InferenceHTTPServer`` over ``MultimodalBackend`` compared with
the reference server's over its own backend, on the same weights
(``llama-test`` seed 0 and the reference's small tower, seed 1, carried
across): image and text tokens, the 400 and 501 bodies, the text-only
surface (stream, logprobs, classify) and ``/stats``.  Then the CLI:
the pairing refusals equal the reference CLI's texts, and ``serve
--vision`` on the CPU (seeded and from a CLIP checkpoint) answers
``POST /generate`` with an image.
"""

import http.client
import json

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu import cli as ref_cli
from distributed_inference_demo_tpu.models.vision import \
    VisionConfig as RefVisionConfig
from distributed_inference_demo_tpu.models.vision import \
    init_vision_params as ref_init_vision_params
from distributed_inference_demo_tpu.runtime import InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu.runtime.multimodal import \
    MultimodalBackend as RefBackend
from distributed_inference_demo_tpu.runtime.multimodal import \
    MultimodalEngine as RefMMEngine
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models.bridge import \
    vision_params_from_numpy
from distributed_inference_demo_tpu_torch.models.loader import \
    load_vision_params
from distributed_inference_demo_tpu_torch.models.vision import (
    VisionConfig, init_vision_params)
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.runtime.multimodal import (
    MultimodalBackend, MultimodalEngine)
from test_torch_ring import GREEDY, REF_GREEDY, _few_torch_threads, weights
from test_torch_vision import _clip_checkpoint

__all__ = ["_few_torch_threads"]
VCFG = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64)
PROMPT = [[5, 17, 42, 7]]
MAX_SEQ = 64


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


@pytest.fixture(scope="module")
def servers():
    """{"port": ..., "ref": ...} x {"mm", "plain"} servers, started."""
    rcfg, rp, cfg, full, _ = weights()
    rv = RefVisionConfig(**VCFG)
    rvp = ref_init_vision_params(jax.random.PRNGKey(1), rv, cfg.hidden_size)
    pv = VisionConfig(**VCFG)
    pvp = vision_params_from_numpy(jax.tree.map(np.asarray, rvp), "cpu")
    mm = MultimodalEngine(cfg, full, pv, pvp, max_seq=MAX_SEQ,
                          sampling=GREEDY, device="cpu")
    ref_mm = RefMMEngine(rcfg, rp, rv, rvp, max_seq=MAX_SEQ,
                         sampling=REF_GREEDY)
    out = {
        "port": {
            "mm": InferenceHTTPServer(MultimodalBackend(mm), port=0,
                                      model_name="llama-test"),
            "plain": InferenceHTTPServer(
                InferenceEngine(cfg, full, max_seq=MAX_SEQ, sampling=GREEDY,
                                device="cpu"),
                port=0, model_name="llama-test")},
        "ref": {
            "mm": RefServer(RefBackend(ref_mm), port=0,
                            model_name="llama-test"),
            "plain": RefServer(RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                                         sampling=REF_GREEDY),
                               port=0, model_name="llama-test")}}
    for side in out.values():
        for s in side.values():
            s.start()
    out["mm_engine"] = mm
    yield out
    for side in ("port", "ref"):
        for s in out[side].values():
            s.shutdown()


def _both(servers, body, kind="mm", path="/generate", method="POST"):
    """(port answer, reference answer): status and decoded JSON."""
    out = []
    for side in ("port", "ref"):
        code, data = _req(servers[side][kind].port, method, path, body)
        out.append((code, json.loads(data)))
    return out


def test_image_request_matches_reference_and_engine(servers):
    img = np.full((32, 32, 3), 0.25, np.float32)
    mine, theirs = _both(servers, {"prompt_ids": PROMPT,
                                   "image": img.tolist(),
                                   "max_new_tokens": 5})
    assert mine == theirs and mine[0] == 200
    want = servers["mm_engine"].generate(img[None], np.asarray(PROMPT), 5)
    assert mine[1]["tokens"] == want.tokens.tolist()


def test_text_only_matches_reference_and_plain_engine(servers):
    mine, theirs = _both(servers, {"prompt_ids": PROMPT,
                                   "max_new_tokens": 5})
    assert mine == theirs and mine[0] == 200
    plain = servers["mm_engine"].engine.generate(np.asarray(PROMPT), 5)
    assert mine[1]["tokens"] == plain.tokens.tolist()


@pytest.mark.parametrize("image,expect", [
    (np.zeros((16, 16, 3), np.float32).tolist(), "32"),     # wrong size
    (np.zeros((2, 32, 32, 3), np.float32).tolist(), "batch"),  # 2 for 1
    ([[1.0, 2.0]], "shape"),                                  # wrong rank
])
def test_bad_image_shapes_are_the_reference_400(servers, image, expect):
    mine, theirs = _both(servers, {"prompt_ids": PROMPT, "image": image,
                                   "max_new_tokens": 4})
    assert mine == theirs and mine[0] == 400
    assert expect in mine[1]["error"]


@pytest.mark.parametrize("extra,code", [
    ({"stream": True}, 501),
    ({"stop": "x"}, 501),
    ({"logprobs": True}, 400),
    ({"resume": {"delivered_tokens": [3]}}, 400),
])
def test_image_refusals_equal_reference(servers, extra, code):
    img = np.zeros((32, 32, 3), np.float32).tolist()
    body = {"prompt_ids": [[1, 2]], "image": img, "max_new_tokens": 4,
            **extra}
    mine, theirs = _both(servers, body)
    assert mine == theirs and mine[0] == code


def test_image_against_text_backend_is_the_reference_501(servers):
    img = np.zeros((32, 32, 3), np.float32).tolist()
    for extra in ({}, {"stream": True}):
        mine, theirs = _both(servers, {"prompt_ids": [[1, 2]], "image": img,
                                       "max_new_tokens": 4, **extra},
                             kind="plain")
        assert mine == theirs and mine[0] == 501
        assert "image" in mine[1]["error"]


def test_text_only_full_surface_delegates(servers):
    """Streaming, logprobs and /classify all work text-only against a
    --vision server, as on the reference's."""
    answers = []
    for side in ("port", "ref"):
        conn = http.client.HTTPConnection("127.0.0.1",
                                          servers[side]["mm"].port,
                                          timeout=60)
        conn.request("POST", "/generate",
                     body=json.dumps({"prompt_ids": PROMPT,
                                      "max_new_tokens": 4, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        answers.append([json.loads(line)["tokens"][0]
                        for line in resp.read().decode().splitlines()
                        if line.strip()])
        conn.close()
    assert answers[0] == answers[1]
    plain = servers["mm_engine"].engine.generate(np.asarray(PROMPT), 4)
    assert answers[0] == plain.tokens[0].tolist()
    mine, theirs = _both(servers, {"prompt_ids": PROMPT, "max_new_tokens": 4,
                                   "logprobs": True})
    assert mine[0] == theirs[0] == 200
    assert mine[1]["tokens"] == theirs[1]["tokens"]
    np.testing.assert_allclose(mine[1]["logprobs"], theirs[1]["logprobs"],
                               rtol=2e-4, atol=2e-4)
    mine, theirs = _both(servers, {"prompt_ids": PROMPT,
                                   "label_token_ids": [5, 9]},
                         path="/classify")
    assert mine == theirs and mine[0] == 200


def test_vision_stats_equal_reference(servers):
    img = np.zeros((32, 32, 3), np.float32).tolist()
    for side in ("port", "ref"):
        port = servers[side]["mm"].port
        assert _req(port, "POST", "/stats/reset", {})[0] == 200
        for body in ({"prompt_ids": [[1, 2]], "max_new_tokens": 2},
                     {"prompt_ids": [[1, 2]], "max_new_tokens": 2,
                      "image": img}):
            assert _req(port, "POST", "/generate", body)[0] == 200
    mine, theirs = _both(servers, None, path="/stats", method="GET")
    assert mine == theirs and mine[0] == 200
    assert mine[1]["mode"] == "multimodal"
    assert mine[1]["requests_text"] == mine[1]["requests_image"] == 1
    assert mine[1]["patches_per_image"] == VisionConfig(**VCFG).num_patches


def test_vision_serve_mode_pairing_rules_equal_reference(capsys):
    base = ["serve", "--model", "llama-test", "--vision"]
    for extra in (["--batch-slots", "2"], ["--draft-model", "llama-test"],
                  ["--prompt-lookup"], ["--sp", "2"],
                  ["--chain", "w@127.0.0.1:1"], ["--tp", "2"],
                  ["--kv-cache-dtype", "float8_e4m3fn"],
                  ["--prefill-chunk", "8"], ["--stream-block", "4"],
                  ["--kv-cache-blocks", "8"], ["--kv-block-tokens", "8"],
                  ["--prefill-chunk", "8", "--tp", "2"]):
        assert cli.main(base + ["--device", "cpu"] + extra) == 1
        err = capsys.readouterr().err
        assert ref_cli.main(base + extra) == 1
        assert err == capsys.readouterr().err and err, extra
        assert "not yet ported" not in err


def _serve_vision(monkeypatch, capsys, flags, body):
    """``serve --vision`` through ``cli.main`` on the CPU, its server
    answering ``body`` once before it stops: (banner, status, answer)."""
    answers = []

    def serve_briefly(self):
        self.start()
        answers.append(_req(self.port, "POST", "/generate", body))

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever",
                        serve_briefly)
    assert cli.main(["serve", "--model", "llama-test", "--device", "cpu",
                     "--greedy", "--max-seq", str(MAX_SEQ), "--http-port",
                     "0", "--vision", *flags]) == 0
    banner = next(ln for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("SERVE_VISION"))
    code, data = answers[0]
    return banner, code, json.loads(data)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_cli_serve_vision_answers_an_image(monkeypatch, capsys, tmp_path,
                                           checkpoint):
    """``serve --vision --vision-preset clip-test``: the reference's
    banner, and the tokens of a ``MultimodalEngine`` built from the same
    seeds (``--weights-seed`` for decoder and tower) or from the same
    ``--vision-checkpoint``."""
    from distributed_inference_demo_tpu_torch.models.loader import \
        load_or_init
    vcfg = cli.vision_config("clip-test")
    img = np.random.RandomState(0).rand(28, 28, 3).astype(np.float32)
    flags = ["--vision-preset", "clip-test", "--weights-seed", "3"]
    cfg = weights()[2]
    if checkpoint:
        _clip_checkpoint(tmp_path)
        flags += ["--vision-checkpoint", str(tmp_path)]
        vparams = load_vision_params(str(tmp_path), vcfg, cfg.hidden_size,
                                     seed=3, device="cpu")
    else:
        vparams = init_vision_params(torch.Generator().manual_seed(3), vcfg,
                                     cfg.hidden_size, "cpu")
    banner, code, answer = _serve_vision(
        monkeypatch, capsys, flags,
        {"prompt_ids": PROMPT, "image": img.tolist(), "max_new_tokens": 6})
    assert banner == ("SERVE_VISION llama-test tower=clip-test image=28 "
                      "patches=4")
    assert code == 200
    params = load_or_init("llama-test", cfg, None, seed=3, device="cpu")
    mm = MultimodalEngine(cfg, params, vcfg, vparams, max_seq=MAX_SEQ,
                          sampling=GREEDY, device="cpu")
    want = mm.generate(img[None], np.asarray(PROMPT), 6).tokens.tolist()
    assert answer["tokens"] == want
