"""The torch port's ``InferenceEngine`` over a tp=2 mesh against the JAX
package's tp=2 engine on the conftest's virtual CPU mesh.

The port's ranks are processes (rank 0 here, one spawned follower, gloo);
one mesh serves the module.  ``llama-test`` in f32 on the reference's
weights (carried across by ``models/bridge.py``): greedy tokens equal,
prefill logits and logprobs within 2e-4, streaming equal to the loop,
on float weights, int8 weights and a float8 cache; the prefix pool under
tp against the port's own tp=1 engine; ``serve --tp 2 --device cpu``
answering ``POST /generate`` with the reference engine's tokens and
leaving no follower alive; ``generate --tp 2``; the refusals.  A
``cuda`` test holds the tp=2 engine's tokens on the card to tp=1's.
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
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.engine import \
    shard_engine_params as ref_shard_engine_params
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import fetch_tp
from distributed_inference_demo_tpu_torch.runtime.engine import (
    InferenceEngine, shard_engine_params)
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer

GREEDY = SamplingParams(greedy=True)
RGREEDY = RefSamplingParams(greedy=True)
PROMPT = np.asarray([[3, 14, 15, 92], [7, 6, 5, 4]])
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    with local_tp_mesh(2, device="cpu", timeout_s=120) as m:
        yield m


def _leaf(v):
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


def _weights(name):
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg, quantize=True)
    tree = {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def f32():
    return _weights("llama-test")


def _ref_tp_engine(rcfg, rp, devices, **kw):
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    return RefEngine(rcfg, ref_shard_engine_params(rp, rcfg, rmesh),
                     max_seq=64, sampling=RGREEDY, mesh=rmesh, **kw)


@pytest.mark.parametrize("which,kw", [
    ("f32", {}),
    ("int8", {}),
    ("f32", {"kv_cache_dtype": "float8_e4m3fn"}),
])
def test_tp_engine_equals_reference_tp_engine(which, kw, f32, mesh,
                                              devices):
    """Greedy tokens equal, logprobs within 2e-4, the stream equal to the
    loop (the reference's test_engine.py tp tests, held to the
    reference's own tp engine); prefill logits within 2e-4 of tp=1's."""
    rcfg, rp, cfg, params = (f32 if which == "f32"
                             else _weights("llama-test-int8"))
    ref = _ref_tp_engine(rcfg, rp, devices, **kw)
    eng = InferenceEngine(cfg, shard_engine_params(params, cfg, mesh),
                          max_seq=64, sampling=GREEDY, device="cpu",
                          mesh=mesh, **kw)
    want = ref.generate(PROMPT, 10, logprobs=True)
    got = eng.generate(PROMPT, 10, logprobs=True)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    streamed = np.stack(list(eng.generate_stream(PROMPT, 6)), 1)
    np.testing.assert_array_equal(streamed, want.tokens[:, :6])
    # the reference engine exposes no prefill logits: the port's tp=1
    # engine (held to the reference in test_torch_engine.py) stands in
    one = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY,
                          device="cpu", **kw)
    np.testing.assert_allclose(eng.prefill_logits(PROMPT),
                               one.prefill_logits(PROMPT), **TOL)
    assert eng.attn_backend == "plain" and eng.mesh is mesh


def test_follower_cache_plane_after_a_generate(f32, mesh):
    """After a run, every rank's plane of the decode state's cache is its
    kv-head slice of the tp=1 engine's cache (the same run): a follower
    sees every write rank 0 made, through the forward commands only."""
    rcfg, rp, cfg, params = f32
    one = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY,
                          device="cpu")
    eng = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY,
                          device="cpu", mesh=mesh)
    np.testing.assert_array_equal(eng.generate(PROMPT, 7).tokens,
                                  one.generate(PROMPT, 7).tokens)
    full, tp = one._states[2].cache, eng._states[2].cache
    n = full.keys.shape[2] // 2
    for which in ("keys", "values"):
        planes = fetch_tp(mesh, getattr(tp, which))
        for r, plane in enumerate(planes):
            np.testing.assert_allclose(
                plane.numpy(),
                getattr(full, which)[:, :, r * n:(r + 1) * n].numpy(),
                **TOL)


def test_prefix_pool_under_tp(f32, mesh):
    """The block prefix pool sharded by kv head: seeds and stores are
    commands every rank runs, so a prefix hit decodes what the tp=1
    engine decodes, at int8 pages too."""
    rcfg, rp, cfg, params = f32
    prompts = [[3, 14, 15, 92, 65, 35, 89], [3, 14, 15, 92, 65, 35, 8, 9]]
    for kv_dtype in ("bf16", "int8"):
        kw = dict(max_seq=64, sampling=GREEDY, device="cpu",
                  kv_cache_blocks=16, kv_block_tokens=2, kv_dtype=kv_dtype,
                  prefill_chunk=4)
        one = InferenceEngine(cfg, params, **kw)
        eng = InferenceEngine(cfg, params, mesh=mesh, **kw)
        for p in prompts:
            np.testing.assert_array_equal(
                eng.generate(np.asarray([p]), 6).tokens,
                one.generate(np.asarray([p]), 6).tokens)
        assert eng.kv_cache.stats["hits"] == one.kv_cache.stats["hits"] == 1
        pk = fetch_tp(mesh, eng.kv_cache.pool[0])
        assert type(pk[1]) is type(eng.kv_cache.pool[0])


def test_tp_engine_refusals(f32, mesh):
    rcfg, rp, cfg, params = f32
    with pytest.raises(ValueError, match="incompatible"):
        InferenceEngine(cfg, params, device="cpu", mesh=mesh,
                        attn_backend="xla")
    bad = get_model_config("gemma-test")               # nkv = 1
    with pytest.raises(ValueError, match="num_kv_heads=1 not divisible"):
        InferenceEngine(bad, params, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        InferenceEngine(cfg, params, device="cpu", mesh=mesh,
                        attn_backend="flash")


def _followers():
    return {p for p in multiprocessing.active_children()
            if p.name.startswith("mesh-follower")}


def test_cli_serve_tp2_answers_the_reference_tokens(f32, capsys,
                                                    monkeypatch):
    """``serve --tp 2 --device cpu``: the banner names the mesh, POST
    /generate answers the reference engine's greedy tokens, and no
    follower outlives the command."""
    rcfg, rp, cfg, params = f32
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, params))
    answers = []

    def serve_briefly(self):
        self.start()
        body = json.dumps({"prompt_ids": [[5, 17, 42, 7]],
                           "max_new_tokens": 8}).encode()
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers.append(json.loads(r.read()))

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    before = _followers()
    for extra in ([], ["--batch-slots", "2", "--kv-block-tokens", "4"]):
        assert cli.main(["serve", "--model", "llama-test", "--device",
                         "cpu", "--greedy", "--tp", "2", "--http-port",
                         "0", "--max-seq", "64", *extra]) == 0
    out = capsys.readouterr().out
    assert "MESH mesh tp=2 backend=gloo device=cpu graph=off (gloo)" in out
    assert "SERVE_BATCHING llama-test slots=2" in out and "tp=2" in out
    want = RefEngine(rcfg, rp, max_seq=64, sampling=RGREEDY).generate(
        np.asarray([[5, 17, 42, 7]]), 8).tokens.tolist()
    assert [a["tokens"] for a in answers] == [want, want]
    t_end = time.monotonic() + 30
    while _followers() - before and time.monotonic() < t_end:
        time.sleep(0.05)
    assert not _followers() - before


def test_cli_generate_tp2(f32, capsys, monkeypatch):
    rcfg, rp, cfg, params = f32
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, params))
    before = _followers()
    argv = ["generate", "--model", "llama-test", "--device", "cpu",
            "--greedy", "--prompt-ids", "5,17,42,7", "--max-new-tokens", "6",
            "--max-seq", "64"]
    assert cli.main(argv) == 0
    one = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert cli.main(argv + ["--tp", "2"]) == 0
    two = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert two["tokens"] == one["tokens"]
    assert not _followers() - before


def test_cli_tp_refusals_equal_reference(capsys):
    """The reference's texts for --tp with --chain and --vision, and for
    --tp under both proposers at once (tp under one proposer is
    served)."""
    from distributed_inference_demo_tpu import cli as ref_cli
    base = ["serve", "--model", "llama-test", "--device", "cpu"]
    cases = [
        (["--tp", "2", "--chain", "h:1"], ["--tp", "2", "--chain", "h:1"]),
        (["--tp", "2", "--vision"], ["--tp", "2", "--vision"]),
        (["--sp", "2", "--tp", "2"], ["--sp", "2", "--tp", "2"]),
        (["--tp", "2", "--prompt-lookup", "--draft-model", "llama-test"],
         ["--tp", "2", "--prompt-lookup", "--draft-model", "llama-test"])]
    for mine, theirs in cases:
        assert cli.main(base + mine) == 1
        err = capsys.readouterr().err
        assert ref_cli.main(["serve", "--model", "llama-test",
                             *theirs]) == 1
        assert err == capsys.readouterr().err and err
    assert cli.main(["--jax-process-id", "1", "serve", "--model",
                     "llama-test"]) == 2
    assert "require --jax-coordinator" in capsys.readouterr().err
