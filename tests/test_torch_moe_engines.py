"""The torch port's Mixtral in both engines against the JAX package's.

``mixtral-test`` (f32; 4 experts, top 2) and its ``-int8`` / ``-int4``
configs, the reference's weights carried across by ``models/bridge.py``:
``stage_forward`` logits agree to 2e-4; ``InferenceEngine`` (whole and
chunked prefill) gives the reference's greedy tokens and
``steps_computed`` exactly, logprobs and prefill logits within 2e-4;
``ContinuousBatchingEngine`` (chunked and mixed, over full-width, int8
and int4 pages) gives the reference batching engine's greedy tokens
exactly.  The MoE MLP itself is in ``test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import (
    KVCache as RefKVCache, StageSpec as RefStageSpec,
    get_model_config as ref_get_model_config)
from distributed_inference_demo_tpu.models.decoder import (
    init_full_params as ref_init_full_params,
    stage_forward as ref_stage_forward)
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import (
    KVCache, StageSpec, get_model_config)
from distributed_inference_demo_tpu_torch.models import decoder
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

TOL = dict(rtol=2e-4, atol=2e-4)
GREEDY = SamplingParams(greedy=True)
WAIT = 120
NEW = 8
MAX_SEQ = 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _leaf(v):
    """A reference leaf as the bridge's numpy form."""
    if isinstance(v, ref_quant.QuantizedArray4):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                "group": v.group}
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


def numpy_tree(rp):
    return {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}


@pytest.fixture(scope="module", params=["mixtral-test", "mixtral-test-int8",
                                        "mixtral-test-int4"])
def models(request):
    """(ref cfg, ref params, port cfg, port params) of one config, the
    reference's init (quantized during init for -int8 / -int4)."""
    name = request.param
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg,
                              quantize=rcfg.quantization != "none")
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(numpy_tree(rp), cfg, "cpu")


# ---------------------------------------------------------------------------
# stage_forward and InferenceEngine


def test_stage_forward_matches_reference(models):
    rcfg, rp, cfg, params = models
    b, s, max_seq = 2, 11, 24
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    nxt = rng.randint(0, cfg.vocab_size, (b, 1))
    rspec = RefStageSpec(0, 1, 0, rcfg.num_layers)
    rcache = RefKVCache.create(rcfg, rcfg.num_layers, b, max_seq)
    rl1, rcache = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(ids),
                                    rcache,
                                    jnp.broadcast_to(jnp.arange(s), (b, s)))
    rl2, _ = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(nxt), rcache,
                               jnp.full((b, 1), s), last_logits_only=True)
    spec = StageSpec(0, 1, 0, cfg.num_layers)
    cache = KVCache.create(cfg, cfg.num_layers, b, max_seq)
    l1, cache = decoder.stage_forward(params, cfg, spec,
                                      torch.from_numpy(ids), cache,
                                      torch.arange(s).expand(b, s))
    l2, _ = decoder.stage_forward(params, cfg, spec, torch.from_numpy(nxt),
                                  cache, torch.full((b, 1), s),
                                  last_logits_only=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(rl1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl2), **TOL)


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_inference_engine_matches_reference(models, prefill_chunk):
    """Greedy tokens and ``steps_computed`` exact, logprobs and the
    prefill logits within 2e-4, for a whole and a chunked prefill."""
    rcfg, rp, cfg, params = models
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                           (2, 37)).astype(np.int32)
    ref = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="jnp", prefill_chunk=prefill_chunk)
    port = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=GREEDY,
                           device="cpu", prefill_chunk=prefill_chunk)
    r = ref.generate(ids, NEW, logprobs=True)
    p = port.generate(ids, NEW, logprobs=True)
    np.testing.assert_array_equal(p.tokens, r.tokens)
    assert p.steps_computed == r.steps_computed == NEW
    np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
    rl, _ = ref._run_prefill(jnp.asarray(ids), ref.new_cache(2))
    np.testing.assert_allclose(port.prefill_logits(ids), np.asarray(rl),
                               **TOL)


# ---------------------------------------------------------------------------
# ContinuousBatchingEngine, chunked and mixed, three page widths

ASKS = [(list(range(3, 30)), 8), ([9, 8, 7, 6], 6),
        (list(range(50, 85)), 5)]
BATCH_KW = {
    "chunked": dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
                    kv_block_tokens=8, prefill_chunk=8),
    "mixed": dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
                  kv_block_tokens=8, prefill_chunk=8, decode_block=4,
                  mixed_token_budget=24),
}


@pytest.fixture(scope="module")
def float_models():
    rcfg = ref_get_model_config("mixtral-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_model_config("mixtral-test")
    return rcfg, rp, cfg, params_from_numpy(numpy_tree(rp), cfg, "cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("mode", list(BATCH_KW))
def test_batching_engine_matches_reference(float_models, mode, kv_dtype):
    rcfg, rp, cfg, params = float_models
    kw = BATCH_KW[mode]
    with RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                     kv_dtype=kv_dtype, **kw) as ref:
        want = [r.wait(timeout=WAIT).tolist()
                for r in [ref.submit(p, n) for p, n in ASKS]]
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  kv_dtype=kv_dtype, device="cpu",
                                  **kw) as port:
        got = [r.wait(timeout=WAIT).tolist()
               for r in [port.submit(p, n) for p, n in ASKS]]
        if mode == "mixed":
            assert port.stats()["mixed"]["dispatches"] > 0
    assert got == want


# ---------------------------------------------------------------------------
# serve --model mixtral-test[-int8], plain and --batch-slots


@pytest.mark.parametrize("model", ["mixtral-test", "mixtral-test-int8"])
def test_serve_plain_and_batching_give_the_same_greedy_tokens(
        model, monkeypatch, capsys):
    """The CLI's serve path on the CPU, random weights from the default
    seed: one greedy request over HTTP to the plain engine and one to
    ``--batch-slots 2``; the same tokens from both."""
    import json
    import urllib.request

    from distributed_inference_demo_tpu_torch import cli
    from distributed_inference_demo_tpu_torch.runtime.http_server import \
        InferenceHTTPServer

    prompt = [[5, 17, 42, 7, 99, 3, 12, 56, 200, 131]]
    got = []

    def serve_briefly(self):
        self.start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/generate",
            data=json.dumps({"prompt_ids": prompt,
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            got.append(json.loads(resp.read().decode())["tokens"][0])

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    base = ["serve", "--model", model, "--device", "cpu", "--greedy",
            "--http-port", "0", "--max-seq", "64"]
    assert cli.main(base) == 0
    assert cli.main(base + ["--batch-slots", "2", "--kv-block-tokens",
                            "8"]) == 0
    out = capsys.readouterr().out
    assert f"SERVE_ENGINE {model}" in out
    assert f"SERVE_BATCHING {model} slots=2" in out
    assert len(got) == 2 and len(got[0]) == 6 and got[0] == got[1]
