"""The torch port's int8 / int4 weights against the JAX package's.

Seeded numpy weights go through both packages' quantizers: codes and
scales are bit-equal.  The plain ``dense`` (the CPU path of the port's
dequantizing kernel) agrees with the reference's ``dense``.  The
reference's quantized parameter tree crosses ``params_from_numpy``
unchanged, and ``-int8`` / ``-int4`` configs give the reference's logits
(2e-4, f32 configs) through ``stage_forward``, and its greedy tokens
exactly through ``InferenceEngine`` and ``ContinuousBatchingEngine``
(chunked and mixed).  Then the port's own rules: the layer-chunked init
quantizes the float init's weights, the kernel's instance and split
rules, and the catalog shapes the kernel takes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
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
from distributed_inference_demo_tpu_torch.models.base import slice_stage
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.decoder import (
    init_full_params, stage_forward)
from distributed_inference_demo_tpu_torch.models.registry import \
    MODEL_REGISTRY
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

TOL = dict(rtol=2e-4, atol=2e-4)
WAIT = 120


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


def _weights(shape, seed=0, dtype=np.float32):
    return (np.random.RandomState(seed).standard_normal(shape)
            * 0.05).astype(dtype)


@pytest.mark.parametrize("shape,stacked", [
    ((64, 48), False), ((3, 64, 48), True), ((3, 32, 16), False)])
def test_quantize_array_codes_and_scales_bit_equal(shape, stacked):
    w = _weights(shape, 1)
    w[..., 0, 3] = 0.0           # an all-small column keeps its 1e-8 floor
    ref = ref_quant.quantize_array(jnp.asarray(w), stacked=stacked)
    got = quant.quantize_array(torch.from_numpy(w), stacked=stacked)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32),
                                  np.asarray(ref.scale).view(np.int32))
    assert got.shape == tuple(ref.shape) and got.nbytes == ref.nbytes


@pytest.mark.parametrize("shape", [(64, 24), (2, 128, 16), (32, 8),
                                   (6, 8)])
def test_quantize_array4_codes_and_scales_bit_equal(shape):
    """K = 64 and 128 (groups of 64), K = 32 and 6 (< 64: one group)."""
    w = _weights(shape, 2)
    ref = ref_quant.quantize_array4(jnp.asarray(w))
    got = quant.quantize_array4(torch.from_numpy(w))
    assert got.group == ref.group == min(64, shape[-2])
    assert got.q.dtype == torch.uint8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32),
                                  np.asarray(ref.scale).view(np.int32))
    assert got.shape == tuple(ref.shape)
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            got.dequantize(dt).float().numpy(),
            np.asarray(ref.dequantize(rdt)).astype(np.float32))


def test_quantize_array4_refuses_odd_and_undivided_input_dims():
    for mod in (ref_quant, quant):
        with pytest.raises(ValueError, match="even input dim"):
            mod.quantize_array4(np.zeros((7, 4), np.float32) if mod is
                                ref_quant else torch.zeros(7, 4))
    with pytest.raises(ValueError, match="does not divide"):
        quant.quantize_array4(torch.zeros(96, 4), group=64)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_plain_dense_matches_reference_dense(bits, xdt):
    w = _weights((128, 48), 3)
    x = _weights((2, 5, 128), 4, np.float32) * 20
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    rq = (ref_quant.quantize_array(jnp.asarray(w)) if bits == 8
          else ref_quant.quantize_array4(jnp.asarray(w)))
    pq = (quant.quantize_array(torch.from_numpy(w)) if bits == 8
          else quant.quantize_array4(torch.from_numpy(w)))
    want = np.asarray(ref_quant.dense(jnp.asarray(x), rq, "bsh,hi->bsi"),
                      np.float32)
    tx = (torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
          if xdt == "bfloat16" else torch.from_numpy(x))
    got = quant.dense(tx, pq, "bsh,hi->bsi")
    assert got.dtype == tx.dtype
    # f32: summation order only; bf16: the output's own rounding
    tol = TOL if xdt == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the kernel wrapper's plain version is the same product, and a CPU
    # tensor never counts a launch
    before = qd.quant_dense.launches
    flat = qd.quant_dense(tx.reshape(-1, 128), pq)
    torch.testing.assert_close(flat.reshape(got.shape), got)
    assert qd.quant_dense.launches == before


def test_dense_float_weight_and_matmul_forms():
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(quant.dense(x, w, "bsh,hd->bsd"), x @ w)
    assert quant._is_matmul("bsh,hi->bsi") and quant._is_matmul(
        "bsd,dh->bsh")
    assert not quant._is_matmul("bsh,ehi->bsei")
    assert not quant._is_matmul("bsh,ih->bsi")


@pytest.mark.parametrize("model", ["llama-test-int8", "llama-test-int4"])
def test_bridge_carries_reference_quantized_tree(model):
    rcfg = ref_get_model_config(model)
    rp = ref_init_full_params(jax.random.PRNGKey(1), rcfg, quantize=True)
    params = params_from_numpy(numpy_tree(rp), get_model_config(model),
                               "cpu")
    for k in quant._QUANTIZABLE:
        r, p = rp.layers[k], params.layers[k]
        assert type(p).__name__ == type(r).__name__, k
        np.testing.assert_array_equal(p.q.numpy(), np.asarray(r.q))
        np.testing.assert_array_equal(p.scale.numpy(), np.asarray(r.scale))
        if isinstance(p, quant.QuantizedArray4):
            assert p.group == r.group
    # per-layer views and stage slices index every leaf alike
    lp = params.layer(2)["wq"]
    np.testing.assert_array_equal(lp.q.numpy(),
                                  np.asarray(rp.layers["wq"].q[2]))
    sl = slice_stage(params, get_model_config(model),
                     StageSpec(1, 2, 2, 4)).layers["w_down"]
    assert sl.q.shape[0] == 2 and sl.scale.shape[0] == 2
    assert params.nbytes() < init_full_params(
        torch.Generator().manual_seed(0), get_model_config(model),
        "cpu").nbytes()


@pytest.mark.parametrize("model", ["llama-test-int8", "llama-test-int4",
                                   "bloom-test-int8", "gemma-test-int8"])
def test_quantized_stage_forward_matches_reference(model):
    rcfg = ref_get_model_config(model)
    rp = ref_init_full_params(jax.random.PRNGKey(3), rcfg, quantize=True)
    cfg = get_model_config(model)
    params = params_from_numpy(numpy_tree(rp), cfg, "cpu")
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
    l1, cache = stage_forward(params, cfg, spec, torch.from_numpy(ids),
                              cache, torch.arange(s).expand(b, s))
    l2, _ = stage_forward(params, cfg, spec, torch.from_numpy(nxt), cache,
                          torch.full((b, 1), s), last_logits_only=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(rl1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl2), **TOL)


@pytest.fixture(scope="module")
def int8_weights():
    rcfg = ref_get_model_config("llama-test-int8")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg, quantize=True)
    cfg = get_model_config("llama-test-int8")
    return rcfg, rp, cfg, params_from_numpy(numpy_tree(rp), cfg, "cpu")


def test_inference_engine_int8_greedy_equals_reference(int8_weights):
    rcfg, rp, cfg, params = int8_weights
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                           (2, 21)).astype(np.int32)
    for chunk in (None, 8):
        ref = RefEngine(rcfg, rp, max_seq=48,
                        sampling=RefSamplingParams(greedy=True),
                        attn_backend="jnp", prefill_chunk=chunk)
        port = InferenceEngine(cfg, params, max_seq=48,
                               sampling=SamplingParams(greedy=True),
                               device="cpu", prefill_chunk=chunk)
        r = ref.generate(ids, 10, logprobs=True)
        p = port.generate(ids, 10, logprobs=True)
        np.testing.assert_array_equal(p.tokens, r.tokens)
        np.testing.assert_allclose(p.logprobs, r.logprobs, **TOL)
        streamed = np.stack(list(port.generate_stream(ids, 10)), 1)
        np.testing.assert_array_equal(streamed, r.tokens)


ASKS = [(list(range(3, 30)), 8), ([9, 8, 7, 6], 6),
        (list(range(50, 85)), 5)]
BATCH_KW = {
    "chunked": dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
                    kv_block_tokens=8, prefill_chunk=8),
    "mixed": dict(max_seq=96, max_batch=4, prompt_buckets=(16, 48),
                  kv_block_tokens=8, prefill_chunk=8, decode_block=4,
                  mixed_token_budget=24),
}


@pytest.mark.parametrize("mode", list(BATCH_KW))
def test_batching_engine_int8_greedy_equals_reference(int8_weights, mode):
    rcfg, rp, cfg, params = int8_weights
    kw = BATCH_KW[mode]
    with RefBatching(rcfg, rp, sampling=RefSamplingParams(greedy=True),
                     **kw) as ref:
        want = [r.wait(timeout=WAIT).tolist()
                for r in [ref.submit(p, n) for p, n in ASKS]]
    with ContinuousBatchingEngine(cfg, params,
                                  sampling=SamplingParams(greedy=True),
                                  device="cpu", **kw) as port:
        got = [r.wait(timeout=WAIT).tolist()
               for r in [port.submit(p, n) for p, n in ASKS]]
    assert got == want


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_layer_chunked_init_quantizes_the_float_init(mode):
    """``quantize=True`` draws what the float init draws, one layer at a
    time: its codes are the float weights' codes, and the tree has the
    reference's structure (names, classes, shapes, dtypes)."""
    name = f"llama-test-{mode}"
    cfg = get_model_config(name)
    qp = init_full_params(torch.Generator().manual_seed(4), cfg, "cpu",
                          quantize=True)
    fp = init_full_params(torch.Generator().manual_seed(4), cfg, "cpu")
    want = quant.maybe_quantize(fp, cfg)
    rshape = jax.eval_shape(
        lambda k: ref_init_full_params(k, ref_get_model_config(name),
                                       quantize=True),
        jax.random.PRNGKey(0))
    for k, v in want.layers.items():
        got = qp.layers[k]
        ref = rshape.layers[k]
        if isinstance(v, quant.AnyQuantized):
            assert type(got) is type(v)
            assert torch.equal(got.q, v.q) and torch.equal(got.scale,
                                                           v.scale)
            assert tuple(got.q.shape) == tuple(ref.q.shape)
            assert tuple(got.scale.shape) == tuple(ref.scale.shape)
            assert str(got.q.dtype).split(".")[-1] == str(ref.q.dtype)
        else:
            assert torch.equal(got, v)
    assert torch.equal(qp.embed["tokens"], fp.embed["tokens"])
    assert torch.equal(qp.lm_head["w"], fp.lm_head["w"])


def test_kernel_instance_and_split_rules():
    """bf16 products of up to 16 rows take the decode kernel, larger ones
    the prefill kernel; f32 ones split at the same M, the f32 decode
    kernel and the f32 tile kernel; the decode kernels' split depends on
    no M; every split holds at least one step; partials never outweigh
    the weight."""
    assert qd.route(1, torch.bfloat16) == "decode"
    assert qd.route(8, torch.bfloat16) == "decode"
    assert qd.route(16, torch.bfloat16) == "decode"
    assert qd.route(17, torch.bfloat16) == "prefill"
    assert qd.route(1500, torch.bfloat16) == "prefill"
    assert qd.route(1, torch.float32) == "f32_decode"
    assert qd.route(16, torch.float32) == "f32_decode"
    assert qd.route(17, torch.float32) == qd.route(256, torch.float32) \
        == "f32_tile"
    shapes = ((2048, 256), (2048, 2048), (2048, 5632), (5632, 2048),
              (4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096),
              (64, 16))
    for k, n in shapes:
        for bits in (8, 4):
            for sms in (132, 114, 1):
                for kernel in qd.DECODE_KERNELS:
                    dec = {qd.splits_for(kernel, m, k, n, bits, sms)
                           for m in range(1, qd.DECODE_MAX_ROWS + 1)}
                    assert dec == {qd.decode_splits(k, n, bits, sms)}
            for m in (1, 8, 16, 17, 64, 256, 1500):
                for kernel in ("decode", "prefill", "f32_decode",
                               "f32_tile"):
                    decode = kernel in qd.DECODE_KERNELS
                    if decode and m > qd.DECODE_MAX_ROWS:
                        continue
                    s = qd.splits_for(kernel, m, k, n, bits, 132)
                    steps = k // (qd.DECODE_STEP_K if decode
                                  else qd.BLOCK_K)
                    per = -(-steps // s)
                    assert 1 <= s <= steps and -(-steps // per) == s
                    if s > 1:   # partials never outweigh the weight
                        rows = qd.DECODE_MAX_ROWS if decode else m
                        assert s * rows * n * 4 <= k * n * bits // 8
                    if decode:   # a step for every warp
                        assert s == 1 or steps // s >= qd.DECODE_WARPS
    # TinyLlama's wk at decode: 2 tiles, split to fill the card, capped
    # by a step for every warp of a split
    assert qd.decode_splits(2048, 256, 8, 132) == 16
    assert qd.decode_splits(2048, 256, 4, 132) == 16
    # TinyLlama's w_up at decode: 44 tiles, two blocks an SM
    assert qd.decode_splits(2048, 5632, 8, 132) == 6
    # prefill: a long chunk's tiles fill the card alone; llama-3-8b's
    # w_down at a 64-token prefill (32 tiles) splits four ways
    assert qd.prefill_splits(1500, 2048, 5632, 8, 132) == 1
    assert qd.prefill_splits(256, 2048, 5632, 8, 132) == 1
    assert qd.prefill_splits(64, 14336, 4096, 8, 132) == 4


def test_catalog_weight_shapes_fit_the_kernel():
    """Every dense catalog model's seven matmul weights have K % 64 == 0
    (the kernel's K step, and int4's group of 64 divides it) and
    N % 16 == 0, so no quantized serve is refused on the card."""
    for name, cfg in MODEL_REGISTRY.items():
        if cfg.num_experts or name.endswith("-test"):
            continue
        H, I = cfg.hidden_size, cfg.intermediate_size
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        for k, n in ((H, q), (H, kv), (q, H), (H, I), (I, H)):
            assert k % 64 == 0 and n % 16 == 0, (name, k, n)
            assert quant.int4_group_for(k) == 64
