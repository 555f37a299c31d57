"""The torch port's Mixtral (top-k MoE MLP) against the JAX package's.

``mixtral-test`` in f32 (4 experts, top 2): the routing matrix equals
the reference's ``lax.top_k`` routing, ties included (equal logits pick
the lower expert); ``_moe_mlp`` agrees to 2e-4 on the same numpy
weights; the init takes the reference's leaves.  The
``-int8`` / ``-int4`` expert stacks: codes and scales bit-equal to the
reference's (int8's scale shared by every expert, ``[L, 1, 1, I]``), the
layer-chunked init bit-equal to the reference's on the same draws, the
per-expert ``dense`` equal to an einsum over the dequantized stack.  A
random HF ``MixtralForCausalLM`` maps through the port's mapper to the
reference mapper's leaves and to HF's logits, also from safetensors
shards through ``load_or_init``.  The engines are in
``test_torch_moe_engines.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models import decoder as ref_decoder
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu_torch.models import (
    KVCache, StageSpec, get_model_config)
from distributed_inference_demo_tpu_torch.models import decoder
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.registry import \
    MODEL_REGISTRY
from distributed_inference_demo_tpu_torch.ops import quant

TOL = dict(rtol=2e-4, atol=2e-4)


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


def _weights(shape, seed, scale=0.1):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the routing and the MoE MLP


def _ref_route(logits, k):
    """The reference's routing matrix (``_moe_mlp``'s lines, in jax)."""
    logits = jnp.asarray(logits)
    topv, topi = jax.lax.top_k(logits, k)
    weights = jax.nn.softmax(topv, axis=-1)
    b, s = logits.shape[:2]
    return np.asarray(jnp.zeros_like(logits).at[
        jnp.arange(b)[:, None, None], jnp.arange(s)[None, :, None],
        topi].set(weights))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("levels", [None, 3, 1])
def test_route_equals_top_k_routing_ties_included(k, levels):
    """Random logits, logits of 3 levels (ties in most rows, often across
    the top-k boundary) and all-equal logits: the same experts and
    weights as ``lax.top_k``'s routing."""
    rng = np.random.RandomState(k)
    logits = (rng.standard_normal((3, 7, 8)) if levels is None
              else rng.randint(0, levels, (3, 7, 8))).astype(np.float32)
    got = decoder.moe_route(torch.from_numpy(logits), k).numpy()
    want = _ref_route(logits, k)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got != 0).sum(-1) == k).all()
    if levels == 1:     # every logit ties: experts 0..k-1, weights 1/k
        np.testing.assert_allclose(got[..., :k], 1.0 / k, rtol=1e-6)
        assert not got[..., k:].any()


def _moe_weights(cfg, seed):
    H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    return {"router": _weights((H, E), seed, 0.3),
            "w_gate": _weights((E, H, I), seed + 1),
            "w_up": _weights((E, H, I), seed + 2),
            "w_down": _weights((E, I, H), seed + 3)}


def _expert(lp, e, x):
    gate = x @ lp["w_gate"][e]
    h = gate / (1.0 + np.exp(-gate)) * (x @ lp["w_up"][e])
    return h @ lp["w_down"][e]


@pytest.mark.parametrize("router", ["random", "zero"])
def test_moe_mlp_matches_reference(router):
    """The same numpy x and weights through both ``_moe_mlp``s; a zero
    router ties every logit: experts 0..k-1 at 1/k each, as the
    reference routes it."""
    cfg = get_model_config("mixtral-test")
    rcfg = ref_get_model_config("mixtral-test")
    lp = _moe_weights(cfg, 5)
    if router == "zero":
        lp["router"][:] = 0.0
    x = _weights((2, 5, cfg.hidden_size), 9, 1.0)
    want = np.asarray(ref_decoder._moe_mlp(
        rcfg, {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x)))
    got = decoder._moe_mlp(cfg, {k: torch.from_numpy(v)
                                 for k, v in lp.items()},
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if router == "zero":
        k = cfg.experts_per_token
        manual = sum(_expert(lp, e, x) for e in range(k)) / k
        np.testing.assert_allclose(got, manual, **TOL)


def test_moe_mlp_bf16_follows_the_reference_casts():
    """bf16 activations and weights: the router in bf16 then f32, SiLU
    and the gate product in f32, the combine in bf16, as the
    reference's; outputs within bf16's rounding of the reference's."""
    cfg = get_model_config("mixtral-test").replace(dtype_name="bfloat16")
    rcfg = ref_get_model_config("mixtral-test").replace(
        dtype_name="bfloat16")
    lp = _moe_weights(cfg, 6)
    x = _weights((2, 5, cfg.hidden_size), 10, 1.0)
    want = np.asarray(ref_decoder._moe_mlp(
        rcfg, {k: jnp.asarray(v, jnp.bfloat16) for k, v in lp.items()},
        jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = decoder._moe_mlp(
        cfg, {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in lp.items()},
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_init_takes_the_reference_leaves():
    """Names, shapes and dtypes of every layer leaf, float and quantized,
    equal the reference's init."""
    for name in ("mixtral-test", "mixtral-test-int8", "mixtral-test-int4"):
        cfg = get_model_config(name)
        got = decoder.init_full_params(torch.Generator().manual_seed(0),
                                       cfg, "cpu", quantize=True)
        want = jax.eval_shape(
            lambda k: ref_init_full_params(k, ref_get_model_config(name),
                                           quantize=True),
            jax.random.PRNGKey(0))
        assert sorted(got.layers) == sorted(want.layers)
        for k, w in want.layers.items():
            g = got.layers[k]
            if isinstance(w, ref_quant.AnyQuantized):
                assert type(g).__name__ == type(w).__name__, (name, k)
                for f in ("q", "scale"):
                    gf, wf = getattr(g, f), getattr(w, f)
                    assert tuple(gf.shape) == tuple(wf.shape), (name, k, f)
                    assert str(gf.dtype).split(".")[-1] == str(wf.dtype)
            else:
                assert tuple(g.shape) == tuple(w.shape), (name, k)
        assert "router" not in quant._QUANTIZABLE


# ---------------------------------------------------------------------------
# (d) int8 / int4 expert stacks


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_layer_params_bit_equal(mode):
    """[L, E, K, N] stacks: int8 reduces over E and K (one scale per layer
    and output channel, [L, 1, 1, N]); int4 keeps a group scale per
    expert ([L, E, K/g, 1, N]); the router stays float."""
    L, E, H, I = 2, 4, 64, 128
    layers = {"router": _weights((L, H, E), 1),
              "w_gate": _weights((L, E, H, I), 2),
              "w_up": _weights((L, E, H, I), 3),
              "w_down": _weights((L, E, I, H), 4)}
    layers["w_up"][1, 2, :, 5] *= 30.0     # one expert's column dominates
    ref = ref_quant.quantize_layer_params(
        {k: jnp.asarray(v) for k, v in layers.items()}, mode)
    got = quant.quantize_layer_params(
        {k: torch.from_numpy(v) for k, v in layers.items()}, mode)
    assert isinstance(got["router"], torch.Tensor)
    for k in ("w_gate", "w_up", "w_down"):
        r, g = ref[k], got[k]
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(r.q))
        np.testing.assert_array_equal(g.scale.numpy().view(np.int32),
                                      np.asarray(r.scale).view(np.int32))
        n = layers[k].shape[-1]
        want_scale = ((L, 1, 1, n) if mode == "int8"
                      else (L, E, layers[k].shape[-2] // 64, 1, n))
        assert tuple(g.scale.shape) == want_scale


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_layer_chunked_init_bit_equal_to_reference(mode, monkeypatch):
    """``_init_quantized`` over an [L, E, H, I] stack, fed the reference's
    own per-layer draws: codes bit-equal to the reference's
    ``_init_quantized`` through the bridge, with its [L, 1, 1, I] (int8)
    or [L, E, H/g, 1, I] (int4) scales; scales bit-equal to the
    reference's quantizer on the same draws, and within one ulp of its
    jitted init (which multiplies by 1/127 or 1/7, XLA's rewrite of the
    quantizer's division).  And the port's init with ``quantize`` equals
    the quantized float init of the same generator (its layer slices
    draw what the stack draws)."""
    shape, dt = (2, 4, 64, 128), jnp.float32
    key = jax.random.PRNGKey(7)
    rq = ref_decoder._init_quantized(key, shape, dt, mode=mode)
    scale = jnp.float32(shape[-2] ** -0.5)
    draws = [np.array(ref_decoder._dense_init_jit(
        k, scale, shape[1:], jnp.dtype(dt)))
        for k in jax.random.split(key, shape[0])]
    it = iter(draws)
    monkeypatch.setattr(decoder, "_dense_init",
                        lambda *a, **kw: torch.from_numpy(next(it)))
    got = decoder._init_quantized(None, shape, torch.float32, "cpu", mode)
    monkeypatch.undo()
    bridged = params_from_numpy({"layers": {"w": _leaf(rq)}},
                                get_model_config("mixtral-test"),
                                "cpu").layers["w"]
    assert type(got) is type(bridged) and got.bits == bridged.bits
    for a, b in ((got.q, bridged.q), (got.scale, bridged.scale)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(got.q, bridged.q)
    assert (got.scale.view(torch.int32).long()
            - bridged.scale.view(torch.int32).long()).abs().max() <= 1
    quantize = (ref_quant.quantize_array4 if mode == "int4" else
                lambda w: ref_quant.quantize_array(w, stacked=False))
    eager = [quantize(jnp.asarray(d)) for d in draws]
    np.testing.assert_array_equal(
        got.scale.numpy(), np.stack([np.asarray(e.scale) for e in eager]))
    np.testing.assert_array_equal(
        got.q.numpy(), np.stack([np.asarray(e.q) for e in eager]))
    cfg = get_model_config(f"mixtral-test-{mode}")
    qp = decoder.init_full_params(torch.Generator().manual_seed(4), cfg,
                                  "cpu", quantize=True)
    want = quant.maybe_quantize(decoder.init_full_params(
        torch.Generator().manual_seed(4), cfg, "cpu"), cfg)
    for k, v in want.layers.items():
        g = qp.layers[k]
        if isinstance(v, quant.AnyQuantized):
            assert torch.equal(g.q, v.q) and torch.equal(g.scale, v.scale)
        else:
            assert torch.equal(g, v)


@pytest.mark.parametrize("b,s", [(1, 1), (2, 5), (8, 1)])
@pytest.mark.parametrize("eq", quant.EXPERT_EQS)
def test_float_expert_dense_equals_the_einsum(b, s, eq):
    """A float expert stack's product (one bmm over the weight as
    stored) equals the reference's einsum on the same numpy inputs."""
    E, H, I = 4, 64, 128
    k, n = (H, I) if eq == quant.EXPERT_EQS[0] else (I, H)
    w = _weights((E, k, n), 13)
    x = _weights((b, s, H) if eq == quant.EXPERT_EQS[0] else (b, E, s, I),
                 14, 1.0)
    got = quant.dense(torch.from_numpy(x), torch.from_numpy(w), eq)
    want = np.asarray(ref_quant.dense(jnp.asarray(x), jnp.asarray(w), eq))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("eq", quant.EXPERT_EQS)
def test_expert_dense_equals_einsum_over_the_dequantized_stack(mode, eq):
    """One layer's stack: each expert's 2-D view (int8 taking the shared
    scale row) through the product, stacked, equals the einsum over the
    whole stack dequantized; counted, one product per expert."""
    E, H, I = 4, 64, 128
    k, n = (H, I) if eq == quant.EXPERT_EQS[0] else (I, H)
    w = torch.from_numpy(_weights((1, E, k, n), 11))
    qw = (quant.quantize_array(w, stacked=True) if mode == "int8"
          else quant.quantize_array4(w))[0]
    x = torch.from_numpy(_weights((2, 3, H) if eq == quant.EXPERT_EQS[0]
                                  else (2, E, 3, I), 12, 1.0))
    calls = []
    real = quant.quant_dense

    def counted(xx, ww):
        calls.append(tuple(ww.scale.shape))
        return real(xx, ww)

    quant.quant_dense = counted
    try:
        got = quant.dense(x, qw, eq)
    finally:
        quant.quant_dense = real
    want = torch.einsum(eq, x, qw.dequantize(torch.float32))
    torch.testing.assert_close(got, want, **TOL)
    assert len(calls) == E
    assert set(calls) == {(1, n) if mode == "int8"
                          else (k // qw.group, 1, n)}
    with pytest.raises(ValueError, match="expert stack"):
        quant.dense(x, qw, "bsh,ehi->bsei")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_step_makes_4_plus_3e_products_a_layer(mode):
    """A quantized forward makes (4 + 3 E) x L products: the four
    attention weights and one per expert of w_gate, w_up and w_down (on
    the card, one kernel launch each)."""
    cfg = get_model_config(f"mixtral-test-{mode}")
    params = decoder.init_full_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu", quantize=True)
    n = []
    real = quant.quant_dense
    quant.quant_dense = lambda x, w: (n.append(1), real(x, w))[1]
    try:
        cache = KVCache.create(cfg, cfg.num_layers, 1, 16)
        decoder.stage_forward(params, cfg, StageSpec(0, 1, 0,
                                                     cfg.num_layers),
                              torch.tensor([[3]]), cache,
                              torch.tensor([[0]]))
    finally:
        quant.quant_dense = real
    assert len(n) == (4 + 3 * cfg.num_experts) * cfg.num_layers


def test_catalog_expert_shapes_fit_the_kernel():
    """Every MoE catalog model's attention weights and expert matrices
    have K % 64 == 0 and N % 16 == 0, so its quantized serve launches the
    dense kernel on the card."""
    for name, cfg in MODEL_REGISTRY.items():
        if not cfg.num_experts or name.endswith("-test"):
            continue
        H, I = cfg.hidden_size, cfg.intermediate_size
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        for k, n in ((H, q), (H, kv), (q, H), (H, I), (I, H)):
            assert k % 64 == 0 and n % 16 == 0, (name, k, n)


# ---------------------------------------------------------------------------
# (e) the HF mapper

transformers = pytest.importorskip("transformers")
PROMPT = np.array([[5, 17, 42, 7, 99, 3, 12, 56, 200, 131]])


def _hf_mixtral():
    torch.manual_seed(0)
    cfg = get_model_config("mixtral-test")
    model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size,
        num_local_experts=cfg.num_experts,
        num_experts_per_tok=cfg.experts_per_token,
        max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=cfg.tie_embeddings))
    return cfg, model.float().eval()


def _assert_leaves_equal(params, rp):
    for part in ("layers", "embed", "final_norm", "lm_head"):
        got, want = getattr(params, part), getattr(rp, part)
        assert sorted(got) == sorted(want), part
        for k, w in want.items():
            g = got[k]
            if isinstance(w, ref_quant.AnyQuantized):
                np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
                np.testing.assert_array_equal(g.scale.numpy(),
                                              np.asarray(w.scale))
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{part}/{k}")


def test_mapper_equals_reference_and_matches_hf():
    from distributed_inference_demo_tpu.models import loader as ref_loader
    from distributed_inference_demo_tpu_torch.models import loader
    cfg, model = _hf_mixtral()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    rp = ref_loader.params_from_state_dict(sd, ref_get_model_config(
        "mixtral-test"))
    params = loader.params_from_state_dict(sd, cfg, "cpu")
    _assert_leaves_equal(params, rp)
    assert params.layers["w_gate"].shape == (
        cfg.num_layers, cfg.num_experts, cfg.hidden_size,
        cfg.intermediate_size)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(PROMPT).long()
                     ).logits.float().numpy()
    got, _ = decoder.stage_forward(
        params, cfg, StageSpec(0, 1, 0, cfg.num_layers),
        torch.from_numpy(PROMPT), KVCache.create(cfg, cfg.num_layers, 1, 16),
        torch.arange(PROMPT.shape[1])[None])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["mixtral-test", "mixtral-test-int8"])
def test_load_or_init_reads_safetensors_shards(name, tmp_path):
    """The HF model saved as two safetensors shards: ``load_or_init``
    gives the reference loader's tree (quantized for -int8)."""
    from distributed_inference_demo_tpu.models import loader as ref_loader
    from distributed_inference_demo_tpu_torch.models import loader
    cfg, model = _hf_mixtral()
    cfg = get_model_config(name)
    model.save_pretrained(tmp_path, safe_serialization=True,
                          max_shard_size="400KB")
    shards = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    assert len(shards) >= 2, shards
    rp = ref_loader.load_or_init(name, ref_get_model_config(name),
                                 checkpoint_dir=str(tmp_path))
    params = loader.load_or_init(name, cfg, str(tmp_path), device="cpu")
    assert isinstance(params.layers["w_up"], quant.AnyQuantized) == (
        cfg.quantization != "none")
    _assert_leaves_equal(params, rp)
