"""The torch port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain version; it must
equal the reference's Pallas kernel (interpret mode) and the reference's
``ops.attention.attention``, and it must never launch the CUDA kernel.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
from distributed_inference_demo_tpu.ops.attention import (
    alibi_slopes as ref_alibi_slopes, attention as ref_attention)
from distributed_inference_demo_tpu.ops.flash_attention import (
    flash_attention as ref_flash_attention,
    make_flash_attn_impl as ref_make_flash_attn_impl)
from distributed_inference_demo_tpu_torch.models import (
    KVCache, StageSpec, get_model_config)
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.decoder import stage_forward
from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny shapes gain nothing from many intra-op threads; cap them so
    parallel test workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(b, chunk, nh, nkv, hd, max_seq, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, chunk, nh, hd).astype(np.float32),
            rng.randn(b, nkv, max_seq, hd).astype(np.float32),
            rng.randn(b, nkv, max_seq, hd).astype(np.float32))


@pytest.mark.parametrize("b,chunk,nh,nkv,hd,max_seq,q_start,alibi", [
    (2, 16, 4, 4, 16, 64, 0, False),     # groups 1, prefill from empty
    (1, 37, 4, 2, 16, 64, 5, False),     # groups 2, odd chunk after a prefix
    (2, 16, 8, 2, 16, 64, 20, False),    # groups 4
    (1, 37, 4, 4, 16, 48, 3, True),      # ALiBi
    (1, 16, 4, 1, 16, 50, 10, False),    # max_seq not a multiple of 8
])
def test_flash_attention_cpu_matches_reference(b, chunk, nh, nkv, hd,
                                               max_seq, q_start, alibi):
    q, kc, vc = _inputs(b, chunk, nh, nkv, hd, max_seq)
    kv_len = q_start + chunk
    slopes = alibi_slopes(nh) if alibi else None
    ref_slopes = ref_alibi_slopes(nh) if alibi else None
    before = fa.flash_attention.launches
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), q_start, kv_len,
                             slopes).numpy()
    assert fa.flash_attention.launches == before   # CPU: plain version
    pos = jnp.broadcast_to(q_start + jnp.arange(chunk), (b, chunk))
    want = ref_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         pos, jnp.int32(kv_len), ref_slopes)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if max_seq % 8 == 0:   # the Pallas kernel refuses other capacities
        want_k = ref_flash_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.int32(q_start), jnp.int32(kv_len), ref_slopes,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(want_k), **TOL)


@pytest.mark.parametrize("model", ["llama-test", "bloom-test"])
def test_flash_hook_in_stage_forward_matches_reference(model):
    """The port's ``make_flash_attn_impl`` hook through ``stage_forward``
    (a 16-token chunk: the flash route; then a 1-token decode step: the
    plain route) against the reference's hook in interpret mode."""
    rcfg = ref_get_model_config(model)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_model_config(model)
    params = params_from_numpy(
        {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
         for k, v in dict(layers=rp.layers, embed=rp.embed,
                          final_norm=rp.final_norm,
                          lm_head=rp.lm_head).items()}, cfg, "cpu")
    b, s, max_seq = 2, 16, 40
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, s))
    nxt = np.random.RandomState(2).randint(0, cfg.vocab_size, (b, 1))

    rspec = RefStageSpec(0, 1, 0, rcfg.num_layers)
    rhook = ref_make_flash_attn_impl(interpret=True)
    rcache = RefKVCache.create(rcfg, rcfg.num_layers, b, max_seq)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    rl1, rcache = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(ids),
                                    rcache, pos, attn_impl=rhook)
    rl2, _ = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(nxt), rcache,
                               jnp.full((b, 1), s), attn_impl=rhook)

    spec = StageSpec(0, 1, 0, cfg.num_layers)
    hook = fa.make_flash_attn_impl()
    cache = KVCache.create(cfg, cfg.num_layers, b, max_seq)
    before = fa.flash_attention.launches
    l1, cache = stage_forward(params, cfg, spec, torch.from_numpy(ids),
                              cache, torch.arange(s).expand(b, s),
                              attn_impl=hook)
    l2, cache = stage_forward(params, cfg, spec, torch.from_numpy(nxt),
                              cache, torch.full((b, 1), s), attn_impl=hook)
    assert fa.flash_attention.launches == before
    assert cache.length == s + 1
    np.testing.assert_allclose(l1.numpy(), np.asarray(rl1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl2), **TOL)


@pytest.mark.parametrize("change,match", [
    (dict(hd=48), "head_dim"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(q_start=-1), "out of range"),
    (dict(kv_len=65), "out of range"),
    (dict(nkv=3), "does not match"),
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    """The checks the wrapper runs before a launch (shape/dtype only, so
    they run here on CPU tensors)."""
    a = dict(b=1, chunk=16, nh=4, nkv=2, hd=64, dtype=torch.float32,
             q_start=0, kv_len=16)
    a.update(change)
    q = torch.zeros((a["b"], a["chunk"], a["nh"], a["hd"]), dtype=a["dtype"])
    kc = torch.zeros((a["b"], a["nkv"], 64, a["hd"]), dtype=a["dtype"])
    with pytest.raises(ValueError, match=match):
        fa._check_cuda_args(q, kc, kc.clone(), a["q_start"], a["kv_len"],
                            None)
