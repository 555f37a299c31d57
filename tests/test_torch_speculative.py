"""The torch port's speculative decoding against the JAX package's.

The shared accept rule first: ``accept_and_extra``, ``verify_emit`` and
``verify_emit_per_row`` on the same logits, drafts and noise as the
reference (its own ``jax.random`` uniforms and Gumbel noise handed to
the port), greedy and sampled, one-hot and model q, ``k_cap`` with
truncation, an all-zero residual: ``a``, ``extra``, the blocks and
``m`` exactly.  Then ``SpeculativeEngine`` on ``llama-test`` (f32, the
reference's weights through ``models/bridge.py``; the draft is
``llama-test`` at 2 layers from another seed, as the reference's
tests): greedy tokens and ``SpecStats`` equal the reference engine's
and the port's ``InferenceEngine``'s, chunked prefill against whole,
the prefix pool, the float8 cache, dispatch-size invariance, stream =
generate, eos padding and early stop, the capacity guard, a vocab
mismatch, a self-draft accepting everything (greedy and sampled), and
``SpeculativeBackend``'s ``/stats`` fragment.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime import speculative as ref_spec
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime import speculative as spec
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.speculative import (
    SpeculativeBackend, SpeculativeEngine, SpecStats)

MAX_SEQ = 96
GREEDY = SamplingParams(greedy=True)
PROMPT = np.asarray([[3, 14, 15, 92, 65], [1, 2, 3, 4, 5]])


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bridge(rp, cfg):
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    return params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    """(ref cfg, ref params, ref draft cfg, ref draft params, cfg,
    params, draft cfg, draft params): the draft is 2 layers from seed 1."""
    rcfg = ref_get_model_config("llama-test")
    rdcfg = dataclasses.replace(rcfg, num_layers=2)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    rdp = ref_init_full_params(jax.random.PRNGKey(1), rdcfg)
    cfg = get_model_config("llama-test")
    dcfg = dataclasses.replace(cfg, num_layers=2)
    return (rcfg, rp, rdcfg, rdp, cfg, _bridge(rp, cfg), dcfg,
            _bridge(rdp, dcfg))


@pytest.fixture(scope="module")
def oracle(models):
    return InferenceEngine(models[4], models[5], max_seq=MAX_SEQ,
                           sampling=GREEDY, device="cpu")


def _spec(models, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("num_draft", 4)
    return SpeculativeEngine(models[4], models[5], models[6], models[7],
                             device="cpu", **kw)


# ---------------------------------------------------------------------------
# the accept rule on injected noise


def _rule_inputs(seed, b=3, K=4, V=40, ties=False):
    rng = np.random.RandomState(seed)
    t = rng.randn(b, K + 1, V).astype(np.float32)
    q = rng.randn(b, K, V).astype(np.float32)
    drafts = rng.randint(0, V, (b, K)).astype(np.int32)
    if ties:
        # drafts that are the target's argmax for a prefix of each row
        arg = t.argmax(-1)
        for i in range(b):
            drafts[i, :i + 1] = arg[i, :i + 1]
    return t, q, drafts


def _ref_noise(seed, b, K, V):
    key_u, key_x = jax.random.split(jax.random.PRNGKey(seed))
    return (key_u, key_x, np.array(jax.random.uniform(key_u, (b, K))),
            np.array(jax.random.gumbel(key_x, (b, V), jnp.float32)))


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("model_q", [False, True])
@pytest.mark.parametrize("k_cap", [None, [1, 2, 4]])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_and_extra_match_reference(greedy, model_q, k_cap, seed):
    b, K, V = 3, 4, 40
    t, q, drafts = _rule_inputs(seed, b, K, V, ties=True)
    rs = (RefSamplingParams(greedy=True) if greedy else
          RefSamplingParams(temperature=0.9, top_k=0))
    ps = (GREEDY if greedy else SamplingParams(temperature=0.9, top_k=0))
    key_u, key_x, u, g = _ref_noise(seed, b, K, V)
    cap = None if k_cap is None else np.asarray(k_cap, np.int32)
    ra, rx = ref_spec.accept_and_extra(
        jnp.asarray(t), jnp.asarray(drafts),
        jnp.asarray(q) if model_q else None, rs, key_u, key_x,
        k_cap=None if cap is None else jnp.asarray(cap))
    pa_, px = spec.accept_and_extra(
        torch.from_numpy(t), torch.from_numpy(drafts).long(),
        torch.from_numpy(q) if model_q else None, ps,
        torch.from_numpy(u), torch.from_numpy(g),
        k_cap=None if cap is None else torch.from_numpy(cap).long())
    np.testing.assert_array_equal(pa_.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(px.numpy(), np.asarray(rx))


def test_all_zero_residual_falls_back_to_p(monkeypatch):
    """One-hot q and p a point mass on the draft, rejected by a crafted
    uniform of 1.0: the residual is all zero, and the follow-up falls
    back to p itself, drawing the draft again, as the reference's (its
    uniforms replaced by the same crafted ones)."""
    b, K, V = 2, 3, 16
    t = np.full((b, K + 1, V), -1e4, np.float32)
    drafts = np.asarray([[5, 6, 7], [1, 2, 3]], np.int32)
    t[0, :, 5] = 0.0          # row 0: p is a point mass on d_1
    t[1, 0, 9] = 0.0          # row 1: rejects d_1 in the usual way
    t[1, 1:, 2] = 0.0
    rs = RefSamplingParams(temperature=1.0, top_k=0)
    ps = SamplingParams(temperature=1.0, top_k=0)
    key_u, key_x, u, g = _ref_noise(5, b, K, V)
    u[0, 0] = 1.0
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    ra, rx = ref_spec.accept_and_extra(jnp.asarray(t), jnp.asarray(drafts),
                                       None, rs, key_u, key_x)
    pa_, px = spec.accept_and_extra(torch.from_numpy(t),
                                    torch.from_numpy(drafts).long(), None,
                                    ps, torch.from_numpy(u),
                                    torch.from_numpy(g))
    np.testing.assert_array_equal(pa_.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(px.numpy(), np.asarray(rx))
    assert int(pa_[0]) == 0 and int(px[0]) == 5


@pytest.mark.parametrize("greedy", [True, False])
def test_verify_emit_lockstep_and_per_row_match_reference(greedy):
    b, K, V = 4, 4, 32
    t, q, drafts = _rule_inputs(7, b, K, V, ties=True)
    rs = (RefSamplingParams(greedy=True) if greedy else
          RefSamplingParams(temperature=0.8, top_k=8))
    ps = GREEDY if greedy else SamplingParams(temperature=0.8, top_k=8)
    key_u, key_x, u, g = _ref_noise(7, b, K, V)
    args = (jnp.asarray(t), jnp.asarray(drafts), jnp.asarray(q), rs, key_u,
            key_x)
    pargs = (torch.from_numpy(t), torch.from_numpy(drafts).long(),
             torch.from_numpy(q), ps, torch.from_numpy(u),
             torch.from_numpy(g))
    rem, rm, rlast = ref_spec.verify_emit(*args)
    pem, pm, plast = spec.verify_emit(*pargs)
    np.testing.assert_array_equal(pem.numpy(), np.asarray(rem))
    assert int(pm) == int(rm) and pm.ndim == 0
    np.testing.assert_array_equal(plast.numpy(), np.asarray(rlast))
    cap = np.asarray([1, 4, 2, 3], np.int32)
    rem, rn, rlast = ref_spec.verify_emit_per_row(*args,
                                                  k_cap=jnp.asarray(cap))
    pem, pn, plast = spec.verify_emit_per_row(
        *pargs, k_cap=torch.from_numpy(cap).long())
    np.testing.assert_array_equal(pem.numpy(), np.asarray(rem))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(plast.numpy(), np.asarray(rlast))


def test_host_helpers_match_reference():
    toks = np.asarray([[1, 9, 3, 9], [9, 2, 2, 2], [4, 4, 4, 4]])
    np.testing.assert_array_equal(spec.mask_after_eos(toks, 9),
                                  ref_spec.mask_after_eos(toks, 9))
    np.testing.assert_array_equal(spec.pad_to_width(toks[:, :2], 5, 9),
                                  ref_spec.pad_to_width(toks[:, :2], 5, 9))
    np.testing.assert_array_equal(spec.init_done(toks[:, 0], 9),
                                  ref_spec.init_done(toks[:, 0], 9))
    em = np.arange(2 * 3 * 5).reshape(2, 3, 5)
    ms = np.asarray([2, 5])
    outs = []
    for mod in (spec, ref_spec):
        out, st, done = [], mod.SpecStats(), np.zeros(3, bool)
        total = mod.drain_round_blocks(em, ms, out, st, 4, 1, 6, 7, done)
        outs.append((total, [o.tolist() for o in out], st, done.tolist()))
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    assert vars(outs[0][2]) == vars(outs[1][2]) and outs[0][3] == outs[1][3]
    st = SpecStats(rounds=3, drafted=12, accepted=5, emitted=9)
    rst = ref_spec.SpecStats(rounds=3, drafted=12, accepted=5, emitted=9)
    assert spec.stats_json(st, 4) == ref_spec.stats_json(rst, 4)
    assert spec.stats_json(SpecStats(), 4) == ref_spec.stats_json(
        ref_spec.SpecStats(), 4)


# ---------------------------------------------------------------------------
# SpeculativeEngine


def test_greedy_matches_reference_and_target_only(models, oracle):
    rcfg, rp, rdcfg, rdp = models[:4]
    ref = ref_spec.SpeculativeEngine(
        rcfg, rp, rdcfg, rdp, max_seq=MAX_SEQ,
        sampling=RefSamplingParams(greedy=True), num_draft=4)
    rres, rstats = ref.generate(PROMPT, 24)
    res, stats = _spec(models).generate(PROMPT, 24)
    np.testing.assert_array_equal(res.tokens, rres.tokens)
    np.testing.assert_array_equal(res.tokens,
                                  oracle.generate(PROMPT, 24).tokens)
    assert vars(stats) == vars(rstats)
    assert stats.emitted == 24 and stats.rounds >= 1


@pytest.mark.parametrize("plen", [5, 17, 40])
def test_chunked_prefill_matches_whole(models, plen):
    prompt = np.random.RandomState(plen).randint(0, 250, (1, plen))
    whole, _ = _spec(models).generate(prompt, 12)
    chunked, _ = _spec(models, prefill_chunk=8).generate(prompt, 12)
    np.testing.assert_array_equal(whole.tokens, chunked.tokens)


def test_prefix_pool_seeds_the_target(models, oracle):
    """A second prompt sharing whole blocks seeds the target's cache from
    the pool and prefills its suffix; the draft prefills the full
    prompt; the tokens stay the target's greedy ones."""
    eng = _spec(models, kv_cache_blocks=16, kv_block_tokens=8)
    a = np.arange(3, 23)[None, :]
    b = np.concatenate([a[:, :16], [[7, 7, 9]]], axis=1)
    for p in (a, b):
        res, _ = eng.generate(p, 10)
        np.testing.assert_array_equal(res.tokens,
                                      oracle.generate(p, 10).tokens)
    snap = eng.kv_cache.snapshot()
    assert snap["hits"] == 1 and snap["partial_hit_tokens"] == 16


def test_float8_cache_matches_float8_engine(models):
    base = InferenceEngine(models[4], models[5], max_seq=MAX_SEQ,
                           sampling=GREEDY, kv_cache_dtype="float8_e4m3fn",
                           device="cpu")
    eng = _spec(models, kv_cache_dtype="float8_e4m3fn")
    assert eng.attn_backend == "plain"
    np.testing.assert_array_equal(eng.generate(PROMPT, 16)[0].tokens,
                                  base.generate(PROMPT, 16).tokens)


def test_dispatch_size_invariance_stream_and_eos(models, oracle):
    eng = _spec(models)
    want = eng.generate(PROMPT, 20)[0].tokens
    for r in (1, 3):
        np.testing.assert_array_equal(
            eng.generate(PROMPT, 20, rounds_per_dispatch=r)[0].tokens, want)
    st = SpecStats()
    streamed = np.stack(list(eng.generate_stream(PROMPT, 20, stats_out=st)),
                        axis=1)
    np.testing.assert_array_equal(streamed, want)
    assert st.emitted == 20 and st.rounds >= 1
    assert list(eng.generate_stream(PROMPT, 0)) == []
    # eos: rows pad with eos after their first, as the plain engine's;
    # with every row done the rounds stop early
    eos = int(want[0, 3])
    eng_eos = _spec(models, eos_id=eos)
    base = InferenceEngine(models[4], models[5], max_seq=MAX_SEQ,
                           sampling=GREEDY, eos_id=eos, device="cpu")
    res, stats = eng_eos.generate(PROMPT[:1], 20)
    np.testing.assert_array_equal(res.tokens,
                                  base.generate(PROMPT[:1], 20).tokens)
    assert res.tokens.shape == (1, 20) and stats.emitted < 20
    streamed = list(eng_eos.generate_stream(PROMPT[:1], 20))
    assert int(streamed[-1][0]) == eos and len(streamed) < 20


def test_refusals(models):
    with pytest.raises(ValueError, match="exceeds KV-cache capacity"):
        _spec(models).generate(PROMPT, MAX_SEQ)
    bad = dataclasses.replace(models[6], vocab_size=models[6].vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(models[4], models[5], bad, models[7], device="cpu")
    with pytest.raises(ValueError, match="num_draft"):
        _spec(models, num_draft=0)


def test_cache_capacity_has_round_slack(models):
    tc, dc = _spec(models).new_caches(2)
    assert tc.max_seq == dc.max_seq == 104       # pad(96 + 4 + 1)
    # a request filling max_seq exactly runs its last rounds in the slack
    eng = _spec(models, max_seq=24)
    res, _ = eng.generate(PROMPT, 24 - PROMPT.shape[1])
    assert res.tokens.shape == (2, 19)


@pytest.mark.parametrize("samp", [GREEDY, SamplingParams(temperature=0.9,
                                                          top_k=0)])
def test_self_draft_accepts_everything(models, samp):
    """Draft == target: q == p exactly, so every proposal is accepted
    (a misaligned q row or noise column would show as acceptance < 1)."""
    eng = SpeculativeEngine(models[4], models[5], models[4], models[5],
                            max_seq=MAX_SEQ, sampling=samp, num_draft=4,
                            device="cpu")
    res, stats = eng.generate(PROMPT, 21, seed=3)
    assert stats.acceptance_rate == 1.0
    assert stats.rounds == 4           # 1 prefill token + 4 rounds of 5
    assert (res.tokens >= 0).all() and (res.tokens < 256).all()
    if not samp.greedy:
        again, _ = eng.generate(PROMPT, 21, seed=3)
        other, _ = eng.generate(PROMPT, 21, seed=4)
        np.testing.assert_array_equal(again.tokens, res.tokens)
        assert not np.array_equal(other.tokens, res.tokens)


def test_backend_surface_and_stats(models):
    backend = SpeculativeBackend(_spec(models))
    assert backend.stats() == {"speculative": None}
    res = backend.generate(PROMPT[:1], 8)
    streamed = np.stack(list(backend.generate_stream(PROMPT[:1], 8)), 1)
    np.testing.assert_array_equal(streamed, res.tokens)
    sp = backend.stats()["speculative"]
    assert sp["num_draft"] == 4 and sp["rounds"] >= 1
    assert set(sp) == {"num_draft", "rounds", "acceptance_rate",
                       "tokens_per_round"}
