"""The fixed-shape decode step that a CUDA graph replays, on the CPU.

On the card each decode step of both engines replays a captured graph
(``runtime/cuda_graph.py``); on the CPU the same step runs eagerly over
the same static buffers, so these tests hold what the graph replays:

- the step against the JAX package's ``decode_loop`` and ``decode_one``
  (``llama-test``, ``gemma-test``, ``bloom-test`` with ALiBi; weights
  carried across by ``models/bridge.params_from_numpy``): tokens exact,
  logits and logprobs to 2e-4 at f32, greedy and with the reference's
  Gumbel noise handed to the port;
- one static state per batch size, reused across calls, immune to stale
  and non-finite cache columns past the length;
- the batching engine's buffers stay the same tensors across steps;
- ``loop_stats`` keep the reference's counts;
- a capture that fails raises, and nothing runs eagerly in its place;
- the graph runner's launch accounting.

Capture and replay themselves need the card: ``tests/test_torch_cuda.py``.
"""

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
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import sampling
from distributed_inference_demo_tpu_torch.runtime import cuda_graph
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

MAX_SEQ, NEW = 64, 10
TOL = dict(rtol=2e-4, atol=2e-4)
SAMPLED = dict(temperature=0.8, top_k=5)
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _weights(name):
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def llama():
    return _weights("llama-test")


def _ids(cfg, b, n, seed=5):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, n)).astype(np.int32)


def _ref_noise(seed: int, shape, steps: int) -> list:
    """The Gumbel noise the reference's decode programs draw, in order:
    per step ``rng, sub = split(rng)``, then ``categorical(sub, vals)`` =
    ``argmax(vals + gumbel(sub, vals.shape))``."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(
            jax.random.gumbel(sub, shape, jnp.float32))))
    return out


def _hand_noise(monkeypatch, noise: list) -> None:
    """Every port draw takes the next of ``noise`` instead."""
    it = iter(noise)
    monkeypatch.setattr(sampling, "gumbel_noise",
                        lambda shape, gen, device: next(it))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", ["llama-test", "gemma-test", "bloom-test"])
def test_fixed_step_matches_reference_loop_and_one(monkeypatch, name, mode):
    """The port's loop (``generate``) and per-token stream against the
    reference's ``decode_loop`` and ``decode_one`` on the same weights
    and prompt: tokens equal, logprobs and the next step's logits within
    2e-4."""
    rcfg, rp, cfg, params = _weights(name)
    kw = SAMPLED if mode == "sampled" else dict(greedy=True)
    ref = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(**kw), attn_backend="jnp")
    port = InferenceEngine(cfg, params, max_seq=MAX_SEQ,
                           sampling=sampling.SamplingParams(**kw),
                           device="cpu")
    ids, seed = _ids(cfg, 2, 23), 3
    b = ids.shape[0]
    last, cache = ref._run_prefill(jnp.asarray(ids), ref.new_cache(b))
    r_toks, r_lps, r_next, _, _, _, r_steps = ref._decode_loop(
        ref.params, last, cache, jax.random.PRNGKey(seed),
        ref._eos_scalar(), ref._stop_ids, jnp.zeros((b,), bool),
        jnp.int32(NEW), NEW, True)
    if mode == "sampled":
        _hand_noise(monkeypatch, _ref_noise(seed, (b, SAMPLED["top_k"]),
                                            NEW))
    got = port.generate(ids, NEW, seed=seed, logprobs=True)
    np.testing.assert_array_equal(got.tokens, np.asarray(r_toks))
    assert got.steps_computed == int(r_steps) == NEW
    np.testing.assert_allclose(got.logprobs, np.asarray(r_lps), **TOL)
    np.testing.assert_allclose(port._states[b].logits.numpy(),
                               np.asarray(r_next), **TOL)

    # the per-token path against decode_one, step by step
    logits, cache = ref._run_prefill(jnp.asarray(ids), ref.new_cache(b))
    rng, done = jax.random.PRNGKey(seed), jnp.zeros((b,), bool)
    one_toks, one_lps = [], []
    for _ in range(NEW):
        tok, lp, logits, cache, rng, done = ref._decode_one(
            ref.params, logits, cache, rng, ref._eos_scalar(),
            ref._stop_ids, done)
        one_toks.append(np.asarray(tok))
        one_lps.append(np.asarray(lp))
    if mode == "sampled":
        _hand_noise(monkeypatch, _ref_noise(seed, (b, SAMPLED["top_k"]),
                                            NEW))
    port.stream_block = 1
    items = list(port.generate_stream(ids, NEW, seed=seed, logprobs=True))
    np.testing.assert_array_equal(np.stack([t for t, _ in items], 1),
                                  np.stack(one_toks, 1))
    np.testing.assert_allclose(np.stack([lp for _, lp in items], 1),
                               np.stack(one_lps, 1), **TOL)
    np.testing.assert_allclose(port._states[b].logits.numpy(),
                               np.asarray(logits), **TOL)


@pytest.mark.parametrize("stale", ["finite", "nan"])
def test_static_state_reused_and_immune_to_stale_columns(llama, stale):
    """Two calls with different prompt lengths share one static state;
    the second, shorter one leaves the first call's columns past its
    length (or NaN in every column, ``stale="nan"``) and still gives a
    fresh engine's tokens and logprobs, bit for bit."""
    _, _, cfg, params = llama
    eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                          sampling=sampling.SamplingParams(greedy=True))
    eng.generate(_ids(cfg, 2, 30, seed=1), NEW)
    st = eng._states[2]
    keys_ptr = st.cache.keys.data_ptr()
    if stale == "nan":
        st.cache.keys.fill_(float("nan"))
        st.cache.values.fill_(float("nan"))
    short = _ids(cfg, 2, 12, seed=2)
    got = eng.generate(short, NEW, logprobs=True)
    assert list(eng._states) == [2] and eng._states[2] is st
    assert st.cache.keys.data_ptr() == keys_ptr
    fresh = InferenceEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                            sampling=sampling.SamplingParams(greedy=True))
    want = fresh.generate(short, NEW, logprobs=True)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.logprobs, want.logprobs)
    assert np.isfinite(got.logprobs).all()
    assert int(st.cache.length) == 12 + NEW


@pytest.mark.parametrize("config", [
    dict(),
    dict(decode_block=4),
    dict(prefill_chunk=16, decode_block=4, mixed_token_budget=32),
])
def test_batching_keeps_its_buffers_and_tokens(llama, config):
    """Every decode step of the batching engine, lockstep, fused or the
    decode half of a mixed dispatch, reads and writes the same
    ``_lengths``, ``_last_tok``, decode-table and active-mask tensors;
    the concurrent greedy tokens equal ``InferenceEngine``'s (which the
    eager step before the static buffers equalled too)."""
    _, _, cfg, params = llama
    greedy = sampling.SamplingParams(greedy=True)
    oracle = InferenceEngine(cfg, params, max_seq=96, sampling=greedy,
                             device="cpu")
    prompts = [_ids(cfg, 1, n, seed=i)[0] for i, n in
               enumerate((3, 9, 20, 40, 7))]
    want = [oracle.generate(p[None], 8).tokens[0].tolist() for p in prompts]
    with ContinuousBatchingEngine(cfg, params, max_seq=96, max_batch=4,
                                  prompt_buckets=(16, 64), sampling=greedy,
                                  kv_block_tokens=8, device="cpu",
                                  **config) as eng:
        names = ("_lengths", "_last_tok", "_dec_tables", "_active",
                 "_step_lp")
        objs = {n: getattr(eng, n) for n in names}
        seen, step = [], eng._decode.step

        def watched():
            seen.append(all(getattr(eng, n) is objs[n] for n in names))
            step()

        eng._decode.step = watched
        reqs = [eng.submit(p, 8) for p in prompts]
        got = [r.wait(timeout=WAIT).tolist() for r in reqs]
        assert all(getattr(eng, n) is objs[n] for n in names)
    assert got == want
    assert seen and all(seen)
    assert len(seen) == eng.loop_stats["device_loop_steps"]
    assert eng.graph_replays == 0          # the CPU runs the step eagerly


def test_loop_stats_match_reference(llama):
    """``host_dispatches`` and ``device_loop_steps`` after ``generate``
    and ``generate_stream`` at ``stream_block`` 1 and 4 equal the
    reference's, with an eos that ends a row early."""
    rcfg, rp, cfg, params = llama
    ref = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(greedy=True),
                    attn_backend="jnp")
    port = InferenceEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                           sampling=sampling.SamplingParams(greedy=True))
    ids = _ids(cfg, 1, 17)
    free = ref.generate(ids, NEW).tokens
    ref.eos_id = port.eos_id = int(free[0, 5])
    for run in ("generate", 1, 4):
        r0, p0 = dict(ref.loop_stats), dict(port.loop_stats)
        if run == "generate":
            r, p = ref.generate(ids, NEW), port.generate(ids, NEW)
            np.testing.assert_array_equal(p.tokens, r.tokens)
            assert p.steps_computed == r.steps_computed < NEW
        else:
            ref.stream_block = port.stream_block = run
            r = list(ref.generate_stream(ids, NEW))
            p = list(port.generate_stream(ids, NEW))
            np.testing.assert_array_equal(np.stack(p), np.stack(r))
        assert ({k: port.loop_stats[k] - p0[k] for k in p0}
                == {k: ref.loop_stats[k] - r0[k] for k in p0}), run


def _claim_the_card_and_fail_capture(monkeypatch) -> list:
    """Make the graph runner see a card and its capture fail as a CUDA
    capture does; returns the list the failed captures are logged in."""
    calls = []

    def capture(step, generator, pool):
        calls.append(pool)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(cuda_graph, "_warm_up", lambda step, device: None)
    monkeypatch.setattr(cuda_graph, "_capture", capture)
    return calls


def test_failed_capture_raises_and_runs_nothing_eagerly(llama, monkeypatch):
    """On a card whose capture fails, ``generate`` raises the capture
    error with its cause and no decode step runs in its place; the
    batching engine refuses to start.  Only ``cuda_graph=False`` runs the
    step eagerly, and then no capture is tried."""
    _, _, cfg, params = llama
    calls = _claim_the_card_and_fail_capture(monkeypatch)
    greedy = sampling.SamplingParams(greedy=True)
    eng = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                          device="cpu")
    steps = []
    step = eng._decode_step
    eng._decode_step = lambda *a: (steps.append(1), step(*a))
    with pytest.raises(cuda_graph.GraphCaptureError,
                       match="cuda_graph=False") as err:
        eng.generate(_ids(cfg, 1, 9), 4)
    assert isinstance(err.value.__cause__, RuntimeError)
    with pytest.raises(cuda_graph.GraphCaptureError):    # and again
        list(eng.generate_stream(_ids(cfg, 1, 9), 4))
    assert steps == [] and len(calls) == 2
    assert eng.loop_stats == {"host_dispatches": 0, "device_loop_steps": 0}
    with pytest.raises(cuda_graph.GraphCaptureError):
        ContinuousBatchingEngine(cfg, params, max_seq=MAX_SEQ, max_batch=2,
                                 sampling=greedy, kv_block_tokens=8,
                                 device="cpu")
    assert len(calls) == 3

    eager = InferenceEngine(cfg, params, max_seq=MAX_SEQ, sampling=greedy,
                            device="cpu", cuda_graph=False)
    res = eager.generate(_ids(cfg, 1, 9), 4)
    assert res.steps_computed == 4 and len(calls) == 3
    assert eager.graph_replays == 0


def test_replays_carry_the_launch_counts(monkeypatch):
    """The kernel wrappers count in Python, which runs at capture only:
    the runner takes the capture's counts back and adds them at every
    replay; the warm-up's launches were real and stay counted.  It
    restores the generator after the warm-up and counts replays."""
    replayed = []

    class FakeGraph:
        def replay(self):
            replayed.append(1)

    def capture(step, generator, pool):
        step()                 # the wrappers count as the capture records
        return FakeGraph()

    def step():
        pa.paged_flash_attention.int8_launches += 3
        gen.manual_seed(99)    # a draw moves the generator

    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    monkeypatch.setattr(cuda_graph, "_warm_up",
                        lambda step, device: step())
    monkeypatch.setattr(cuda_graph, "_capture", capture)
    monkeypatch.setattr(pa.paged_flash_attention, "int8_launches", 0)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    g = cuda_graph.StepGraph(step, torch.device("cpu"), gen)
    assert pa.paged_flash_attention.int8_launches == 3     # the warm-up
    assert torch.equal(gen.get_state(), state)
    for _ in range(4):
        g()
    assert replayed == [1] * 4 and g.replays == 4
    assert pa.paged_flash_attention.int8_launches == 3 + 4 * 3
    eager = cuda_graph.StepGraph(step, torch.device("cpu"), gen,
                                 enabled=False)
    eager()
    assert eager.graph is None and eager.replays == 0
    assert pa.paged_flash_attention.int8_launches == 3 + 5 * 3
