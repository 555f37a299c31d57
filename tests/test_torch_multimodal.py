"""The port's multimodal runtime (``runtime/multimodal.py``) against the
JAX package's, in one process on the CPU.

Both packages run ``llama-test`` on the reference's weights (seed 0)
and the ``clip-test`` tower on the reference's vision weights (seed 1),
in f32.  ``MultimodalEngine``'s prefix logits agree within 2e-4 and its
greedy tokens equal the reference engine's; the text-only prefix equals
the plain engine; an image changes the generation; ``MultimodalHeader``
+ ``VisionWorker`` over ``LoopbackTransport`` give the engine's tokens;
and the two packages' pieces interoperate over the wire both ways (the
port's vision worker behind the reference's header, the reference's
vision worker behind the port's header).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.comm.transport import \
    LoopbackNetwork as RefNetwork
from distributed_inference_demo_tpu.comm.transport import \
    LoopbackTransport as RefTransport
from distributed_inference_demo_tpu.models.base import \
    slice_stage as ref_slice_stage
from distributed_inference_demo_tpu.models.vision import \
    VisionConfig as RefVisionConfig
from distributed_inference_demo_tpu.models.vision import \
    init_vision_params as ref_init_vision_params
from distributed_inference_demo_tpu.runtime import distributed as ref_dist
from distributed_inference_demo_tpu.runtime import multimodal as ref_mm
from distributed_inference_demo_tpu_torch.comm.transport import (
    LoopbackNetwork, LoopbackTransport, TransportTimeout)
from distributed_inference_demo_tpu_torch.models.base import (
    slice_stage, split_layer_ranges)
from distributed_inference_demo_tpu_torch.models.bridge import \
    vision_params_from_numpy
from distributed_inference_demo_tpu_torch.models.decoder import embed_tokens
from distributed_inference_demo_tpu_torch.models.vision import VisionConfig
from distributed_inference_demo_tpu_torch.runtime.distributed import (
    PipelineWorker, StageRuntime)
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.multimodal import (
    MultimodalEngine, MultimodalHeader, VisionWorker)
from test_torch_ring import GREEDY, REF_GREEDY, _few_torch_threads, weights

__all__ = ["_few_torch_threads"]
MAX_SEQ = 64
TOL = dict(rtol=2e-4, atol=2e-4)
CLIP_TEST = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                 num_heads=4, intermediate_size=64, clip_arch=True,
                 feature_layer=-2, hidden_act="quick_gelu")
TEXT = np.array([[5, 17, 42, 7, 99]], dtype=np.int32)
_TOWER = {}


def tower():
    """(ref vcfg, ref vparams, port vcfg, port vparams): clip-test on the
    reference's seed-1 weights, made once."""
    if not _TOWER:
        rcfg = RefVisionConfig(**CLIP_TEST)
        rp = ref_init_vision_params(jax.random.PRNGKey(1), rcfg,
                                    weights()[2].hidden_size)
        _TOWER["t"] = (rcfg, rp, VisionConfig(**CLIP_TEST),
                       vision_params_from_numpy(jax.tree.map(np.asarray, rp),
                                                "cpu"))
    return _TOWER["t"]


def image(b=1, seed=2, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 28, 28, 3) * scale).astype(np.float32)


def port_engine(**kw):
    _, _, cfg, full, _ = weights()
    return MultimodalEngine(cfg, full, tower()[2], tower()[3],
                            max_seq=MAX_SEQ, sampling=GREEDY, device="cpu",
                            **kw)


def ref_engine():
    rcfg, rp, _, _, _ = weights()
    return ref_mm.MultimodalEngine(rcfg, rp, tower()[0], tower()[1],
                                   max_seq=MAX_SEQ, sampling=REF_GREEDY)


@pytest.fixture(scope="module")
def engines():
    return port_engine(), ref_engine()


@pytest.mark.parametrize("b", [1, 2])
def test_engine_matches_reference(engines, b):
    mine, theirs = engines
    img, text = image(b), np.repeat(TEXT, b, axis=0)
    text[-1, 0] = 11
    want_embeds = np.asarray(theirs._encode(
        theirs.vparams, theirs.engine.params, jnp.asarray(img),
        jnp.asarray(text)))
    got_embeds = mine.encode(img, text)
    assert got_embeds.shape == (b, 4 + TEXT.shape[1], 64)
    np.testing.assert_allclose(got_embeds.numpy(), want_embeds, **TOL)
    cache = theirs.engine.new_cache(b)
    want_logits, _ = theirs._prefill_embeds(theirs.engine.params,
                                            jnp.asarray(want_embeds), cache)
    np.testing.assert_allclose(mine.prefill_logits(img, text),
                               np.asarray(want_logits), **TOL)
    want = theirs.generate(img, text, 10).tokens
    got = mine.generate(img, text, 10)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.prompt_len == 4 + TEXT.shape[1] and got.num_new == 10


def test_text_only_prefix_matches_plain_engine(engines):
    """A prefix that is exactly the token embeddings gives the plain
    engine's tokens, through the same static state and decode loop."""
    mine, _ = engines
    _, _, cfg, full, _ = weights()
    plain = InferenceEngine(cfg, full, max_seq=MAX_SEQ, sampling=GREEDY,
                            device="cpu")
    want = plain.generate(TEXT, 8).tokens
    embeds = embed_tokens(full, cfg, torch.from_numpy(TEXT).long())
    got = mine.engine.generate_embeds(embeds, 8)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.steps_computed == 8
    # a stale longer prefix in the same static state changes nothing
    mine.generate(image(), np.repeat(TEXT, 4, axis=1), 4)
    np.testing.assert_array_equal(
        mine.engine.generate_embeds(embeds, 8).tokens, want)


def test_image_changes_generation(engines):
    mine, _ = engines
    t1 = mine.generate(image(seed=2), TEXT, 8).tokens
    t2 = mine.generate(image(seed=9, scale=3.0), TEXT, 8).tokens
    assert not np.array_equal(t1, t2)


def test_capacity_and_device_checks(engines):
    mine, _ = engines
    long_text = np.ones((1, MAX_SEQ), np.int32)
    with pytest.raises(ValueError, match="capacity"):
        mine.generate(image(), long_text, 1)
    with pytest.raises(ValueError, match="embeds must be"):
        mine.engine.generate_embeds(torch.ones(1, 4), 2)
    _, _, cfg, full, _ = weights()
    with pytest.raises(ValueError, match="vision params live on"):
        MultimodalEngine(cfg, full, tower()[2],
                         {"patch_embed": torch.empty(0, device="meta")},
                         device="cpu")


# ---------------------------------------------------------------------------
# the pipeline: MultimodalHeader + VisionWorker


def _port_chain(net):
    """A port header s0 and a port tail s1 (not started); the vision node
    "vis" is the caller's."""
    _, _, cfg, full, _ = weights()
    specs = split_layer_ranges(cfg.num_layers, 2)
    th, tw = (LoopbackTransport(d, net) for d in ("s0", "s1"))
    header = MultimodalHeader(
        StageRuntime(cfg, specs[0], slice_stage(full, cfg, specs[0]),
                     MAX_SEQ, GREEDY, device="cpu"),
        th, next_id="s1", vision_id="vis", step_timeout=60)
    worker = PipelineWorker(
        StageRuntime(cfg, specs[1], slice_stage(full, cfg, specs[1]),
                     MAX_SEQ, GREEDY, device="cpu"),
        tw, next_id=None, header_id="s0", step_timeout=60)
    return header, worker


def _ref_chain(net):
    rcfg, rp, _, _, _ = weights()
    specs = split_layer_ranges(rcfg.num_layers, 2)
    th, tw = (RefTransport(d, net) for d in ("s0", "s1"))
    header = ref_mm.MultimodalHeader(
        ref_dist.StageRuntime(rcfg, specs[0],
                              ref_slice_stage(rp, rcfg, specs[0]), MAX_SEQ,
                              REF_GREEDY),
        th, next_id="s1", vision_id="vis", step_timeout=60)
    worker = ref_dist.PipelineWorker(
        ref_dist.StageRuntime(rcfg, specs[1],
                              ref_slice_stage(rp, rcfg, specs[1]), MAX_SEQ,
                              REF_GREEDY),
        tw, next_id=None, header_id="s0", step_timeout=60)
    return header, worker


def _run(header, vision, worker, fn):
    threads = [threading.Thread(target=vision.serve_forever, args=(30,),
                                daemon=True),
               threading.Thread(target=worker.serve_forever, args=(30,),
                                daemon=True)]
    for t in threads:
        t.start()
    try:
        return fn()
    finally:
        header.shutdown_pipeline()
        header.transport.send("vis", "stop", b"")
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()


def test_header_and_vision_worker_match_engine(engines):
    mine, _ = engines
    img = image()
    want = mine.generate(img, TEXT, 10).tokens
    net = LoopbackNetwork()
    header, worker = _port_chain(net)
    vision = VisionWorker(tower()[3], tower()[2],
                          LoopbackTransport("vis", net), header_id="s0",
                          step_timeout=60)
    steps = []

    def both():
        got = header.generate_mm(img, TEXT, 10,
                                 on_token=lambda i, s, t: steps.append(s))
        # a text-only request through the same header still works
        text = header.generate(TEXT, 6)
        return got, text

    got, text = _run(header, vision, worker, both)
    np.testing.assert_array_equal(got, want)
    assert steps == list(range(10)) and vision.images == 1
    _, _, cfg, full, _ = weights()
    plain = InferenceEngine(cfg, full, max_seq=MAX_SEQ, sampling=GREEDY,
                            device="cpu")
    np.testing.assert_array_equal(text, plain.generate(TEXT, 6).tokens)
    assert not header._mm_prefix
    assert header.rt.pages_free == header.rt.num_pages


def test_failed_request_drops_its_stash(engines):
    """A request refused by the capacity check leaves no stashed prefix
    for the next request of that rid."""
    net = LoopbackNetwork()
    header, worker = _port_chain(net)
    vision = VisionWorker(tower()[3], tower()[2],
                          LoopbackTransport("vis", net), header_id="s0",
                          step_timeout=60)

    def refused_then_text():
        with pytest.raises(ValueError, match="exceeds KV capacity"):
            header.generate_mm(image(), TEXT, MAX_SEQ)
        assert not header._mm_prefix
        return header.generate(TEXT, 4)

    got = _run(header, vision, worker, refused_then_text)
    np.testing.assert_array_equal(got, engines[0].engine.generate(
        TEXT, 4).tokens)


def test_vision_timeout_raises():
    net = LoopbackNetwork()
    header, _ = _port_chain(net)
    LoopbackTransport("vis", net)          # registered, never answers
    header.step_timeout = 0.2
    with pytest.raises(TransportTimeout):
        header._encode_image(image())


def test_port_vision_worker_behind_reference_header(engines):
    """The reference's header and stages, the port's vision worker: its
    frames decode on the reference's side into the same tokens as the
    reference's engine."""
    _, theirs = engines
    img = image(seed=4)
    want = theirs.generate(img, TEXT, 8).tokens
    net = RefNetwork()
    header, worker = _ref_chain(net)
    vision = VisionWorker(tower()[3], tower()[2], RefTransport("vis", net),
                          header_id="s0", step_timeout=60)
    got = _run(header, vision, worker,
               lambda: header.generate_mm(img, TEXT, 8))
    np.testing.assert_array_equal(got, want)
    assert vision.images == 1


def test_reference_vision_worker_behind_port_header(engines):
    mine, _ = engines
    img = image(seed=5)
    want = mine.generate(img, TEXT, 8).tokens
    net = LoopbackNetwork()
    header, worker = _port_chain(net)
    vision = ref_mm.VisionWorker(tower()[1], tower()[0],
                                 LoopbackTransport("vis", net),
                                 header_id="s0", step_timeout=60)
    got = _run(header, vision, worker,
               lambda: header.generate_mm(img, TEXT, 8))
    np.testing.assert_array_equal(got, want)
