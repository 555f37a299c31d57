"""KV movement and the fleet on a card: the dense kernel's per-stream
and per-engine arrival counters, tier promotion, the export -> wire ->
adopt seam, and a sampled resumed stream under CUDA graphs.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch, without the repo's conftest:

    python -m pytest tests/test_torch_cuda_fleet.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.disagg import (
    PageStager, _page_frame)
from distributed_inference_demo_tpu_torch.runtime.kvcache.device import (
    adopt_blocks_into_pages, export_blocks_from_pages, payload_to)

GREEDY = SamplingParams(greedy=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _small_llama(dev, dtype="bfloat16"):
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3,
        dtype_name=dtype)
    return cfg, init_full_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)


def _leaves(x):
    return x.leaves() if isinstance(x, quant.QuantizedKVPages) else [x]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (1, 2048, 256),     # decode kernel, split K
    (8, 4096, 1024),    # decode kernel, the 8-slot batch
    (64, 4096, 512),    # prefill kernel, split K
])
def test_two_int8_products_on_two_streams_equal_sequential(cuda_device, m,
                                                           k, n):
    """Two engines in one process may run dense products on two streams
    at once: each (device, stream) has its own zeroed arrival counters,
    so 20 interleaved products a stream, launched together, equal the
    same products run one after the other, bit for bit."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    ws = [quant.quantize_array(torch.randn((k, n), generator=gen,
                                           device=cuda_device) * k ** -0.5)
          for _ in range(2)]
    xs = [torch.randn((m, k), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
          for _ in range(2)]
    assert qd.splits_for(qd.route(m, torch.bfloat16), m, k, n, 8,
                         qd._sm_count(cuda_device)) > 1
    want = [qd.quant_dense(x, w) for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    bufs = [qd.arrival_counters(cuda_device, s) for s in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(qd.quant_dense(xs[i], ws[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert torch.equal(got, want[i])
        assert int(bufs[i].abs().sum()) == 0


@pytest.mark.cuda
def test_each_engines_graphs_own_their_counters(cuda_device):
    """Two graph runners (two engines) capture the same int8 product:
    each graph keeps a counter buffer of its runner's, neither an eager
    stream's, so replays of the two on two streams at once equal the
    eager product; a capture outside a counters scope raises."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    from distributed_inference_demo_tpu_torch.runtime.cuda_graph import \
        StepGraphs
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k, n = 4096, 1024
    w = quant.quantize_array(torch.randn((k, n), generator=gen,
                                         device=cuda_device) * k ** -0.5)
    x = torch.randn((8, k), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    want = qd.quant_dense(x, w)
    outs = [torch.empty_like(want) for _ in range(2)]
    runners = [StepGraphs(cuda_device) for _ in range(2)]
    graphs = [r.capture(lambda o=o: o.copy_(qd.quant_dense(x, w)))
              for r, o in zip(runners, outs)]
    ptrs = {r._counters.data_ptr() for r in runners}
    ptrs.add(qd.arrival_counters(cuda_device).data_ptr())
    assert len(ptrs) == 3
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for _ in range(20):
        for o in outs:
            o.zero_()
        torch.cuda.synchronize()
        for g, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                g()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
    assert all(int(r._counters.abs().sum()) == 0 for r in runners)
    with pytest.raises(RuntimeError, match="counters of its own"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            qd.quant_dense(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_export_wire_adopt_is_bit_equal(cuda_device, kv_dtype):
    """Pages exported from a device pool, framed for the wire, staged on
    the host and adopted into another pool land bit for bit."""
    shape = (3, 17, 4, 16, 64)            # [L, N + 1, H, bt, D]
    src = [quant.alloc_kv_pages(shape, kv_dtype, torch.bfloat16, cuda_device)
           for _ in range(2)]
    dst = [quant.alloc_kv_pages(shape, kv_dtype, torch.bfloat16, cuda_device)
           for _ in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    run = [torch.randn((5, 3, 4, 16, 64), generator=gen, device=cuda_device)
           for _ in range(2)]
    ids = [2, 9, 4, 11, 0]
    if kv_dtype == "bf16":
        run = [r.to(torch.bfloat16) for r in run]
    adopt_blocks_into_pages(src[0], src[1], run[0], run[1], ids)
    kb, vb = export_blocks_from_pages(src[0], src[1], ids)
    frame = _page_frame(payload_to(kb, "cpu"), payload_to(vb, "cpu"), 0)
    st = PageStager("d")
    assert st.stage_page("r", 0, 0, frame, "pg:r:0:0") == "staged"
    hk, hv = st.concat_blocks(st.staging("r", 0), 5)
    to = [7, 1, 15, 3, 12]
    adopt_blocks_into_pages(dst[0], dst[1], payload_to(hk, cuda_device),
                            payload_to(hv, cuda_device), to)
    gk, gv = export_blocks_from_pages(dst[0], dst[1], to)
    for a, b in zip(_leaves(gk) + _leaves(gv), _leaves(kb) + _leaves(vb)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_promotion_equals_a_pool_hit(cuda_device, kv_dtype):
    """A prompt whose shared prefix was evicted into the host tier
    promotes it back: the promoted pages are the demoted bits, and its
    tokens and logprobs equal those of the same prompt served from a
    device prefix hit (no tier, a pool large enough to keep it)."""
    cfg, params = _small_llama(cuda_device)
    rs = np.random.RandomState(0)
    shared = rs.randint(0, cfg.vocab_size, 64).tolist()
    prompt = shared + rs.randint(0, cfg.vocab_size, 5).tolist()
    fillers = [rs.randint(0, cfg.vocab_size, 69).tolist() for _ in range(3)]
    kw = dict(max_seq=128, max_batch=2, sampling=GREEDY, kv_block_tokens=16,
              kv_dtype=kv_dtype, prompt_buckets=(16, 64, 128),
              device=cuda_device)
    outs = {}
    for name, extra in (("hit", dict(kv_cache_blocks=64)),
                        ("tier", dict(kv_cache_blocks=12,
                                      kv_host_tier_bytes=1 << 26))):
        eng = ContinuousBatchingEngine(cfg, params, **kw, **extra)
        try:
            eng.generate(np.asarray([shared + [1]]), 2)
            if name == "tier":
                for f in fillers:
                    eng.generate(np.asarray([f]), 2)
                assert eng._kv_tier.stats["demoted_blocks"] >= 4
            res = eng.generate(np.asarray([prompt]), 16, logprobs=True)
            outs[name] = (res.tokens, res.logprobs)
            if name == "tier":
                t = eng._kv_tier
                assert t.stats["promoted_blocks"] >= 4
                snap = eng.kv_cache.snapshot()
                assert snap["h2d_bytes"] == t.stats["promoted_bytes"]
                t.check()
            else:
                assert eng.kv_cache.stats["hits"] >= 1
        finally:
            eng.close()
    np.testing.assert_array_equal(outs["tier"][0], outs["hit"][0])
    np.testing.assert_array_equal(outs["tier"][1], outs["hit"][1])


@pytest.mark.cuda
def test_sampled_resume_under_graphs_equals_unfailed(cuda_device):
    """The generator registered with the decode graphs is rewound to its
    constructor seed before a resumed request's first draw: a sampled
    stream resumed after k delivered tokens equals the unfailed one on a
    fresh engine of the same seed, replays and all."""
    cfg, params = _small_llama(cuda_device)
    kw = dict(max_seq=96, max_batch=4, kv_block_tokens=16, seed=7,
              sampling=SamplingParams(temperature=0.9, top_k=40),
              device=cuda_device)
    prompt = np.arange(3, 40, dtype=np.int32)[None]
    with ContinuousBatchingEngine(cfg, params, **kw) as eng:
        want = [int(t[0]) for t in eng.generate_stream(prompt, 16)]
        assert eng.graph_replays > 0
    with ContinuousBatchingEngine(cfg, params, **kw) as eng:
        for k in (1, 8, 15):
            got = want[:k] + [int(t[0]) for t in eng.generate_stream(
                prompt, 16, resume={"delivered_tokens": want[:k],
                                    "rng_step_offset": k})]
            assert got == want, k
        assert eng.stats()["resumed"]["diverged"] == 0
        launches = pa.paged_flash_attention.launches
        assert launches > 0
