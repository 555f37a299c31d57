"""The torch port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
also runs on a machine with only PyTorch, without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,chunk,nh,nkv,hd,q_start,alibi", [
    (1, 64, 32, 4, 64, 0, False),       # TinyLlama heads, serve prefill
    (2, 37, 32, 4, 64, 100, False),     # ragged chunk after a prefix
    (1, 16, 16, 16, 64, 7, True),       # bloom-560m heads, ALiBi
    (1, 64, 32, 8, 128, 100, False),    # llama-3-8b heads, hd 128
    (1, 64, 8, 1, 256, 0, False),       # gemma-2b heads, hd 256
    (1, 64, 32, 32, 80, 0, True),       # bloom3b heads, hd 80, ALiBi
    (2, 37, 16, 16, 96, 100, True),     # bloom1b1 heads, hd 96, ALiBi
])
def test_cuda_kernel_matches_plain(cuda_device, dtype, atol, b, chunk, nh,
                                   nkv, hd, q_start, alibi):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((b, chunk, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kc = torch.randn((b, nkv, 300, hd), generator=gen,
                     device=cuda_device).to(dtype)
    vc = torch.randn((b, nkv, 300, hd), generator=gen,
                     device=cuda_device).to(dtype)
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    kv_len = q_start + chunk
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, kc, vc, q_start, kv_len, slopes)
    want = fa.flash_attention_plain(q, kc, vc, q_start, kv_len, slopes)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_engine_prefill_goes_through_the_kernel(cuda_device):
    """A small f32 llama (hd 64, the kernel's head dim) on the card: the
    "auto" engine launches the kernel once per layer per prefill and
    matches an engine on plain attention over the same weights."""
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3)
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    kern = InferenceEngine(cfg, params, max_seq=64, sampling=greedy,
                           device=cuda_device)
    plain = InferenceEngine(cfg, params, max_seq=64, sampling=greedy,
                            attn_backend="plain", device=cuda_device)
    assert kern.attn_backend == "flash"
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20))
    before = fa.flash_attention.launches
    got = kern.generate(ids, 8, logprobs=True)
    assert fa.flash_attention.launches == before + cfg.num_layers
    want = plain.generate(ids, 8, logprobs=True)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    np.testing.assert_allclose(kern.prefill_logits(ids),
                               plain.prefill_logits(ids), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_auto_backend_raises_on_a_head_dim_the_kernel_lacks(cuda_device):
    """Head dim 48, which no catalog model has: "auto" on the card
    refuses instead of running plain attention; "plain" is the explicit
    opt-in."""
    cfg = get_model_config("gemma-test").replace(head_dim_override=48)
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    with pytest.raises(ValueError, match="--attn-backend plain"):
        InferenceEngine(cfg, params, max_seq=64, device=cuda_device)
    plain = InferenceEngine(cfg, params, max_seq=64, attn_backend="plain",
                            device=cuda_device)
    assert plain.attn_backend == "plain"


def _paged_pool(gen, dev, dtype, lens, nkv, hd, bt, W):
    """Pages holding the live pages of ``lens`` (negative: a freed slot
    with an all-sentinel table) under shuffled ids; sentinels N, N + 7.
    ``dtype`` "int8": int8 pages quantized from f32 ones."""
    need = [-(-l // bt) if l > 0 else 0 for l in lens]
    N = sum(need) + 3
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(N))
    tables = torch.full((len(lens), W), N + 7, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[nxt:nxt + n].to(torch.int32)
        tables[i, n] = N
        nxt += n
    pk = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    pv = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    if dtype == "int8":
        return (quant.quantize_kv_pages(pk, 8),
                quant.quantize_kv_pages(pv, 8), tables.to(dev))
    return pk.to(dtype), pv.to(dtype), tables.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh,nkv,hd,alibi", [
    (32, 4, 64, False),       # TinyLlama heads
    (16, 16, 64, True),       # bloom-560m heads, ALiBi
    (32, 8, 128, False),      # llama-3-8b heads, hd 128
    (8, 1, 256, False),       # gemma-2b heads, hd 256
    (32, 32, 80, True),       # bloom3b heads, hd 80, ALiBi
    (16, 16, 96, True),       # bloom1b1 heads, hd 96, ALiBi
])
def test_paged_kernels_match_plain(cuda_device, dtype, atol, nh, nkv, hd,
                                   alibi):
    """Both paged kernels against their plain versions: ragged lengths
    (1, a page boundary, mid-page, long), freed slots, shuffled pages;
    prefill chunks from zero, mid-page and several pages in."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    bt, W = 16, 64
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    lens = [1, 16, 37, 1000, -300, 130]
    pk, pv, tables = _paged_pool(gen, cuda_device, dtype, lens, nkv, hd, bt,
                                 W)
    q = torch.randn((len(lens), 1, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=cuda_device)
    before = pa.paged_flash_attention.launches
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens, slopes)
    torch.cuda.synchronize()
    assert pa.paged_flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)
    for chunk, starts in ((16, [0, 7]), (64, [200, 3]), (37, [20, 0])):
        lens = [s + chunk for s in starts]
        pk, pv, tables = _paged_pool(gen, cuda_device, dtype, lens, nkv, hd,
                                     bt, W)
        q = torch.randn((len(starts), chunk, nh, hd), generator=gen,
                        device=cuda_device).to(dtype)
        pos = (torch.tensor(starts, device=cuda_device)[:, None]
               + torch.arange(chunk, device=cuda_device))
        before = pa.paged_prefill_attention.launches
        got = pa.paged_prefill_attention(q, pk, pv, tables, pos, slopes)
        want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos,
                                                slopes)
        torch.cuda.synchronize()
        assert pa.paged_prefill_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
def test_batching_engine_goes_through_the_paged_kernels(cuda_device):
    """A small f32 llama (hd 64) batching engine on the card: decode
    launches the decode kernel, chunked admission the prefill kernel,
    and the greedy tokens equal a plain-attention InferenceEngine's; the
    "plain" backend launches neither."""
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3)
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    plain = InferenceEngine(cfg, params, max_seq=128, sampling=greedy,
                            attn_backend="plain", device=cuda_device)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70))]
    want = [plain.generate([p], 8).tokens[0].tolist() for p in prompts]
    for backend in ("auto", "plain"):
        dec = pa.paged_flash_attention.launches
        pre = pa.paged_prefill_attention.launches
        with ContinuousBatchingEngine(
                cfg, params, max_seq=128, max_batch=4, sampling=greedy,
                kv_block_tokens=16, prefill_chunk=16, attn_backend=backend,
                device=cuda_device) as eng:
            got = [r.wait(timeout=120).tolist()
                   for r in [eng.submit(p, 8) for p in prompts]]
        assert got == want
        ran = (pa.paged_flash_attention.launches - dec,
               pa.paged_prefill_attention.launches - pre)
        if backend == "auto":
            assert min(ran) > 0 and ran[0] % cfg.num_layers == 0
        else:
            assert ran == (0, 0)


def _launches():
    return (pa.paged_flash_attention.launches,
            pa.paged_flash_attention.int8_launches,
            pa.paged_prefill_attention.launches,
            pa.paged_prefill_attention.int8_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh,nkv,hd,alibi", [
    (32, 4, 64, False),       # TinyLlama heads
    (16, 16, 64, True),       # bloom-560m heads, ALiBi
    (32, 8, 128, False),      # llama-3-8b heads, hd 128
    (8, 1, 256, False),       # gemma-2b heads, hd 256
    (32, 32, 80, True),       # bloom3b heads, hd 80, ALiBi
    (16, 16, 96, True),       # bloom1b1 heads, hd 96, ALiBi
])
def test_paged_int8_kernels_match_plain(cuda_device, dtype, atol, nh, nkv,
                                        hd, alibi):
    """Both kernels' int8 instances against their plain versions on the
    same int8 pages (q in f32 or bf16): ragged lengths, freed slots,
    prefill chunks from zero, mid-page and several pages in; each call
    counts one int8 launch and no full-width one."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    bt, W = 16, 64
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    lens = [1, 16, 37, 1000, -300, 130]
    pk, pv, tables = _paged_pool(gen, cuda_device, "int8", lens, nkv, hd,
                                 bt, W)
    q = torch.randn((len(lens), 1, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=cuda_device)
    before = _launches()
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens, slopes)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, *before[2:])
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)
    for chunk, starts in ((16, [0, 7]), (64, [200, 3]), (37, [20, 0])):
        lens = [s + chunk for s in starts]
        pk, pv, tables = _paged_pool(gen, cuda_device, "int8", lens, nkv,
                                     hd, bt, W)
        q = torch.randn((len(starts), chunk, nh, hd), generator=gen,
                        device=cuda_device).to(dtype)
        pos = (torch.tensor(starts, device=cuda_device)[:, None]
               + torch.arange(chunk, device=cuda_device))
        before = _launches()
        got = pa.paged_prefill_attention(q, pk, pv, tables, pos, slopes)
        want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos,
                                                slopes)
        torch.cuda.synchronize()
        assert _launches() == (*before[:3], before[3] + 1)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)
    int4 = quant.quantize_kv_pages(torch.zeros((4, nkv, bt, hd),
                                               device=cuda_device), 4)
    with pytest.raises(ValueError, match="int4 KV takes the gather path"):
        pa.paged_flash_attention(q[:, :1], int4, int4, tables, kv_lens[:2],
                                 slopes)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_paged_prefill_slab_matches_plain(cuda_device, pages, dtype, atol):
    """The mixed dispatch's slab through the prefill kernel: 4 rows of
    64-token chunks at distinct starts, the last an unused segment (all-
    sentinel table, start 0), which clamps its pages as a freed decode
    slot does."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    nh, nkv, hd, bt, W, chunk = 32, 4, 64, 16, 64, 64
    starts = [0, 64, 448, 0]
    pk, pv, tables = _paged_pool(gen, cuda_device,
                                 "int8" if pages == "int8" else dtype,
                                 [s + chunk for s in starts[:3]] + [-1],
                                 nkv, hd, bt, W)
    q = torch.randn((4, chunk, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    pos = (torch.tensor(starts, device=cuda_device)[:, None]
           + torch.arange(chunk, device=cuda_device))
    got = pa.paged_prefill_attention(q, pk, pv, tables, pos)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_mixed_int8_engine_goes_through_the_int8_kernels(cuda_device):
    """A small f32 llama (hd 64) mixed-dispatch engine over int8 pages on
    the card: decode launches the decode kernel's int8 instance L times a
    step, the slab the prefill kernel's, and the greedy tokens equal the
    same configuration on the gather ("plain") backend; an int4 pool
    gathers and launches nothing."""
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3)
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70))]
    kw = dict(max_seq=128, max_batch=4, sampling=greedy, kv_block_tokens=16,
              prefill_chunk=16, decode_block=4, mixed_token_budget=48,
              device=cuda_device)
    runs = {}
    for backend, kv_dtype in (("auto", "int8"), ("plain", "int8"),
                              ("auto", "int4")):
        with ContinuousBatchingEngine(cfg, params, attn_backend=backend,
                                      kv_dtype=kv_dtype, **kw) as eng:
            # counted from the built engine: building it runs one decode
            # step to warm up before capturing it as a CUDA graph
            before = _launches()
            got = [eng.submit(p, 8).wait(timeout=120).tolist()
                   for p in prompts]
            steps = eng.loop_stats["device_loop_steps"]
            slabs = eng.chunk_stats["mixed_slab_forwards"]
        ran = tuple(a - b for a, b in zip(_launches(), before))
        runs[backend, kv_dtype] = got
        if (backend, kv_dtype) == ("auto", "int8"):
            assert ran == (0, cfg.num_layers * steps, 0,
                           cfg.num_layers * slabs)
            assert steps > 0 and slabs > 0
        else:
            assert ran == (0, 0, 0, 0)
    assert runs["auto", "int8"] == runs["plain", "int8"]


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_paged_decode_split_boundaries(cuda_device, pages, dtype, atol):
    """Decode rows one key either side of the bf16 kernel's split
    boundaries, and two splits plus 9 keys, against the plain version
    (and, under bf16 q, the plain split arithmetic), TinyLlama heads."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k = pa.KV_SPLIT
    lens = [k - 1, k, k + 1, 2 * k + 9]
    pk, pv, tables = _paged_pool(gen, cuda_device,
                                 "int8" if pages == "int8" else dtype, lens,
                                 4, 64, 16, 64)
    q = torch.randn((len(lens), 1, 32, 64), generator=gen,
                    device=cuda_device).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens)
    want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)
    split = pa.paged_decode_split_plain(q, pk, pv, tables, kv_lens)
    torch.testing.assert_close(got.float(), split.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8"])
def test_paged_decode_is_batch_invariant(cuda_device, pages):
    """Each row of an 8-slot bf16 decode launch is bit-equal to the same
    row launched alone: split boundaries sit at fixed positions."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    lens = [1, 16, 37, 1000, 512, 130, -300, -5]
    pk, pv, tables = _paged_pool(
        gen, cuda_device, "int8" if pages == "int8" else torch.bfloat16,
        lens, 4, 64, 16, 64)
    q = torch.randn((len(lens), 1, 32, 64), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=cuda_device)
    batch = pa.paged_flash_attention(q, pk, pv, tables, kv_lens)
    for i in range(len(lens)):
        one = pa.paged_flash_attention(q[i:i + 1], pk, pv, tables[i:i + 1],
                                       kv_lens[i:i + 1])
        assert torch.equal(one, batch[i:i + 1]), f"row {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_paged_prefill_above_the_routing_cap(cuda_device, dtype, atol):
    """A 128-token chunk at TinyLlama heads is 1024 regrouped rows, above
    the reference's 512-row cap, which the routing keeps off the card; on
    the card the routing takes the kernel, which agrees with its plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    chunk, starts = 128, [200]
    pk, pv, tables = _paged_pool(gen, cuda_device, dtype,
                                 [s + chunk for s in starts], 4, 64, 16, 64)
    q = torch.randn((1, chunk, 32, 64), generator=gen,
                    device=cuda_device).to(dtype)
    pos = (torch.tensor(starts, device=cuda_device)[:, None]
           + torch.arange(chunk, device=cuda_device))
    assert pa.paged_route(True, chunk, 8, 16) == "gather"
    assert pa.paged_route(True, chunk, 8, 16, max_rows=None) == "prefill"
    got = pa.paged_prefill_attention(q, pk, pv, tables, pos)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


def _flash_inputs(gen, dev, dtype, b, chunk, nh, nkv, hd, max_seq=320):
    return (torch.randn((b, chunk, nh, hd), generator=gen,
                        device=dev).to(dtype),
            torch.randn((b, nkv, max_seq, hd), generator=gen,
                        device=dev).to(dtype),
            torch.randn((b, nkv, max_seq, hd), generator=gen,
                        device=dev).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [16, 64])
@pytest.mark.parametrize("b,chunk,nh,nkv,hd,q_start,alibi", [
    (1, 37, 16, 16, 64, 7, True),       # g = 1, ragged rows, ALiBi
    (2, 48, 32, 8, 128, 100, False),    # g = 4, hd 128, after a prefix
    (1, 200, 32, 4, 64, 0, False),      # g = 8, 1600 rows: many tiles
    (1, 64, 32, 4, 64, 250, True),      # g = 8 past several tiles, ALiBi
    (1, 64, 8, 1, 256, 0, False),       # gemma-2b heads, hd 256
    (1, 100, 8, 1, 256, 150, False),    # hd 256, several tiles
    (1, 37, 32, 32, 80, 7, True),       # bloom3b heads, hd 80, ragged
    (2, 40, 16, 16, 96, 100, True),     # bloom1b1 heads, hd 96
])
def test_flash_bf16_instances_match_plain(cuda_device, rows_per_block, b,
                                          chunk, nh, nkv, hd, q_start,
                                          alibi):
    """Each bf16 instance, launched directly, against the plain version
    wherever the wrapper's rule would send the shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, kc, vc = _flash_inputs(gen, cuda_device, torch.bfloat16, b, chunk,
                              nh, nkv, hd)
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    kv_len = q_start + chunk
    fa._check_cuda_args(q, kc, vc, q_start, kv_len, slopes)
    before = (fa.flash_attention.launches, fa.flash_attention.wide_launches)
    got = fa._launch(q, kc, vc, q_start, kv_len, slopes, rows_per_block)
    want = fa.flash_attention_plain(q, kc, vc, q_start, kv_len, slopes)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention.wide_launches) == (
        before[0] + 1, before[1] + (rows_per_block == 64))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("side", [-1, 0])
def test_flash_either_side_of_the_threshold(cuda_device, dtype, atol, side):
    """TinyLlama heads at the chunk just below (side -1) and at (0) the
    first chunk whose 64-row blocks fill one wave of this card's SMs: the
    wrapper takes the instance its rule names (f32: its one kernel) and
    agrees with the plain version."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    b, nh, nkv, hd, g = 1, 32, 4, 64, 8
    chunk = (-(-sms // (b * nkv)) - 1) * 64 // g + 1 + side  # 256, 257
    rule = fa.flash_rows_per_block(b, nkv, chunk * g, sms)
    assert rule == (64 if side == 0 else 16)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, kc, vc = _flash_inputs(gen, cuda_device, dtype, b, chunk, nh, nkv, hd)
    wide = fa.flash_attention.wide_launches
    got = fa.flash_attention(q, kc, vc, 0, chunk)
    want = fa.flash_attention_plain(q, kc, vc, 0, chunk)
    torch.cuda.synchronize()
    took_wide = fa.flash_attention.wide_launches - wide
    assert took_wide == (dtype == torch.bfloat16 and rule == 64)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_engine_long_prompt_takes_the_wide_instance(cuda_device):
    """A small bf16 llama (hd 64, g = 2): a prompt long enough for 64-row
    blocks to fill this card moves ``wide_launches`` by one a layer, a
    short one leaves it; the logits stay near a plain-attention engine's
    on the same weights."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3,
        dtype_name="bfloat16")
    b, nkv, g = 2, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    plen = -(-sms // (b * nkv)) * 64 // g + 5
    assert fa.flash_rows_per_block(b, nkv, plen * g, sms) == 64
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    kern = InferenceEngine(cfg, params, max_seq=plen + 8, sampling=greedy,
                           device=cuda_device)
    plain = InferenceEngine(cfg, params, max_seq=plen + 8, sampling=greedy,
                            attn_backend="plain", device=cuda_device)
    rng = np.random.RandomState(3)
    for n, wide in ((plen, cfg.num_layers), (16, 0)):
        ids = rng.randint(0, cfg.vocab_size, (b, n))
        before = (fa.flash_attention.launches,
                  fa.flash_attention.wide_launches)
        got = kern.prefill_logits(ids)
        assert (fa.flash_attention.launches,
                fa.flash_attention.wide_launches) == (
            before[0] + cfg.num_layers, before[1] + wide)
        want = plain.prefill_logits(ids)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 5e-2 * max(1.0,
                                                     np.abs(want).max())


def _shaped(name):
    """Three-layer f32 models with a catalog model's head geometry:
    gemma-2b's (8 q heads on 1 kv head, hd 256; GeGLU, embedding scale)
    and bloom3b's (hd 80, one kv head per q head, ALiBi)."""
    if name == "gemma-2b":
        return get_model_config("gemma-test").replace(
            hidden_size=256, num_heads=8, num_kv_heads=1,
            head_dim_override=256, intermediate_size=512, num_layers=3,
            max_seq_len=256)
    return get_model_config("bloom-test").replace(
        hidden_size=640, num_heads=8, num_kv_heads=8, intermediate_size=512,
        num_layers=3, max_seq_len=256)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma-2b", "bloom3b"])
def test_engines_take_the_kernels_at_the_new_head_dims(cuda_device, name):
    """gemma-2b- and bloom3b-shaped f32 models on the card: "auto"
    resolves to the kernels; the plain engine's prefill launches the
    flash kernel, the batching engine the paged kernels, the mixed one
    over int8 pages their int8 instances; the greedy tokens equal the
    same engines' on plain attention / the gather path."""
    cfg = _shaped(name)
    assert cfg.head_dim == (256 if name == "gemma-2b" else 80)
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    L = cfg.num_layers
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70))]
    kern = InferenceEngine(cfg, params, max_seq=128, sampling=greedy,
                           device=cuda_device)
    plain = InferenceEngine(cfg, params, max_seq=128, sampling=greedy,
                            attn_backend="plain", device=cuda_device)
    assert kern.attn_backend == "flash"
    before = fa.flash_attention.launches
    got = [kern.generate([p], 8).tokens[0].tolist() for p in prompts]
    # the hook's prefills of 16 tokens or more launch the kernel
    assert fa.flash_attention.launches == before + L * sum(
        len(p) >= 16 for p in prompts)
    want = [plain.generate([p], 8).tokens[0].tolist() for p in prompts]
    assert got == want
    kw = dict(max_seq=128, max_batch=4, sampling=greedy, kv_block_tokens=16,
              prefill_chunk=16, device=cuda_device)
    before = _launches()
    with ContinuousBatchingEngine(cfg, params, **kw) as eng:
        got = [r.wait(timeout=120).tolist()
               for r in [eng.submit(p, 8) for p in prompts]]
    ran = tuple(a - b for a, b in zip(_launches(), before))
    assert got == want
    assert ran[0] > 0 and ran[0] % L == 0 and ran[2] > 0
    assert ran[1] == ran[3] == 0
    mixed = dict(kw, decode_block=4, mixed_token_budget=48, kv_dtype="int8")
    runs = {}
    for backend in ("auto", "plain"):
        with ContinuousBatchingEngine(cfg, params, attn_backend=backend,
                                      **mixed) as eng:
            # counted from the built engine, as above
            before = _launches()
            runs[backend] = [eng.submit(p, 8).wait(timeout=120).tolist()
                             for p in prompts]
            steps = eng.loop_stats["device_loop_steps"]
            slabs = eng.chunk_stats["mixed_slab_forwards"]
        ran = tuple(a - b for a, b in zip(_launches(), before))
        if backend == "auto":
            assert ran == (0, L * steps, 0, L * slabs)
            assert steps > 0 and slabs > 0
        else:
            assert ran == (0, 0, 0, 0)
    assert runs["auto"] == runs["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8"])
def test_slab_and_bucket_padded_final_share_the_prefill_kernel(cuda_device,
                                                                pages):
    """A prompt's last 36 tokens at 64, in bf16 at TinyLlama heads, as the
    two admission orders run them: the serialized admission pads them to
    the 128-token bucket (1024 rows, above the reference's cap), the
    mixed dispatch puts them in row 0 of a 4 x 64 slab beside other rows.
    On the card the paged hook routes both to the prefill kernel (before,
    the padded chunk gathered), and the kernel's rows do not depend on the
    chunk's length or the other rows: the real tokens' outputs are the
    same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    nh, nkv, hd, bt, W, start, n = 32, 4, 64, 16, 64, 64, 36
    need = -(-(start + 128) // bt)
    N = need + 2                       # pages a table may name; N drops
    tables = torch.full((1, W), N, dtype=torch.int32)
    tables[0, :need] = torch.randperm(
        N, generator=torch.Generator().manual_seed(N))[:need]
    tables = tables.to(cuda_device)

    def pool():
        x = torch.randn((N + 1, nkv, bt, hd), generator=gen,
                        device=cuda_device)
        return (x.to(torch.bfloat16) if pages == "full"
                else quant.quantize_kv_pages(x, 8))

    k_pool, v_pool = pool(), pool()
    impl, bind = pa.make_paged_attn_impl(bt, "auto", num_pages=N,
                                         head_dim=hd, device_type="cuda")
    q = torch.randn((1, 128, nh, hd), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kv = torch.randn((1, 128, nkv, hd), generator=gen,
                     device=cuda_device).to(torch.bfloat16)

    def run(q_, kv_, tables_, starts):
        bind(tables_)
        pos = (torch.tensor(starts, device=cuda_device)[:, None]
               + torch.arange(q_.shape[1], device=cuda_device))
        before = _launches()
        out, _, _ = impl(q_, kv_, kv_, k_pool, v_pool, pos, 0, None)
        ran = tuple(a - b for a, b in zip(_launches(), before))
        assert ran == ((0, 0, 1, 0) if pages == "full" else (0, 0, 0, 1))
        return out

    serial = run(q, kv, tables, [start])
    slab_q = torch.randn((4, 64, nh, hd), generator=gen,
                         device=cuda_device).to(torch.bfloat16)
    slab_kv = torch.zeros((4, 64, nkv, hd), dtype=torch.bfloat16,
                          device=cuda_device)
    slab_q[0], slab_kv[0] = q[0, :64], kv[0, :64]
    slab_tables = torch.full((4, W), N, dtype=torch.int32,
                             device=cuda_device)
    slab_tables[0] = tables[0]
    slab = run(slab_q, slab_kv, slab_tables, [start, 0, 0, 0])
    torch.cuda.synchronize()
    assert torch.equal(slab[0, :n], serial[0, :n])


def _small_llama(cuda_device, dtype: str):
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3,
        dtype_name=dtype)
    return cfg, init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)


GRAPH_CASES = [("float32", "greedy"), ("float32", "sampled"),
               ("bfloat16", "greedy")]


def _sampling(mode: str) -> SamplingParams:
    return (SamplingParams(greedy=True) if mode == "greedy"
            else SamplingParams(temperature=0.8, top_k=5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mode", GRAPH_CASES)
def test_engine_graph_replay_equals_eager(cuda_device, dtype, mode):
    """``InferenceEngine`` on the card: the decode steps replayed from
    the captured graph give the tokens and logprobs of the same step run
    eagerly (``cuda_graph=False``), bit for bit, through ``generate`` and
    ``generate_stream`` at ``stream_block`` 1 and 4, over two calls of
    different prompt lengths; every step of the graph engine is a replay."""
    cfg, params = _small_llama(cuda_device, dtype)
    ids = [np.random.RandomState(i).randint(0, cfg.vocab_size, (2, n))
           for i, n in ((0, 40), (1, 13))]
    runs = {}
    for flag in (True, False):
        eng = InferenceEngine(cfg, params, max_seq=128,
                              sampling=_sampling(mode), device=cuda_device,
                              cuda_graph=flag)
        out = []
        for x in ids:
            res = eng.generate(x, 12, seed=3, logprobs=True)
            out += [res.tokens, res.logprobs]
            for k in (1, 4):
                eng.stream_block = k
                items = list(eng.generate_stream(x, 12, seed=5,
                                                 logprobs=True))
                out += [np.stack([t for t, _ in items]),
                        np.stack([lp for _, lp in items])]
        runs[flag] = (out, eng.graph_replays,
                      eng.loop_stats["device_loop_steps"])
    (got, replays, steps), (want, eager_replays, eager_steps) = (
        runs[True], runs[False])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert replays == steps == eager_steps == 6 * 12
    assert eager_replays == 0


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(),
    dict(decode_block=4),
    dict(prefill_chunk=16, decode_block=4, mixed_token_budget=32,
         kv_dtype="int8"),
], ids=["step", "fused", "mixed-int8"])
@pytest.mark.parametrize("dtype,mode", GRAPH_CASES)
def test_batching_graph_replay_equals_eager(cuda_device, dtype, mode,
                                            extra):
    """``ContinuousBatchingEngine`` on the card, lockstep, fused and the
    decode half of the mixed dispatch over int8 pages: tokens and
    logprobs of the replayed graph equal the eager step's bit for bit;
    replays equal the decode steps run; the paged decode kernel's launch
    count under replay equals the eager count and L per decode step.
    Greedy requests are submitted together, sampled ones one after
    another (the generator's draws follow the schedule)."""
    cfg, params = _small_llama(cuda_device, dtype)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70, 5))]
    int8 = extra.get("kv_dtype") == "int8"
    runs = {}
    for flag in (True, False):
        with ContinuousBatchingEngine(
                cfg, params, max_seq=128, max_batch=4,
                sampling=_sampling(mode), kv_block_tokens=16,
                prompt_buckets=(16, 64), device=cuda_device,
                cuda_graph=flag, **extra) as eng:
            before = _launches()
            if mode == "greedy":
                reqs = [eng.submit(p, 10) for p in prompts]
                for r in reqs:
                    r.wait(timeout=120)
            else:
                reqs = []
                for p in prompts:
                    reqs.append(eng.submit(p, 10))
                    reqs[-1].wait(timeout=120)
            ran = [a - b for a, b in zip(_launches(), before)]
            runs[flag] = ([r.tokens for r in reqs], [r.lps for r in reqs],
                          ran[1 if int8 else 0], eng.graph_replays,
                          eng.loop_stats["device_loop_steps"])
    toks, lps, launches, replays, steps = runs[True]
    e_toks, e_lps, e_launches, e_replays, e_steps = runs[False]
    assert toks == e_toks
    np.testing.assert_array_equal(np.concatenate(lps),
                                  np.concatenate(e_lps))
    assert replays == steps > 0 and e_replays == 0
    assert launches == cfg.num_layers * steps
    assert e_launches == cfg.num_layers * e_steps
    if mode == "sampled":
        assert steps == e_steps and launches == e_launches


def _quant_weight(bits, k, n, gen, device):
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    return (quant.quantize_array(w) if bits == 8
            else quant.quantize_array4(w))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [
    (1, 2048, 256),     # TinyLlama's wk at decode: split K
    (37, 512, 272),     # ragged rows and a partial column tile
] + [(m, k, n) for k, n in ((2048, 256), (512, 272), (2048, 5632))
     for m in (8, 16, 17, 64, 256)] + [
    (1, 512, 272), (1, 2048, 5632)])   # TinyLlama's w_up
def test_quant_dense_matches_plain(cuda_device, bits, dtype, atol, m, k, n):
    """The dequantizing dense kernels against ``x @ w.dequantize(x.dtype)``
    on the same codes: one launch a call (bf16 up to 16 rows the decode
    kernel's, above the prefill kernel's), f32 exact up to summation
    order, bf16 within the output's rounding."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    gen = torch.Generator(device=cuda_device).manual_seed(bits + m)
    wq = _quant_weight(bits, k, n, gen, cuda_device)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    before = qd.quant_dense.launches
    before_dec = qd.quant_dense.decode_launches
    got = qd.quant_dense(x, wq)
    want = qd.quant_dense_plain(x, wq)
    torch.cuda.synchronize()
    assert qd.quant_dense.launches == before + 1
    decode = dtype == torch.bfloat16 and m <= qd.DECODE_MAX_ROWS
    assert qd.quant_dense.decode_launches == before_dec + int(decode)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(2048, 256), (2048, 5632), (4096, 1024)])
def test_quant_decode_row_bit_equal_across_m(cuda_device, bits, k, n):
    """The decode kernel's split depends on no M and each row is its own
    n8 column: every row of an 8- and a 16-row launch equals the same row
    launched alone, bit for bit."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    wq = _quant_weight(bits, k, n, gen, cuda_device)
    x = torch.randn((16, k), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    y16 = qd.quant_dense(x, wq)
    y8 = qd.quant_dense(x[:8], wq)
    for r in range(16):
        y1 = qd.quant_dense(x[r:r + 1], wq)
        assert torch.equal(y1[0], y16[r])
        if r < 8:
            assert torch.equal(y1[0], y8[r])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [
    (1, 2048, 256),     # decode kernel, 32 / 16 splits
    (8, 4096, 1024),    # decode kernel, the 8-slot batch
    (64, 4096, 512),    # prefill kernel, split K
    (256, 4096, 512),   # prefill kernel, two row tiles, split K
])
def test_quant_dense_graph_replay_bit_equal(cuda_device, bits, m, k, n):
    """A product captured in a CUDA graph and replayed 20 times equals
    the eager launch bit for bit at every replay: the split-arrival
    counters are back at 0 after each launch."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    gen = torch.Generator(device=cuda_device).manual_seed(bits + m)
    wq = _quant_weight(bits, k, n, gen, cuda_device)
    x = torch.randn((m, k), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kernel = qd.route(m, x.dtype)
    assert qd.splits_for(kernel, m, k, n, bits, qd._sm_count(x.device)) > 1
    eager = qd.quant_dense(x, wq)
    graph = torch.cuda.CUDAGraph()
    # a capture owns its counters (outside a scope it raises)
    with qd.counters_scope(qd.new_counters(x.device)) as counters, \
            torch.cuda.graph(graph):
        out = qd.quant_dense(x, wq)
    for _ in range(20):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert int(counters.abs().sum()) == 0
    assert int(qd.arrival_counters(x.device).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_engine_graph_replay_equals_eager(cuda_device, mode):
    """A small bf16 llama with int8 / int4 weights on the card: every
    quantized matmul launches the dense kernel (7 a layer a forward,
    under replay too), the replayed decode equals the eager one bit for
    bit, and the greedy tokens follow the float twin whose weights are
    the same codes dequantized."""
    from distributed_inference_demo_tpu_torch.models.base import StageParams
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    cfg = get_model_config(f"llama-test-{mode}").replace(
        hidden_size=256, intermediate_size=512, num_layers=3,
        dtype_name="bfloat16")
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device,
        quantize=True)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20))
    runs = {}
    for flag in (True, False):
        eng = InferenceEngine(cfg, params, max_seq=64,
                              sampling=SamplingParams(greedy=True),
                              device=cuda_device, cuda_graph=flag)
        eng.generate(ids, 2)                     # captures, warms
        before = qd.quant_dense.launches
        s0 = eng.loop_stats["device_loop_steps"]
        res = eng.generate(ids, 10, logprobs=True)
        steps = eng.loop_stats["device_loop_steps"] - s0
        assert qd.quant_dense.launches - before == 7 * 3 * (1 + steps)
        runs[flag] = res
    np.testing.assert_array_equal(runs[True].tokens, runs[False].tokens)
    np.testing.assert_array_equal(runs[True].logprobs, runs[False].logprobs)
    twin = StageParams(
        layers={k: v.dequantize(cfg.dtype) if isinstance(
            v, quant.AnyQuantized) else v for k, v in params.layers.items()},
        embed=params.embed, final_norm=params.final_norm,
        lm_head=params.lm_head)
    eng = InferenceEngine(cfg, twin, max_seq=64,
                          sampling=SamplingParams(greedy=True),
                          device=cuda_device)
    lk = InferenceEngine(cfg, params, max_seq=64, device=cuda_device,
                         sampling=SamplingParams(greedy=True)
                         ).prefill_logits(ids)
    lt = eng.prefill_logits(ids)
    assert np.abs(lk - lt).max() <= 5e-2 * max(1.0, np.abs(lt).max())


def _small_mixtral(cuda_device, mode: str):
    """``mixtral-test`` (4 experts, top 2) widened to the kernels' shapes
    (hd 64, K % 64 == 0), bf16, float or int8 / int4 experts."""
    name = "mixtral-test" + ("" if mode == "float" else f"-{mode}")
    cfg = get_model_config(name).replace(
        hidden_size=256, intermediate_size=512, dtype_name="bfloat16")
    return cfg, init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device,
        quantize=mode != "float")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 40])
def test_expert_dense_launches_the_kernel_per_expert(cuda_device, bits, m):
    """One layer's [E, K, N] quantized stack on the card: each expert's
    plane of ``dense`` equals that expert's own 2-D kernel product bit
    for bit (int8 takes the scale row all experts share), E launches."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    w = torch.randn((1, 4, 256, 512), generator=gen,
                    device=cuda_device) * 256 ** -0.5
    qw = (quant.quantize_array(w, stacked=True) if bits == 8
          else quant.quantize_array4(w))[0]
    x = torch.randn((1, m, 256), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    before = qd.quant_dense.launches
    got = quant.dense(x, qw, "bsh,ehi->besi")
    assert qd.quant_dense.launches - before == 4
    for e in range(4):
        want = qd.quant_dense(x[0], quant.expert_weight(qw, e))
        assert torch.equal(got[0, e], want)
    torch.testing.assert_close(
        got.float(), torch.einsum("bsh,ehi->besi", x.float(),
                                  qw.dequantize(torch.float32)),
        atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_chunk", [None, 16])
@pytest.mark.parametrize("mode", ["float", "int8", "int4"])
def test_mixtral_engine_graph_replay_equals_eager(cuda_device, mode,
                                                  prefill_chunk):
    """A small bf16 mixtral on the card, whole and chunked prefill (three
    16-token chunks, each through the flash kernel): the replayed decode
    equals the eager one bit for bit (the MoE routing has no
    data-dependent shape, so the step captures); quantized, every
    forward makes (4 + 3 E) x L dense launches, each decode step
    (4 + 3 E) x L of the decode kernel, under replay too."""
    from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
    cfg, params = _small_mixtral(cuda_device, mode)
    L = cfg.num_layers
    per_fwd = 0 if mode == "float" else (4 + 3 * cfg.num_experts) * L
    prefills = 1 if prefill_chunk is None else 3
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 48))
    runs = {}
    for flag in (True, False):
        eng = InferenceEngine(cfg, params, max_seq=96,
                              sampling=SamplingParams(greedy=True),
                              device=cuda_device, cuda_graph=flag,
                              prefill_chunk=prefill_chunk)
        eng.generate(ids, 2)                     # captures, warms
        before = (qd.quant_dense.launches, qd.quant_dense.decode_launches,
                  fa.flash_attention.launches)
        s0, r0 = eng.loop_stats["device_loop_steps"], eng.graph_replays
        res = eng.generate(ids, 10, logprobs=True)
        steps = eng.loop_stats["device_loop_steps"] - s0
        assert fa.flash_attention.launches - before[2] == L * prefills
        assert qd.quant_dense.launches - before[0] == per_fwd * (
            prefills + steps)
        assert qd.quant_dense.decode_launches - before[1] == per_fwd * steps
        assert eng.graph_replays - r0 == (steps if flag else 0)
        runs[flag] = res
    np.testing.assert_array_equal(runs[True].tokens, runs[False].tokens)
    np.testing.assert_array_equal(runs[True].logprobs, runs[False].logprobs)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(),
    dict(prefill_chunk=16, decode_block=4, mixed_token_budget=32,
         kv_dtype="int8"),
], ids=["step", "mixed-int8"])
def test_mixtral_batching_graph_replay_equals_eager(cuda_device, extra):
    """A small bf16 mixtral in ``ContinuousBatchingEngine`` on the card:
    greedy tokens and logprobs of the replayed step equal the eager
    step's bit for bit; the paged decode kernel launches L times a decode
    step."""
    cfg, params = _small_mixtral(cuda_device, "float")
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70, 5))]
    int8 = extra.get("kv_dtype") == "int8"
    runs = {}
    for flag in (True, False):
        with ContinuousBatchingEngine(
                cfg, params, max_seq=128, max_batch=4,
                sampling=SamplingParams(greedy=True), kv_block_tokens=16,
                prompt_buckets=(16, 64), device=cuda_device,
                cuda_graph=flag, **extra) as eng:
            before = _launches()
            reqs = [eng.submit(p, 10) for p in prompts]
            for r in reqs:
                r.wait(timeout=120)
            ran = [a - b for a, b in zip(_launches(), before)]
            runs[flag] = ([r.tokens for r in reqs], [r.lps for r in reqs],
                          ran[1 if int8 else 0], eng.graph_replays,
                          eng.loop_stats["device_loop_steps"])
    toks, lps, launches, replays, steps = runs[True]
    e_toks, e_lps, e_launches, e_replays, e_steps = runs[False]
    assert toks == e_toks
    np.testing.assert_array_equal(np.concatenate(lps),
                                  np.concatenate(e_lps))
    assert replays == steps > 0 and e_replays == 0
    assert launches == cfg.num_layers * steps
    assert e_launches == cfg.num_layers * e_steps


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_paged_prefill_verify_shape_matches_plain(cuda_device, pages, dtype,
                                                  atol):
    """The speculative verify through the prefill kernel: 8 rows of K + 1
    = 5 tokens at per-row starts from 20 to 1999 (TinyLlama heads,
    16-token pages), the last a freed slot (all-sentinel table, start
    0), on each page type."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    nh, nkv, hd, bt, chunk = 32, 4, 64, 16, 5
    W = 2048 // bt
    starts = [20, 150, 300, 600, 1000, 1500, 1999, 0]
    lens = [s + chunk for s in starts[:7]] + [-1]
    if pages == "fp8":
        pk, pv, tables = _paged_pool(gen, cuda_device, torch.float32, lens,
                                     nkv, hd, bt, W)
        pk, pv = quant.cast_kv(pk, quant.FLOAT8), quant.cast_kv(pv,
                                                                quant.FLOAT8)
    else:
        pk, pv, tables = _paged_pool(gen, cuda_device,
                                     "int8" if pages == "int8" else dtype,
                                     lens, nkv, hd, bt, W)
    q = torch.randn((8, chunk, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    pos = (torch.tensor(starts, device=cuda_device)[:, None]
           + torch.arange(chunk, device=cuda_device))
    got = pa.paged_prefill_attention(q, pk, pv, tables, pos)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mode", GRAPH_CASES)
def test_speculative_engines_graph_replay_equals_eager(cuda_device, dtype,
                                                       mode):
    """``SpeculativeEngine`` (a 1-layer draft) and ``PromptLookupEngine``
    on the card: rounds replayed from the captured graph give the tokens
    and stats of the same round run eagerly, bit for bit; every round of
    the graph engine is a replay; greedy tokens equal the plain
    engine's at f32."""
    from distributed_inference_demo_tpu_torch.runtime.prompt_lookup import \
        PromptLookupEngine
    from distributed_inference_demo_tpu_torch.runtime.speculative import \
        SpeculativeEngine
    cfg, params = _small_llama(cuda_device, dtype)
    dcfg = cfg.replace(num_layers=1)
    dparams = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(1), dcfg,
        cuda_device)
    motif = np.random.RandomState(0).randint(0, cfg.vocab_size, 16)
    ids = np.tile(motif, (2, 3))
    runs = {}
    for flag in (True, False):
        kw = dict(max_seq=128, sampling=_sampling(mode), device=cuda_device,
                  cuda_graph=flag)
        out = []
        for eng in (SpeculativeEngine(cfg, params, dcfg, dparams, **kw),
                    PromptLookupEngine(cfg, params, **kw)):
            res, st = eng.generate(ids, 20, seed=3)
            out.append((res.tokens.tolist(), vars(st),
                        np.stack(list(eng.generate_stream(ids, 20, seed=3)),
                                 1).tolist(), eng.graph_replays))
        runs[flag] = out
    for (t, st, s, replays), (et, est, es, e_replays) in zip(runs[True],
                                                             runs[False]):
        assert t == et and st == est and s == es
        assert replays >= st["rounds"] > 0 and e_replays == 0
    if dtype == "float32" and mode == "greedy":
        plain = InferenceEngine(cfg, params, max_seq=128,
                                sampling=_sampling(mode), device=cuda_device)
        want = plain.generate(ids, 20).tokens.tolist()
        assert all(t == want for t, _, _, _ in runs[True])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(prompt_lookup=True, decode_block=3),
    dict(draft=True, decode_block=3),
    dict(prompt_lookup=True, prefill_chunk=16, decode_block=4,
         mixed_token_budget=40, kv_dtype="int8"),
    dict(draft=True, prefill_chunk=16, decode_block=4,
         mixed_token_budget=40),
], ids=["pld", "draft", "pld-mixed-int8", "draft-mixed"])
@pytest.mark.parametrize("dtype,mode", GRAPH_CASES)
def test_spec_batching_graph_replay_equals_eager(cuda_device, dtype, mode,
                                                 extra):
    """The batching engine's proposers on the card, serialized and mixed:
    tokens of the replayed round graphs equal the eager rounds' bit for
    bit (requests one after another, so both sample the same schedule);
    the draft's decode-kernel launches equal L_d x (k + 1) a round of
    width k, the prefill kernel takes at least the verify's L a round,
    under replay and eager alike."""
    cfg, params = _small_llama(cuda_device, dtype)
    extra = dict(extra)
    if extra.pop("draft", False):
        dcfg = cfg.replace(num_layers=1)
        extra.update(draft_cfg=dcfg, draft_params=init_full_params(
            torch.Generator(device=cuda_device).manual_seed(1), dcfg,
            cuda_device))
    int8 = extra.get("kv_dtype") == "int8"
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 5))]
    runs = {}
    for flag in (True, False):
        with ContinuousBatchingEngine(
                cfg, params, max_seq=128, max_batch=4,
                sampling=_sampling(mode), kv_block_tokens=16,
                prompt_buckets=(16, 64), num_draft=3, device=cuda_device,
                cuda_graph=flag, **extra) as eng:
            eng.submit([1, 2, 3], 2).wait(timeout=120)      # warm
            eng.reset_stats()
            before = _launches()
            toks = [eng.submit(p, 10).wait(timeout=120).tolist()
                    for p in prompts]
            ran = [a - b for a, b in zip(_launches(), before)]
            rbw = dict(eng.rounds_by_width)
            draft_l = extra["draft_cfg"].num_layers if "draft_cfg" in \
                extra else 0
            decode, prefill = ran[1 if int8 else 0], ran[3 if int8 else 2]
            assert decode == draft_l * sum((k + 1) * n
                                           for k, n in rbw.items())
            assert prefill >= cfg.num_layers * sum(rbw.values()) > 0
            runs[flag] = (toks, eng.graph_replays > 0, rbw, decode, prefill)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] and not runs[False][1]
    assert runs[True][2:] == runs[False][2:]
