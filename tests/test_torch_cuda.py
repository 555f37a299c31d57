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
    """gemma's head dim 256: "auto" on the card refuses instead of
    running plain attention; "plain" is the explicit opt-in."""
    cfg = get_model_config("gemma-test").replace(head_dim_override=256)
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
        before = _launches()
        with ContinuousBatchingEngine(cfg, params, attn_backend=backend,
                                      kv_dtype=kv_dtype, **kw) as eng:
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
