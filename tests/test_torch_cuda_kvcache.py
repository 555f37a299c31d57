"""The KV options of the torch port on a card: float8 e4m3 pages through
the paged kernels' e4m3 instances, the float8 cast, and the
``InferenceEngine`` prefix pool.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch, without the repo's conftest:

    python -m pytest tests/test_torch_cuda_kvcache.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import KVCache
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.quant import FLOAT8, cast_kv
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

GREEDY = SamplingParams(greedy=True)
HEADS = [
    (32, 4, 64, False),       # TinyLlama heads
    (16, 16, 64, True),       # bloom-560m heads, ALiBi
    (32, 8, 128, False),      # llama-3-8b heads, hd 128
    (8, 1, 256, False),       # gemma-2b heads, hd 256
    (32, 32, 80, True),       # bloom3b heads, hd 80, ALiBi
    (16, 16, 96, True),       # bloom1b1 heads, hd 96, ALiBi
]
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _counts():
    return tuple(getattr(w, n) for w in (pa.paged_flash_attention,
                                         pa.paged_prefill_attention)
                 for n in ("launches", "int8_launches", "fp8_launches"))


def _fp8_pool(gen, dev, lens, nkv, hd, bt, W):
    """float8 pages holding the live pages of ``lens`` (negative: a freed
    slot with an all-sentinel table) under shuffled ids; sentinels N and
    N + 7."""
    need = [-(-l // bt) if l > 0 else 0 for l in lens]
    N = sum(need) + 3
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(N))
    tables = torch.full((len(lens), W), N + 7, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[nxt:nxt + n].to(torch.int32)
        tables[i, n] = N
        nxt += n
    pk, pv = (cast_kv(torch.randn((N, nkv, bt, hd), generator=gen,
                                  device=dev), FLOAT8) for _ in range(2))
    return pk, pv, tables.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp8_cast_on_the_card_equals_the_cpu_cast(cuda_device, dtype):
    """``cast_kv`` gives the same codes on the card as on the CPU: past
    464, +-inf and NaN to NaN with the sign, 448-464 to +-448,
    subnormals rounded to nearest even."""
    edge = torch.tensor([449, 464, 465, 500, 1e6, -1e6, float("inf"),
                         -float("inf"), float("nan"), 448, -447, 2 ** -9,
                         2 ** -10, 3 * 2 ** -11, -3 * 2 ** -11, 0.0, -0.0])
    gen = torch.Generator().manual_seed(0)
    scale = torch.tensor([1e-3, 1.0, 30.0, 300.0])[
        torch.randint(0, 4, (200000,), generator=gen)]
    x = torch.cat([edge, torch.randn(200000, generator=gen) * scale])
    x = x.to(dtype)
    cpu = cast_kv(x, FLOAT8).view(torch.uint8)
    card = cast_kv(x.to(cuda_device), FLOAT8).view(torch.uint8).cpu()
    assert torch.equal(cpu, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("nh,nkv,hd,alibi", HEADS)
def test_paged_fp8_kernels_match_plain(cuda_device, dtype, atol, nh, nkv,
                                       hd, alibi):
    """Both kernels' e4m3 instances against their plain versions on the
    same float8 pages (q in f32 or bf16): ragged lengths, freed slots,
    prefill chunks from zero, mid-page and several pages in; each call
    counts one fp8 launch and no other."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    bt, W = 16, 64
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    lens = [1, 16, 37, 1000, -300, 130]
    pk, pv, tables = _fp8_pool(gen, cuda_device, lens, nkv, hd, bt, W)
    q = torch.randn((len(lens), 1, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=cuda_device)
    before = _counts()
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens, slopes)
    torch.cuda.synchronize()
    assert _counts() == (*before[:2], before[2] + 1, *before[3:])
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)
    for chunk, starts in ((16, [0, 7]), (64, [200, 3]), (37, [20, 0])):
        pk, pv, tables = _fp8_pool(gen, cuda_device,
                                   [s + chunk for s in starts], nkv, hd, bt,
                                   W)
        q = torch.randn((len(starts), chunk, nh, hd), generator=gen,
                        device=cuda_device).to(dtype)
        pos = (torch.tensor(starts, device=cuda_device)[:, None]
               + torch.arange(chunk, device=cuda_device))
        before = _counts()
        got = pa.paged_prefill_attention(q, pk, pv, tables, pos, slopes)
        want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos,
                                                slopes)
        torch.cuda.synchronize()
        assert _counts() == (*before[:5], before[5] + 1)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_paged_fp8_split_boundaries_and_slab(cuda_device, dtype, atol):
    """Decode rows one key either side of the split boundaries (and the
    plain split arithmetic under bf16 q), and the mixed dispatch's slab
    of 4 rows, the last an unused segment, over float8 pages."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k = pa.KV_SPLIT
    lens = [k - 1, k, k + 1, 2 * k + 9]
    pk, pv, tables = _fp8_pool(gen, cuda_device, lens, 4, 64, 16, 64)
    q = torch.randn((len(lens), 1, 32, 64), generator=gen,
                    device=cuda_device).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens)
    want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens)
    split = pa.paged_decode_split_plain(q, pk, pv, tables, kv_lens)
    torch.cuda.synchronize()
    for ref in (want, split):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=atol)
    starts = [0, 64, 448, 0]
    pk, pv, tables = _fp8_pool(gen, cuda_device,
                               [s + 64 for s in starts[:3]] + [-1], 4, 64,
                               16, 64)
    q = torch.randn((4, 64, 32, 64), generator=gen,
                    device=cuda_device).to(dtype)
    pos = (torch.tensor(starts, device=cuda_device)[:, None]
           + torch.arange(64, device=cuda_device))
    got = pa.paged_prefill_attention(q, pk, pv, tables, pos)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_paged_fp8_decode_is_batch_invariant(cuda_device):
    """Each row of an 8-slot bf16 decode launch over float8 pages is
    bit-equal to the same row launched alone."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    lens = [1, 16, 37, 1000, 512, 130, -300, -5]
    pk, pv, tables = _fp8_pool(gen, cuda_device, lens, 4, 64, 16, 64)
    q = torch.randn((len(lens), 1, 32, 64), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=cuda_device)
    batch = pa.paged_flash_attention(q, pk, pv, tables, kv_lens)
    for i in range(len(lens)):
        one = pa.paged_flash_attention(q[i:i + 1], pk, pv, tables[i:i + 1],
                                       kv_lens[i:i + 1])
        assert torch.equal(one, batch[i:i + 1]), f"row {i}"


def _small_llama(dev, dtype="float32"):
    cfg = get_model_config("llama-test").replace(
        hidden_size=256, intermediate_size=512, num_layers=3,
        dtype_name=dtype)
    return cfg, init_full_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)


def _codes_twin(plain, prompt, n_prefix, bits):
    """The last logits of ``plain``'s (no pool) prefill of ``prompt``
    with its first ``n_prefix`` K/V columns replaced by their own
    quantized codes, dequantized: what a warm prefill over a pool of
    those codes computes, through the cold path."""
    ids, st = plain._ids(prompt), plain._state(1)
    _, cache = plain._run_prefill(
        ids[:, :n_prefix], KVCache(st.cache.keys, st.cache.values, 0))
    for t in (st.cache.keys, st.cache.values):
        cols = t[:, :, :, :n_prefix]
        cols.copy_(quant.quantize_kv_pages(cols, bits).dequantize().to(
            t.dtype))
    logits, _ = plain._run_prefill(ids, cache, n_prefix)
    return logits.float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_engine_cold_and_primed_on_the_card(cuda_device, dtype, kv_dtype):
    """The prefix pool on the card, flash kernel on: a prompt whose 64
    shared tokens were stored by another prompt seeds them and prefills
    its last 16-token chunk alone (L flash launches).  Over a full-width
    pool its tokens and logprobs are the cold run's bit for bit (the
    chunks align and the seeded K/V are the cold cache's bits); int8 /
    int4 pages seed dequantized K/V, and the warm prefill's logits stay
    within 5e-2 of the largest of their twin's: the cold engine with its
    prefix K/V replaced by the same codes, dequantized."""
    cfg, params = _small_llama(cuda_device, dtype)
    rs = np.random.RandomState(0)
    shared = rs.randint(0, cfg.vocab_size, 64).tolist()
    p1, p2 = ([shared + rs.randint(0, cfg.vocab_size, 16).tolist()]
              for _ in range(2))
    kw = dict(max_seq=256, sampling=GREEDY, prefill_chunk=16,
              device=cuda_device)
    plain = InferenceEngine(cfg, params, **kw)
    cold = plain.generate(p2, 12, logprobs=True)
    eng = InferenceEngine(cfg, params, kv_cache_blocks=32,
                          kv_block_tokens=16, kv_dtype=kv_dtype, **kw)
    assert eng.attn_backend == "flash"
    eng.generate(p1, 4)
    before = fa.flash_attention.launches
    if kv_dtype == "bf16":
        warm = eng.generate(p2, 12, logprobs=True)
        assert fa.flash_attention.launches - before == cfg.num_layers
        np.testing.assert_array_equal(warm.tokens, cold.tokens)
        np.testing.assert_array_equal(warm.logprobs, cold.logprobs)
    else:
        start, logits = eng._seeded_prefill(np.asarray(p2),
                                            eng._ids(p2), eng._state(1))
        assert fa.flash_attention.launches - before == cfg.num_layers
        want = _codes_twin(plain, p2, 64, 8 if kv_dtype == "int8" else 4)
        assert start == 64
        err = np.abs(logits.float().cpu().numpy() - want).max()
        assert err <= 5e-2 * max(1.0, np.abs(want).max())
    assert eng.kv_cache.stats["hits"] == 1
    mgr = eng.kv_cache.mgr
    assert mgr.used_blocks == mgr.tree.block_count


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_batching_through_the_fp8_kernels(cuda_device, dtype):
    """A float8-page batching engine on the card: decode launches the
    decode kernel's e4m3 instance L times a step and chunked admission
    the prefill kernel's; under f32 the greedy tokens equal the gather
    path's ("plain") on the same float8 pages."""
    cfg, params = _small_llama(cuda_device, dtype)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70))]
    kw = dict(max_seq=128, max_batch=4, sampling=GREEDY, kv_block_tokens=16,
              prefill_chunk=16, kv_cache_dtype="float8_e4m3fn",
              device=cuda_device)
    runs = {}
    for backend in ("auto", "plain"):
        with ContinuousBatchingEngine(cfg, params, attn_backend=backend,
                                      **kw) as eng:
            before = _counts()
            runs[backend] = [eng.submit(p, 8).wait(timeout=120).tolist()
                             for p in prompts]
            steps = eng.loop_stats["device_loop_steps"]
        ran = [a - b for a, b in zip(_counts(), before)]
        if backend == "auto":
            assert ran[2] == cfg.num_layers * steps and ran[5] > 0
            assert ran[:2] == [0, 0] and ran[3:5] == [0, 0]
        else:
            assert ran == [0] * 6
    if dtype == "float32":
        assert runs["auto"] == runs["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(), dict(prefill_chunk=16, decode_block=4, mixed_token_budget=32)],
    ids=["step", "mixed"])
def test_fp8_batching_graph_replay_equals_eager(cuda_device, extra):
    """Over float8 pages, the replayed decode graph gives the eager
    step's tokens and logprobs bit for bit, and its fp8 launch count
    equals the eager count, L a step."""
    cfg, params = _small_llama(cuda_device, "bfloat16")
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 40, 70, 5))]
    runs = {}
    for flag in (True, False):
        with ContinuousBatchingEngine(
                cfg, params, max_seq=128, max_batch=4, sampling=GREEDY,
                kv_block_tokens=16, prompt_buckets=(16, 64),
                kv_cache_dtype="float8_e4m3fn", device=cuda_device,
                cuda_graph=flag, **extra) as eng:
            before = pa.paged_flash_attention.fp8_launches
            reqs = [eng.submit(p, 10) for p in prompts]
            for r in reqs:
                r.wait(timeout=120)
            runs[flag] = ([r.tokens for r in reqs], [r.lps for r in reqs],
                          pa.paged_flash_attention.fp8_launches - before,
                          eng.graph_replays,
                          eng.loop_stats["device_loop_steps"])
    toks, lps, launches, replays, steps = runs[True]
    e_toks, e_lps, e_launches, e_replays, e_steps = runs[False]
    assert toks == e_toks
    np.testing.assert_array_equal(np.concatenate(lps), np.concatenate(e_lps))
    assert replays == steps > 0 and e_replays == 0
    assert launches == cfg.num_layers * steps
    assert e_launches == cfg.num_layers * e_steps


@pytest.mark.cuda
def test_fp8_engine_takes_plain_attention(cuda_device):
    """A float8 cache on the card: "auto" resolves to plain attention
    (no flash launch), "flash" raises; greedy tokens equal the float8
    batching engine's."""
    cfg, params = _small_llama(cuda_device, "float32")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        InferenceEngine(cfg, params, attn_backend="flash",
                        kv_cache_dtype="float8_e4m3fn", device=cuda_device)
    eng = InferenceEngine(cfg, params, max_seq=128, sampling=GREEDY,
                          kv_cache_dtype="float8_e4m3fn", device=cuda_device)
    assert eng.attn_backend == "plain"
    assert eng._state(1).cache.keys.dtype == FLOAT8
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, 40).tolist()
    before = fa.flash_attention.launches
    want = eng.generate([prompt], 8).tokens[0].tolist()
    assert fa.flash_attention.launches == before
    with ContinuousBatchingEngine(cfg, params, max_seq=128, max_batch=2,
                                  sampling=GREEDY, kv_block_tokens=16,
                                  kv_cache_dtype="float8_e4m3fn",
                                  device=cuda_device) as bat:
        assert bat.submit(prompt, 8).wait(timeout=120).tolist() == want
