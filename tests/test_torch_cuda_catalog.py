"""The port's attention kernels at the catalog's head layouts that no other
card test takes, against their plain versions, on a card.

qwen2.5's 7 q heads a kv head (14/2 at hd 64, 28/4 at hd 128), whose
16-row blocks hold parts of three positions and whose decode A tile
leaves row 7 of each half empty; bloom7b1's ALiBi at hd 128 (32/32); and
gemma-7b's 16 heads on 16 at hd 256.  The flash kernel (both bf16
instances, the f32 tile), paged decode and paged prefill over full-width,
int8 and float8 e4m3 pages, the 8-row decode launch bit-equal to single
rows, and small engines of those head layouts against plain attention.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_catalog.py -m cuda --noconftest -q
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

# (nh, nkv, hd, alibi): qwen2.5-0.5b, qwen2.5-7b, bloom7b1, gemma-7b
HEADS = {"qwen2.5-0.5b": (14, 2, 64, False),
         "qwen2.5-7b": (28, 4, 128, False),
         "bloom7b1": (32, 32, 128, True),
         "gemma-7b": (16, 16, 256, False)}
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_heads_are_the_catalogs():
    """The layouts above are the registry's (runs anywhere)."""
    for name, (nh, nkv, hd, alibi) in HEADS.items():
        cfg = get_model_config(name)
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.use_alibi) == (nh, nkv, hd, alibi)


def _slopes(nh, alibi, dev):
    return alibi_slopes(nh, device=dev) if alibi else None


def _close(got, want, atol):
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("name,chunk,q_start", [
    ("qwen2.5-0.5b", 64, 0),      # 448 rows a kv head
    ("qwen2.5-0.5b", 37, 7),      # 259 rows: a partial last block
    ("qwen2.5-7b", 64, 0),
    ("qwen2.5-7b", 37, 100),
    ("qwen2.5-7b", 300, 0),       # 2100 rows: 64-row blocks fill the card
    ("bloom7b1", 64, 0),
    ("bloom7b1", 37, 7),
    ("gemma-7b", 64, 0),
    ("gemma-7b", 600, 0),         # takes <256, 64> at bf16
])
def test_flash_matches_plain(cuda_device, dtype, atol, name, chunk,
                             q_start):
    """The wrapper's instance and the other one (launched directly; f32's
    64-row one up to hd 128) against the plain version."""
    nh, nkv, hd, alibi = HEADS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(chunk + hd)
    kv_len = q_start + chunk
    q = torch.randn((1, chunk, nh, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kc = torch.randn((1, nkv, kv_len + 8, hd), generator=gen,
                     device=cuda_device).to(dtype)
    vc = torch.randn((1, nkv, kv_len + 8, hd), generator=gen,
                     device=cuda_device).to(dtype)
    slopes = _slopes(nh, alibi, cuda_device)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, kc, vc, q_start, kv_len, slopes)
    want = fa.flash_attention_plain(q, kc, vc, q_start, kv_len, slopes)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close(got, want, atol)
    rows = [16, 64] if (dtype == torch.bfloat16
                        or hd <= fa.F32_WIDE_MAX_HD) else [16]
    for r in rows:
        _close(fa._launch(q, kc, vc, q_start, kv_len, slopes, r), want, atol)


def _pool(gen, dev, pages, dtype, lens, nkv, hd, bt=16, W=128):
    """Pages holding the live pages of ``lens`` (negative: a freed slot,
    all-sentinel table) under shuffled ids; sentinels N and N + 7.
    ``pages`` "int8": quantized from f32 pages; "fp8": cast to e4m3."""
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
    if pages == "int8":
        return (quant.quantize_kv_pages(pk, 8),
                quant.quantize_kv_pages(pv, 8), tables.to(dev))
    if pages == "fp8":
        return (quant.cast_kv(pk, quant.FLOAT8),
                quant.cast_kv(pv, quant.FLOAT8), tables.to(dev))
    return pk.to(dtype), pv.to(dtype), tables.to(dev)


SERVE_LENS = [1, 16, 37, 1999, 512, 130, -300, -5]


def _decode_inputs(dev, name, pages, dtype, seed, lens=SERVE_LENS):
    nh, nkv, hd, alibi = HEADS[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, pv, tables = _pool(gen, dev, pages, dtype, lens, nkv, hd)
    q = torch.randn((len(lens), 1, nh, hd), generator=gen,
                    device=dev).to(dtype)
    kv_lens = torch.tensor([abs(x) for x in lens], dtype=torch.int32,
                           device=dev)
    return q, pk, pv, tables, kv_lens, _slopes(nh, alibi, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("name", list(HEADS))
def test_paged_decode_matches_plain(cuda_device, dtype, atol, pages, name):
    """The 8-slot serve rows (1 to 1999 keys, two freed slots) and the
    rows around the split boundaries."""
    for seed, lens in ((1, SERVE_LENS),
                       (2, [pa.KV_SPLIT - 1, pa.KV_SPLIT, pa.KV_SPLIT + 1,
                            2 * pa.KV_SPLIT + 9])):
        q, pk, pv, tables, kv_lens, slopes = _decode_inputs(
            cuda_device, name, pages, dtype, seed, lens)
        got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
        want = pa.paged_flash_attention_plain(q, pk, pv, tables, kv_lens,
                                              slopes)
        torch.cuda.synchronize()
        _close(got, want, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("name", ["qwen2.5-0.5b", "qwen2.5-7b"])
def test_g7_decode_rows_bit_equal_to_single_rows(cuda_device, dtype, pages,
                                                 name):
    """At g = 7 each row of the 8-row decode launch is bit-equal to the
    same row launched alone."""
    q, pk, pv, tables, kv_lens, slopes = _decode_inputs(
        cuda_device, name, pages, dtype, 3)
    batch = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    for i in range(q.shape[0]):
        one = pa.paged_flash_attention(q[i:i + 1], pk, pv, tables[i:i + 1],
                                       kv_lens[i:i + 1], slopes)
        assert torch.equal(one, batch[i:i + 1]), f"row {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("name", list(HEADS))
def test_paged_prefill_matches_plain(cuda_device, dtype, atol, pages, name):
    """A 64-token chunk at 200, a 37-token chunk from mid-page (at g = 7
    259 rows, not a multiple of 16), the mixed slab (4 rows at 0, 64,
    448, one unused) and the [8, K+1] verify."""
    nh, nkv, hd, alibi = HEADS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    slopes = _slopes(nh, alibi, cuda_device)
    for chunk, starts in ((64, [200]), (37, [13]), (64, [0, 64, 448, None]),
                          (5, [20, 150, 300, 600, 1000, 1500, 1999, None])):
        live = [s + chunk if s is not None else -1 for s in starts]
        pk, pv, tables = _pool(gen, cuda_device, pages, dtype, live, nkv, hd)
        q = torch.randn((len(starts), chunk, nh, hd), generator=gen,
                        device=cuda_device).to(dtype)
        pos = (torch.tensor([s or 0 for s in starts],
                            device=cuda_device)[:, None]
               + torch.arange(chunk, device=cuda_device))
        got = pa.paged_prefill_attention(q, pk, pv, tables, pos, slopes)
        want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos,
                                                slopes)
        torch.cuda.synchronize()
        _close(got, want, atol)


def _shaped(name):
    """Three-layer f32 models with a catalog model's head layout: qwen2
    at 14/2 heads of 64 (qkv biases), bloom at 16/16 heads of 128
    (ALiBi), gemma at 4/4 heads of 256."""
    if name == "qwen2-g7":
        return get_model_config("qwen2-test").replace(
            hidden_size=896, num_heads=14, num_kv_heads=2,
            intermediate_size=512, num_layers=3, max_seq_len=256)
    if name == "bloom-hd128":
        return get_model_config("bloom-test").replace(
            hidden_size=2048, num_heads=16, num_kv_heads=16,
            intermediate_size=512, num_layers=3, max_seq_len=256)
    return get_model_config("gemma-test").replace(
        hidden_size=256, num_heads=4, num_kv_heads=4, head_dim_override=256,
        intermediate_size=512, num_layers=3, max_seq_len=256)


def _launches():
    return (pa.paged_flash_attention.launches,
            pa.paged_flash_attention.int8_launches,
            pa.paged_prefill_attention.launches,
            pa.paged_prefill_attention.int8_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-g7", "bloom-hd128", "gemma-mha256"])
def test_engines_take_the_kernels_at_the_catalog_heads(cuda_device, name):
    """f32 engines of each layout on the card: the plain engine's prefills
    launch the flash kernel and give plain attention's tokens; the
    batching engine launches the paged kernels and gives the same tokens;
    the mixed dispatch over int8 pages launches their int8 instances, L a
    step and L a slab, and gives the gather path's tokens."""
    cfg = _shaped(name)
    L = cfg.num_layers
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device)
    greedy = SamplingParams(greedy=True)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size,
                                                n).tolist()
               for i, n in enumerate((10, 37, 70))]
    kern = InferenceEngine(cfg, params, max_seq=128, sampling=greedy,
                           device=cuda_device)
    plain = InferenceEngine(cfg, params, max_seq=128, sampling=greedy,
                            attn_backend="plain", device=cuda_device)
    assert kern.attn_backend == "flash"
    before = fa.flash_attention.launches
    got = [kern.generate([p], 8).tokens[0].tolist() for p in prompts]
    assert fa.flash_attention.launches == before + L * sum(
        len(p) >= 16 for p in prompts)
    want = [plain.generate([p], 8).tokens[0].tolist() for p in prompts]
    assert got == want
    kw = dict(max_seq=128, max_batch=4, sampling=greedy, kv_block_tokens=16,
              prefill_chunk=16, device=cuda_device)
    with ContinuousBatchingEngine(cfg, params, **kw) as eng:
        before = _launches()
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
