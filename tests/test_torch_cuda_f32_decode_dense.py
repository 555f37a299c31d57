"""The f32 paged decode (``paged_decode_f32_split_kernel`` and its merge)
and the two f32 dense kernels (``quant_dense_f32_decode_kernel``,
``quant_dense_f32_tile_kernel``) against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_f32_decode_dense.py -m cuda \
        --noconftest -q

Tolerance 1e-4 (atol and rtol): full f32 on both sides, so the two differ
by summation order only.
"""

import pytest
import torch

from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = 1e-4
SPLIT = pa.KV_SPLIT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _pool(gen, dev, pages, lens, nkv, hd, bt=16, W=32):
    """f32 pages holding the live pages of ``lens`` (negative: a freed
    slot, all-sentinel table, at a stale length) under shuffled ids,
    tables with sentinels N and N + 7 past each row's pages; ``pages``
    "int8" quantizes them, "fp8" casts them to float8 e4m3."""
    need = [-(-n // bt) if n > 0 else 0 for n in lens]
    N = sum(need) + 3
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(N))
    tables = torch.full((len(lens), W), N + 7, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[nxt:nxt + n].to(torch.int32)
        if n < W:
            tables[i, n] = N
        nxt += n
    pk = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    pv = torch.randn((N, nkv, bt, hd), generator=gen, device=dev)
    if pages == "int8":
        pk, pv = quant.quantize_kv_pages(pk, 8), quant.quantize_kv_pages(pv, 8)
    elif pages == "fp8":
        pk, pv = (quant.cast_kv(pk, quant.FLOAT8),
                  quant.cast_kv(pv, quant.FLOAT8))
    return pk, pv, tables.to(dev)


def _case(dev, pages, nh, nkv, hd, lens, alibi=False, seed=0, W=32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, pv, tables = _pool(gen, dev, pages, lens, nkv, hd, W=W)
    q = torch.randn((len(lens), 1, nh, hd), generator=gen, device=dev)
    kv_lens = torch.tensor([abs(n) for n in lens], dtype=torch.int32,
                           device=dev)
    slopes = alibi_slopes(nh, device=dev) if alibi else None
    return q, pk, pv, tables, kv_lens, slopes


# the rows: the serving lengths (1, a page, mid-page, a long one), a
# freed slot (negative: stale length over an all-sentinel table), one key
# either side of the split boundary, two splits and a row of length 0
LENS = [1, 16, 37, 499, -300, SPLIT - 1, SPLIT + 1, 2 * SPLIT, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("g", [1, 4, 8, 16])
def test_f32_decode_matches_plain(cuda_device, pages, hd, g):
    """One launch (its page type's count moves by one) against the split
    arithmetic and the unsplit plain version; a row of length 0 writes
    exactly 0."""
    nkv = 2
    args = _case(cuda_device, pages, g * nkv, nkv, hd, LENS, alibi=g == 4)
    fn = pa.paged_flash_attention
    counter = {"full": "launches", "int8": "int8_launches",
               "fp8": "fp8_launches"}[pages]
    before = getattr(fn, counter)
    got = fn(*args)
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    for plain in (pa.paged_decode_split_plain,
                  pa.paged_flash_attention_plain):
        torch.testing.assert_close(got, plain(*args), atol=TOL, rtol=TOL)
    zero = LENS.index(0)
    assert torch.equal(got[zero], torch.zeros_like(got[zero]))


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("nh,nkv,hd", [(32, 4, 64), (8, 1, 256),
                                       (32, 32, 80), (16, 16, 96),
                                       (32, 8, 128)])
def test_f32_decode_rows_do_not_depend_on_the_batch(cuda_device, pages, nh,
                                                    nkv, hd):
    """Each row launched alone equals that row among seven others, bit
    for bit: the splits sit at fixed positions and a row reads only its
    own q, length and pages."""
    lens = [1, 16, 37, 499, -300, SPLIT + 1, 1999, 700]
    q, pk, pv, tables, kv_lens, slopes = _case(cuda_device, pages, nh, nkv,
                                               hd, lens, seed=1, W=128)
    got = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    for i in range(len(lens)):
        one = pa.paged_flash_attention(q[i:i + 1], pk, pv, tables[i:i + 1],
                                       kv_lens[i:i + 1], slopes)
        assert torch.equal(one, got[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
def test_f32_decode_graph_replay_equals_eager(cuda_device, pages):
    """The split pass and its merge captured in a CUDA graph: a replay
    equals the eager call bit for bit."""
    q, pk, pv, tables, kv_lens, slopes = _case(cuda_device, pages, 32, 4,
                                               64, LENS, seed=2)
    eager = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_flash_attention(q, pk, pv, tables, kv_lens, slopes)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def _weight(bits, k, n, gen, dev):
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    return quant.quantize_array(w) if bits == 8 else quant.quantize_array4(w)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [
    (m, k, n) for k, n in ((2048, 256), (2048, 5632), (5632, 2048),
                           (512, 272))
    for m in (1, 8, 16, 17, 64, 256)] + [(37, 512, 272), (300, 1024, 2048)])
def test_f32_dense_regimes_match_plain(cuda_device, bits, m, k, n):
    """Both f32 regimes against ``x @ w.dequantize(f32)`` on the same
    codes: one launch a call, none of the bf16 decode kernel's."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits + m)
    wq = _weight(bits, k, n, gen, cuda_device)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    before = (qd.quant_dense.launches, qd.quant_dense.decode_launches)
    got = qd.quant_dense(x, wq)
    want = qd.quant_dense_plain(x, wq)
    torch.cuda.synchronize()
    assert (qd.quant_dense.launches - before[0],
            qd.quant_dense.decode_launches - before[1]) == (1, 0)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(2048, 256), (2048, 5632), (5632, 2048)])
def test_f32_dense_rows_bit_equal_across_m(cuda_device, bits, k, n):
    """The f32 decode kernel's split depends on no M and each (row,
    column) is one FFMA chain: every row of an 8- and a 16-row launch
    equals the same row launched alone, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    wq = _weight(bits, k, n, gen, cuda_device)
    x = torch.randn((16, k), generator=gen, device=cuda_device)
    y16 = qd.quant_dense(x, wq)
    y8 = qd.quant_dense(x[:8], wq)
    for r in range(16):
        y1 = qd.quant_dense(x[r:r + 1], wq)
        assert torch.equal(y1[0], y16[r])
        if r < 8:
            assert torch.equal(y1[0], y8[r])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 256), (8, 2048, 5632),
                                   (17, 2048, 5632), (256, 5632, 2048)])
def test_f32_dense_graph_replay_bit_equal(cuda_device, bits, m, k, n):
    """A split f32 product captured in a CUDA graph and replayed equals
    the eager launch bit for bit, the arrival counters back at 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits + m)
    wq = _weight(bits, k, n, gen, cuda_device)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    kernel = qd.route(m, x.dtype)
    assert qd.splits_for(kernel, m, k, n, bits, qd._sm_count(x.device)) > 1
    eager = qd.quant_dense(x, wq)
    graph = torch.cuda.CUDAGraph()
    with qd.counters_scope(qd.new_counters(x.device)) as counters, \
            torch.cuda.graph(graph):
        out = qd.quant_dense(x, wq)
    for _ in range(5):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert int(counters.abs().sum()) == 0
