"""The f32-q prefill kernels (``csrc/f32_tile.cuh``: ``flash_f32_kernel``
and ``paged_prefill_f32_kernel``) against their plain versions, on a card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_f32_prefill.py -m cuda \
        --noconftest -q

Tolerance 1e-4 (atol and rtol): full f32 on both sides, so the two differ
by summation order only.
"""

import pytest
import torch

from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flash_inputs(gen, dev, b, chunk, nh, nkv, hd, max_seq=320):
    return tuple(torch.randn(shape, generator=gen, device=dev)
                 for shape in ((b, chunk, nh, hd), (b, nkv, max_seq, hd),
                               (b, nkv, max_seq, hd)))


def _pool(gen, dev, pages, lens, nkv, hd, bt=16, W=64):
    """f32 pages holding the live pages of ``lens`` (negative: a freed
    slot, all-sentinel table) under shuffled ids, tables with sentinels N
    and N + 7 past each row's pages; ``pages`` "int8" quantizes them,
    "fp8" casts them to float8 e4m3."""
    need = [-(-n // bt) if n > 0 else 0 for n in lens]
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
        pk, pv = quant.quantize_kv_pages(pk, 8), quant.quantize_kv_pages(pv, 8)
    elif pages == "fp8":
        pk, pv = quant.cast_kv(pk, quant.FLOAT8), quant.cast_kv(pv,
                                                                quant.FLOAT8)
    return pk, pv, tables.to(dev)


FLASH_SHAPES = [
    # b, chunk, nh, nkv, hd, q_start, alibi
    (1, 37, 32, 4, 64, 100, False),    # 296 rows: a partial last block
    (2, 21, 16, 16, 64, 7, True),      # g = 1 with ALiBi (bloom)
    (1, 64, 32, 32, 80, 0, True),      # bloom3b heads, hd 80
    (2, 37, 16, 16, 96, 100, True),    # bloom1b1 heads, hd 96
    (1, 64, 32, 8, 128, 150, False),   # llama-3-8b heads, hd 128
    (1, 45, 8, 1, 256, 60, False),     # gemma-2b heads, hd 256
    (1, 200, 32, 4, 64, 0, False),     # several 64-key tiles from 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [16, 64])
@pytest.mark.parametrize("b,chunk,nh,nkv,hd,q_start,alibi", FLASH_SHAPES)
def test_flash_f32_instances_match_plain(cuda_device, rows_per_block, b,
                                         chunk, nh, nkv, hd, q_start,
                                         alibi):
    """Each f32 instance, launched directly, against the plain version
    (the 64-row one where the head dim has it); the 64-row launches count
    in ``f32_wide_launches`` and nowhere else."""
    if rows_per_block == 64 and hd > fa.F32_WIDE_MAX_HD:
        pytest.skip("no 64-row f32 instance above hd 128")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, kc, vc = _flash_inputs(gen, cuda_device, b, chunk, nh, nkv, hd)
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    kv_len = q_start + chunk
    fa._check_cuda_args(q, kc, vc, q_start, kv_len, slopes)
    before = (fa.flash_attention.launches, fa.flash_attention.wide_launches,
              fa.flash_attention.f32_wide_launches)
    got = fa._launch(q, kc, vc, q_start, kv_len, slopes, rows_per_block)
    want = fa.flash_attention_plain(q, kc, vc, q_start, kv_len, slopes)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.wide_launches,
            fa.flash_attention.f32_wide_launches) == (
        before[0] + 1, before[1], before[2] + (rows_per_block == 64))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [16, 64])
def test_flash_f32_rows_with_no_keys_write_zero(cuda_device,
                                                rows_per_block):
    """kv_len 0: no row has a key, and every output is exactly 0, as the
    plain version's."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, kc, vc = _flash_inputs(gen, cuda_device, 1, 16, 32, 4, 64)
    got = fa._launch(q, kc, vc, 0, 0, None, rows_per_block)
    want = fa.flash_attention_plain(q, kc, vc, 0, 0, None)
    torch.cuda.synchronize()
    assert bool((got == 0).all()) and bool((want == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [16, 64])
def test_flash_f32_rows_do_not_depend_on_the_batch(cuda_device,
                                                   rows_per_block):
    """The fixed summation order: each batch row of a 4-row launch equals,
    bit for bit, the same row launched alone."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, kc, vc = _flash_inputs(gen, cuda_device, 4, 40, 32, 4, 64)
    slopes = alibi_slopes(32, device=cuda_device)
    full = fa._launch(q, kc, vc, 90, 130, slopes, rows_per_block)
    for i in range(4):
        one = fa._launch(q[i:i + 1].contiguous(), kc[i:i + 1].contiguous(),
                         vc[i:i + 1].contiguous(), 90, 130, slopes,
                         rows_per_block)
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[i])


PAGED_SHAPES = [
    # nh, nkv, hd, alibi, chunk, starts (None: an unused slot)
    (32, 4, 64, False, 37, [200]),          # partial last row block
    (16, 16, 64, True, 32, [7, 100]),       # g = 1 with ALiBi (bloom)
    (32, 32, 80, True, 64, [200]),          # hd 80
    (16, 16, 96, True, 21, [0, 300]),       # hd 96
    (32, 8, 128, False, 32, [200, 17]),     # hd 128
    (8, 1, 256, False, 64, [200]),          # hd 256 (gemma-2b heads)
    (32, 4, 64, False, 64, [0, 64, 448, None]),   # the mixed slab
    (32, 4, 64, False, 5, [20, 600, 999, None]),  # verify rows
]


def _paged_case(gen, dev, pages, nh, nkv, hd, chunk, starts):
    lens = [s + chunk if s is not None else -1 for s in starts]
    pk, pv, tables = _pool(gen, dev, pages, lens, nkv, hd)
    b = len(starts)
    q = torch.randn((b, chunk, nh, hd), generator=gen, device=dev)
    pos = (torch.tensor([s or 0 for s in starts], device=dev)[:, None]
           + torch.arange(chunk, device=dev))
    return q, pk, pv, tables, pos


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("nh,nkv,hd,alibi,chunk,starts", PAGED_SHAPES)
def test_paged_prefill_f32_matches_plain(cuda_device, pages, nh, nkv, hd,
                                         alibi, chunk, starts):
    """The f32 paged prefill on every page type, through the wrapper (its
    rule picks 16-row blocks at these shapes), against the plain version:
    sentinel table entries past each row's pages, and freed slots
    (all-sentinel tables) whose pages clamp into the pool."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, pk, pv, tables, pos = _paged_case(gen, cuda_device, pages, nh, nkv,
                                         hd, chunk, starts)
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    counter = {"full": "launches", "int8": "int8_launches",
               "fp8": "fp8_launches"}[pages]
    before = getattr(pa.paged_prefill_attention, counter)
    got = pa.paged_prefill_attention(q, pk, pv, tables, pos, slopes)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos, slopes)
    torch.cuda.synchronize()
    assert getattr(pa.paged_prefill_attention, counter) == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv,hd,alibi,chunk,starts",
                         [s for s in PAGED_SHAPES if s[2] <= 128])
def test_paged_prefill_f32_wide_instance_matches_plain(
        cuda_device, nh, nkv, hd, alibi, chunk, starts):
    """The 64-row f32 instance (full-width pages, hd <= 128), launched
    directly, against the plain version; it counts in
    ``f32_wide_launches``."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, pk, pv, tables, pos = _paged_case(gen, cuda_device, "full", nh, nkv,
                                         hd, chunk, starts)
    slopes = alibi_slopes(nh, device=cuda_device) if alibi else None
    page, tab, st = pa._check_cuda_args("paged_prefill_attention", q, pk, pv,
                                        tables, pos[:, 0], slopes)
    before = pa.paged_prefill_attention.f32_wide_launches
    got = pa._prefill_launch(q, pk, pv, tab, st, slopes, page, 64)
    want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos, slopes)
    torch.cuda.synchronize()
    assert pa.paged_prefill_attention.f32_wide_launches == before + 1
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
def test_paged_prefill_f32_slab_rows_equal_single_rows(cuda_device, pages):
    """The fixed summation order: each row of a 4-row slab (one an unused
    slot) equals, bit for bit, the same row launched alone."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, pk, pv, tables, pos = _paged_case(gen, cuda_device, pages, 32, 4, 64,
                                         64, [0, 64, 448, None])
    full = pa.paged_prefill_attention(q, pk, pv, tables, pos)
    for i in range(4):
        one = pa.paged_prefill_attention(q[i:i + 1].contiguous(), pk, pv,
                                         tables[i:i + 1].contiguous(),
                                         pos[i:i + 1])
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[i])


@pytest.mark.cuda
def test_f32_rule_either_side_of_the_threshold(cuda_device):
    """TinyLlama heads at the chunk just below and at the first chunk whose
    64-row blocks fill one and a half waves of this card's SMs: each
    wrapper takes the instance the rule names, counted in
    ``f32_wide_launches``."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    nh, nkv, hd, g = 32, 4, 64, 8
    need = -(-3 * sms // 2)                    # 64-row blocks: 1.5 waves
    for side in (-1, 0):
        chunk = (-(-need // nkv) - 1) * 64 // g + 1 + side
        rule = fa.f32_rows_per_block(1, nkv, chunk * g, hd, sms)
        assert rule == (64 if side == 0 else 16)
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        q, kc, vc = _flash_inputs(gen, cuda_device, 1, chunk, nh, nkv, hd,
                                  max_seq=chunk)
        wide = fa.flash_attention.f32_wide_launches
        got = fa.flash_attention(q, kc, vc, 0, chunk)
        want = fa.flash_attention_plain(q, kc, vc, 0, chunk)
        torch.cuda.synchronize()
        assert fa.flash_attention.f32_wide_launches - wide == (rule == 64)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        q, pk, pv, tables, pos = _paged_case(gen, cuda_device, "full", nh,
                                             nkv, hd, chunk, [0])
        wide = pa.paged_prefill_attention.f32_wide_launches
        got = pa.paged_prefill_attention(q, pk, pv, tables, pos)
        want = pa.paged_prefill_attention_plain(q, pk, pv, tables, pos)
        torch.cuda.synchronize()
        assert (pa.paged_prefill_attention.f32_wide_launches - wide
                == (rule == 64))
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
