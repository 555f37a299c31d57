"""The f32 paged decode and the f32 dense kernels off the card: their
routing and split rules, the arguments their wrappers hand the C entry
points, and their plain versions against the JAX package.

The split decode (``csrc/paged_attention.cu``,
``paged_decode_f32_split_kernel``) and the two f32 dense kernels
(``csrc/quant_dense.cu``, ``quant_dense_f32_decode_kernel`` up to 16 rows
and ``quant_dense_f32_tile_kernel`` above) run only on a card
(``tests/test_torch_cuda_f32_decode_dense.py``, ``chip_smoke.py``).  Here
the C entry points are replaced by a recorder; the plain versions go
through the same numpy inputs as the reference's ``_paged_call`` (in
interpret mode, as the JAX package's own tests run it) and
``ops/quant.dense``.  Floats agree to rtol/atol 2e-4: full f32 on both
sides, summation order aside.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    kv_pages_from_numpy
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops import quant_dense as qd
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = dict(rtol=2e-4, atol=2e-4)
H100_SMS = 132
NH, NKV, HD = 4, 2, 16          # llama-test


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# routing and splits of the f32 dense kernels

# TinyLlama's seven weights [K, N]: (name, K, N, bits, the decode
# kernels' split, the tile kernel's at M = 17 and at M = 256)
TINY_SPLITS = [
    (name, k, n, bits, dec, s17, s256)
    for name, k, n, splits in (
        ("wq", 2048, 2048, {8: (16, 8, 2), 4: (16, 8, 1)}),
        ("wk", 2048, 256, {8: (16, 16, 2), 4: (16, 11, 1)}),
        ("wv", 2048, 256, {8: (16, 16, 2), 4: (16, 11, 1)}),
        ("wo", 2048, 2048, {8: (16, 8, 2), 4: (16, 8, 1)}),
        ("w_gate", 2048, 5632, {8: (6, 3, 1), 4: (6, 3, 1)}),
        ("w_up", 2048, 5632, {8: (6, 3, 1), 4: (6, 3, 1)}),
        ("w_down", 5632, 2048, {8: (16, 8, 4), 4: (16, 8, 2)}))
    for bits, (dec, s17, s256) in splits.items()]


def test_tinyllama_weight_shapes():
    cfg = get_model_config("tinyllama-1.1b")
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    assert {(name, k, n) for name, k, n, *_ in TINY_SPLITS} == {
        ("wq", H, q), ("wk", H, kv), ("wv", H, kv), ("wo", q, H),
        ("w_gate", H, I), ("w_up", H, I), ("w_down", I, H)}


@pytest.mark.parametrize("name,k,n,bits,dec,s17,s256", TINY_SPLITS)
def test_f32_route_and_splits_at_tinyllama_shapes(name, k, n, bits, dec,
                                                  s17, s256):
    """Up to 16 rows the f32 decode kernel, with the bf16 decode kernel's
    split at every M (it depends on no M); from 17 the tile kernel, split
    only where its 128 x 128 tiles leave SMs of the H100's 132 idle."""
    f32 = torch.float32
    for m in range(1, qd.DECODE_MAX_ROWS + 1):
        assert qd.route(m, f32) == "f32_decode"
        assert qd.splits_for("f32_decode", m, k, n, bits, H100_SMS) == dec
    assert dec == qd.splits_for("decode", 1, k, n, bits, H100_SMS)
    for m, want in ((17, s17), (256, s256)):
        assert qd.route(m, f32) == "f32_tile"
        assert qd.splits_for("f32_tile", m, k, n, bits, H100_SMS) == want
        tiles = -(-m // qd.F32_TILE_ROWS) * -(-n // qd.BLOCK_N)
        # the partials stay under the weight's bytes
        assert want == 1 or want * m * n * 4 <= k * n * bits // 8
        # a split only where one split's tiles leave SMs idle
        assert want == 1 or tiles < H100_SMS


def test_f32_tile_splits_fill_the_card():
    """The tile kernel's split takes the fewest waves of steps: a long
    chunk's 528 tiles take none, w_up's 44 tiles at M = 17 three (132
    blocks: one wave of 11 steps, not 32)."""
    assert qd.f32_tile_splits(1500, 2048, 5632, 8, H100_SMS) == 1
    assert qd.f32_tile_splits(17, 2048, 5632, 8, H100_SMS) == 3
    # one SM: never split
    assert qd.f32_tile_splits(17, 2048, 5632, 8, 1) == 1


# ---------------------------------------------------------------------------
# the wrappers' launches, with the C entry points replaced by a recorder


class _Recorder:
    """A stand-in for a ctypes launch function: records its arguments and
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers' stream lookups answered without a card."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def _pages(page, n=5, nkv=2, bt=16, hd=64):
    x = torch.randn((n, nkv, bt, hd),
                    generator=torch.Generator().manual_seed(0))
    if page == "int8":
        return quant.quantize_kv_pages(x, 8)
    if page == "fp8":
        return quant.cast_kv(x, quant.FLOAT8)
    return x


@pytest.mark.parametrize("page,counter", [("full", "launches"),
                                          ("int8", "int8_launches"),
                                          ("fp8", "fp8_launches")])
@pytest.mark.parametrize("W", [1, 8, 9, 40])
def test_f32_decode_launch_passes_splits_and_scratch(monkeypatch, no_card,
                                                     page, counter, W):
    """An f32 decode call hands the C entry point splits =
    decode_splits(W, bt) and the partials' scratch (acc [b, splits, nh,
    hd], then m and l), f32's dtype code, and moves its page type's
    count by one, the others not at all."""
    rec = _Recorder()
    monkeypatch.setattr(pa, "_kernel_fns", lambda: {("decode", page): rec})
    b, nh, hd, bt = 3, 8, 64, 16
    q = torch.zeros((b, 1, nh, hd))
    pk = _pages(page)
    tables = torch.zeros((b, W), dtype=torch.int32)
    kv_lens = torch.tensor([1, 17, 0], dtype=torch.int32)
    fn = pa.paged_flash_attention
    counters = ("launches", "int8_launches", "fp8_launches")
    before = {c: getattr(fn, c) for c in counters}
    out = pa._decode_launch(q, pk, _pages(page), tables, kv_lens, None, page)
    assert out.shape == q.shape and out.dtype == torch.float32
    args = rec.calls[0]
    # (..., out, part_acc, part_ml, b, nh, nkv, hd, bt, num_pages, W,
    # splits, scale, dtype, stream)
    splits = pa.decode_splits(W, bt)
    assert args[-4] == splits and args[-5] == W and args[-2] == 0
    part_acc, part_ml = args[-13], args[-12]
    assert part_acc and part_ml - part_acc == 4 * b * splits * nh * hd
    assert args[-11:-6] == (b, nh, 2, hd, bt)
    assert {c: getattr(fn, c) - before[c] for c in counters} == {
        c: int(c == counter) for c in counters}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
def test_f32_dense_launch_passes_its_regime(monkeypatch, no_card, bits, m):
    """An f32 product hands the C entry point the kernel code of its
    regime (3: the f32 decode kernel up to 16 rows, 0: the tile kernel
    above), f32's dtype code and the split rule's count, with the
    partials' scratch and the arrival counters where it splits; it moves
    ``launches`` by one and the bf16 decode kernel's count not at all."""
    rec = _Recorder()
    monkeypatch.setattr(qd, "_kernel_fn", lambda: (rec, None))
    counters = torch.zeros(qd.COUNTERS, dtype=torch.int32)
    monkeypatch.setattr(qd, "arrival_counters", lambda d, s=None: counters)
    k, n = 2048, 256
    w = torch.randn((k, n), generator=torch.Generator().manual_seed(bits))
    wq = quant.quantize_array(w) if bits == 8 else quant.quantize_array4(w)
    x = torch.zeros((m, k))
    kernel = qd.route(m, x.dtype)
    splits = qd.splits_for(kernel, m, k, n, bits, H100_SMS)
    before = (qd.quant_dense.launches, qd.quant_dense.decode_launches)
    out = qd._launch(x, wq, kernel, splits)
    assert out.shape == (m, n) and out.dtype == torch.float32
    # (x, q, scale, out, part, counters, m, n, k, bits, group, dtype,
    # kernel, splits, stream)
    args = rec.calls[0]
    assert args[11] == 0 and args[13] == splits
    assert args[12] == (3 if m <= qd.DECODE_MAX_ROWS else 0)
    assert args[12] == qd.KERNELS[kernel]
    assert args[5] == (counters.data_ptr() if splits > 1 else None)
    assert (args[4] is not None) == (splits > 1)
    assert (qd.quant_dense.launches - before[0],
            qd.quant_dense.decode_launches - before[1]) == (1, 0)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package

# (page tokens, table width, keys per split, row lengths): rows one key
# either side of a split boundary, at it, past two, and a row of length 0
SPLIT_CASES = {
    "either_side_of_a_split": (8, 8, 16, [15, 17, 16, 33]),
    "zero_length_row": (8, 8, 16, [0, 40, 1]),
}


def _split_inputs(seed, bt, W, lens, pages):
    """q, the reference's pools, the port's pools and the tables for
    ``lens`` under shuffled page ids (sentinel N past each row's pages)."""
    rng = np.random.default_rng(seed)
    need = [-(-n // bt) for n in lens]
    N = sum(need) + 3
    ids = rng.permutation(N)
    tables = np.full((len(lens), W), N + 7, np.int32)
    nxt = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[nxt:nxt + n]
        if n < W:
            tables[i, n] = N
        nxt += n
    q = rng.standard_normal((len(lens), 1, NH, HD)).astype(np.float32)
    ref_pools, port_pools = [], []
    for _ in range(2):
        x = rng.standard_normal((N, NKV, bt, HD)).astype(np.float32)
        if pages == "int8":
            qp = ref_quant.quantize_kv_pages(jnp.asarray(x), 8)
            ref_pools.append(qp)
            port_pools.append(kv_pages_from_numpy(
                np.asarray(qp.data), np.asarray(qp.scale), None, 8,
                "cpu")[:N])
        elif pages == "fp8":
            r = jnp.asarray(x).astype(jnp.float8_e4m3fn)
            ref_pools.append(r)
            port_pools.append(torch.from_numpy(
                np.asarray(r).view(np.uint8).copy()).view(quant.FLOAT8))
        else:
            ref_pools.append(jnp.asarray(x))
            port_pools.append(torch.from_numpy(x))
    return q, ref_pools, port_pools, tables


@pytest.mark.parametrize("pages", ["full", "int8", "fp8"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_f32_split_plain_matches_reference_kernel(name, alibi, pages):
    """The split arithmetic in f32 against ``_paged_call`` (interpret
    mode) at splits of 16 keys; a row of length 0 gives exactly 0."""
    bt, W, kv_split, lens = SPLIT_CASES[name]
    q, (rk, rv), (tk, tv), tables = _split_inputs(len(name) + alibi, bt, W,
                                                  lens, pages)
    kv_lens = np.asarray(lens, np.int32)
    rs, ps = (ref_alibi_slopes(NH), alibi_slopes(NH)) if alibi else (None,
                                                                    None)
    want = ref_pa.paged_flash_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(tables), jnp.asarray(kv_lens),
        rs, interpret=True)
    got = pa.paged_decode_split_plain(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(kv_lens), ps, kv_split=kv_split)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 17])
def test_f32_plain_dense_matches_reference_on_llama_test(bits, m):
    """``quant_dense_plain`` on f32 x against the reference's
    ``ops/quant.dense`` on llama-test's seven weights, at a row count of
    each regime (the codes are bit-equal:
    ``tests/test_torch_quant_weights.py``)."""
    cfg = get_model_config("llama-test")
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    rng = np.random.RandomState(bits + m)
    for k, n in ((H, q), (H, kv), (q, H), (H, I), (I, H)):
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        x = rng.standard_normal((m, k)).astype(np.float32)
        rq = (ref_quant.quantize_array(jnp.asarray(w)) if bits == 8
              else ref_quant.quantize_array4(jnp.asarray(w)))
        pq = (quant.quantize_array(torch.from_numpy(w)) if bits == 8
              else quant.quantize_array4(torch.from_numpy(w)))
        want = np.asarray(ref_quant.dense(jnp.asarray(x), rq, "mh,hi->mi"))
        got = qd.quant_dense_plain(torch.from_numpy(x), pq)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
