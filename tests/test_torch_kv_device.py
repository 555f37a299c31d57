"""The torch port's ``runtime/kvcache/device.py`` against the JAX
package's, and its float8 insert cast against the reference's.

Same numpy inputs through both, over pools of every width the engines
make: f32, bf16, float8 e4m3 (``kv_cache_dtype``), int8 and int4
(``kv_dtype``).  The port's pools carry one drop page after the N pages
a table names (``ops/paged_attention``'s convention); the N pages must
end bit-equal to the reference's, sentinel writes dropped.  Exported
then adopted blocks equal the input.  The float8 cast gives the
reference's codes, NaN past 464 and for +-inf included, on every write
path: the dense cache (``update_kv_cache``, ``attention_at``), the pages
(``write_paged_kv``) and ``store_cache_to_pages``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.attention import \
    update_kv_cache as ref_update_kv_cache
from distributed_inference_demo_tpu.runtime.kvcache import device as ref_dev
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.ops.attention import (
    attention_at, update_kv_cache)
from distributed_inference_demo_tpu_torch.runtime.kvcache import device

L, N, H, BT, D = 2, 7, 2, 4, 8
S = 32                                  # working-cache columns
WIDTHS = ["f32", "bf16", "float8", "int8", "int4"]
BITS = {"int8": 8, "int4": 4}
# values past float8's range (and past bf16's rounding of it), infinities
EDGE = np.array([449, 464, 464.5, 465, 500, 1e6, -1e6, np.inf, -np.inf,
                 np.nan, 448, -447, 2 ** -9, 2 ** -10, 3 * 2 ** -11,
                 -3 * 2 ** -11, 0.0, -0.0], np.float32)

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16,
        "float8": jnp.float8_e4m3fn}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16,
          "float8": torch.float8_e4m3fn}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    """Any array of either package as its raw bits (NaNs compare)."""
    if torch.is_tensor(a):
        a = a.contiguous()
        raw = a.view({1: torch.uint8, 2: torch.int16,
                      4: torch.int32}[a.element_size()])
        return raw.numpy().view(_UINT[a.element_size()])
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def _torch(a) -> torch.Tensor:
    """A reference array as a torch tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype in (np.float32, np.int8, np.uint8):
        return torch.from_numpy(a.copy())
    dt = {ml_dtypes.bfloat16: torch.bfloat16,
          ml_dtypes.float8_e4m3fn: torch.float8_e4m3fn}[a.dtype.type]
    raw = {2: np.int16, 1: np.uint8}[a.dtype.itemsize]
    return torch.from_numpy(a.view(raw).copy()).view(dt)


def _plain(rng, shape, width, scale=1.0):
    """A reference array of ``width`` from N(0, scale^2) f32 draws."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(_JNP[width])


def _ref_pool(rng, width, scale=1.0):
    """A random ``[L, N, H, BT, D]`` reference pool of ``width``."""
    if width in BITS:
        x = rng.standard_normal((L, N, H, BT, D)).astype(np.float32)
        return ref_quant.quantize_kv_pages(jnp.asarray(x), BITS[width])
    return _plain(rng, (L, N, H, BT, D), width, scale)


def _leaves(pool):
    if isinstance(pool, (ref_quant.QuantizedKVPages,
                         quant.QuantizedKVPages)):
        return [t for t in (pool.data, pool.scale, pool.zero)
                if t is not None]
    return [pool]


def _port_pool(ref_pool):
    """The reference pool as the port's, a zeroed drop page appended."""
    def leaf(a):
        t = _torch(a)
        return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)

    if isinstance(ref_pool, ref_quant.QuantizedKVPages):
        return quant.QuantizedKVPages(
            data=leaf(ref_pool.data), scale=leaf(ref_pool.scale),
            zero=None if ref_pool.zero is None else leaf(ref_pool.zero),
            bits=ref_pool.bits)
    return leaf(ref_pool)


def _copy(ref_pool):
    """A fresh copy of a reference pool (its programs donate their
    inputs)."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), ref_pool)


def _assert_pages_equal(port_pool, ref_pool, pages=N):
    for got, want in zip(_leaves(port_pool), _leaves(ref_pool)):
        np.testing.assert_array_equal(_bits(got[:, :pages]), _bits(want))


def _cache_width(width):
    """The working cache of an engine over this pool: the pool's own
    dtype, f32 (llama-test's) for a quantized pool."""
    return "f32" if width in BITS else width


def _cache(width, rng=None):
    shape = (L, 1, H, S, D)
    if rng is None:
        return jnp.zeros(shape, _JNP[width])
    return _plain(rng, shape, width)


@pytest.mark.parametrize("width", WIDTHS)
def test_gather_run(width):
    rng = np.random.default_rng(0)
    rp = _ref_pool(rng, width)
    idx = np.array([3, 0, 5], np.int32)
    # as the reference's seam programs run it: compiled
    want = jax.jit(ref_dev._gather_run)(rp, jnp.asarray(idx))
    got = device._gather_run(_port_pool(rp), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("width", WIDTHS)
def test_scatter_run_drops_sentinels(width):
    rng = np.random.default_rng(1)
    rp = _ref_pool(rng, width)
    run = (rng.standard_normal((L, 3, H, BT, D)) * 200).astype(np.float32)
    table = np.array([4, N, 1], np.int32)       # the middle block drops
    want = jax.jit(ref_dev._scatter_run)(_copy(rp), jnp.asarray(run),
                                         jnp.asarray(table))
    got = _port_pool(rp)
    device._scatter_run(got, torch.from_numpy(run), table, None)
    _assert_pages_equal(got, want)


@pytest.mark.parametrize("width", ["f32", "bf16", "float8"])
def test_seed_prefix_cache(width):
    rng = np.random.default_rng(2)
    m = 12
    pk = (rng.standard_normal((L, 1, H, m, D)) * 300).astype(np.float32)
    pk[0, 0, 0, 0, :len(EDGE) % D] = EDGE[:len(EDGE) % D]
    pv = rng.standard_normal((L, 1, H, m, D)).astype(np.float32)
    wk, wv = ref_dev.seed_prefix_cache(_cache(width), _cache(width),
                                       jnp.asarray(pk), jnp.asarray(pv))
    ck, cv = _torch(_cache(width)), _torch(_cache(width))
    out = device.seed_prefix_cache(ck, cv, torch.from_numpy(pk),
                                   torch.from_numpy(pv))
    assert out[0] is ck and out[1] is cv          # written in place
    np.testing.assert_array_equal(_bits(ck), _bits(wk))
    np.testing.assert_array_equal(_bits(cv), _bits(wv))


@pytest.mark.parametrize("width", WIDTHS)
def test_seed_row_from_pages_clamps_sentinels(width):
    rng = np.random.default_rng(3)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    table = np.array([2, 6, N, N + 3], np.int32)
    want = ref_dev.seed_row_from_pages(rk, rv, jnp.asarray(table))
    got = device.seed_row_from_pages(_port_pool(rk), _port_pool(rv), table)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("width", WIDTHS)
def test_seed_cache_from_pages(width):
    rng = np.random.default_rng(4)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    table = np.array([5, 1, 3], np.int32)
    cw = _cache_width(width)
    base = _cache(cw, rng)
    want = ref_dev.seed_cache_from_pages(_copy(base), _copy(base), rk, rv,
                                         jnp.asarray(table))
    ck, cv = _torch(base), _torch(base)
    device.seed_cache_from_pages(ck, cv, _port_pool(rk), _port_pool(rv),
                                 table)
    np.testing.assert_array_equal(_bits(ck), _bits(want[0]))
    np.testing.assert_array_equal(_bits(cv), _bits(want[1]))


@pytest.mark.parametrize("cache", ["own", "f32"])
@pytest.mark.parametrize("width", WIDTHS)
def test_store_cache_to_pages(width, cache):
    """The tail-only store at a block offset; a float8 pool also takes an
    f32 cache with values past its range (the store's cast)."""
    if cache == "f32" and width != "float8":
        pytest.skip("only the float8 pool casts on the store path")
    rng = np.random.default_rng(5)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    cw = _cache_width(width) if cache == "own" else "f32"
    scale = 300.0 if cw == "f32" and width == "float8" else 1.0
    ck = _plain(rng, (L, 1, H, S, D), cw, scale)
    cv = _plain(rng, (L, 1, H, S, D), cw)
    table = np.array([6, 0], np.int32)
    want = ref_dev.store_cache_to_pages(_copy(rk), _copy(rv), ck, cv,
                                        jnp.asarray(table), jnp.int32(2))
    pk, pv = _port_pool(rk), _port_pool(rv)
    device.store_cache_to_pages(pk, pv, _torch(ck), _torch(cv), table, 2)
    _assert_pages_equal(pk, want[0])
    _assert_pages_equal(pv, want[1])


@pytest.mark.parametrize("width", WIDTHS)
def test_adopt_blocks_into_pages(width):
    """Full-width payloads (quantized or cast into a narrow pool) and,
    for a quantized pool, its own payload verbatim; a sentinel drops."""
    rng = np.random.default_rng(6)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    table = np.array([3, N, 0], np.int32)
    bk = (rng.standard_normal((3, L, H, BT, D)) * 100).astype(np.float32)
    bv = rng.standard_normal((3, L, H, BT, D)).astype(np.float32)
    payloads = [(jnp.asarray(bk), jnp.asarray(bv),
                 torch.from_numpy(bk), torch.from_numpy(bv))]
    if width in BITS:
        qk = ref_quant.quantize_kv_pages(jnp.asarray(bv), BITS[width])
        payloads.append((qk, qk, *[quant.QuantizedKVPages(
            *[None if t is None else _torch(t)
              for t in (qk.data, qk.scale, qk.zero)], bits=qk.bits)] * 2))
    for wk, wv, tk, tv in payloads:
        want = ref_dev.adopt_blocks_into_pages(_copy(rk), _copy(rv), wk, wv,
                                               jnp.asarray(table))
        pk, pv = _port_pool(rk), _port_pool(rv)
        device.adopt_blocks_into_pages(pk, pv, tk, tv, table)
        _assert_pages_equal(pk, want[0])
        _assert_pages_equal(pv, want[1])


@pytest.mark.parametrize("width", WIDTHS)
def test_export_blocks_from_pages(width):
    rng = np.random.default_rng(7)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    table = np.array([4, 2], np.int32)
    want = ref_dev.export_blocks_from_pages(rk, rv, jnp.asarray(table))
    got = device.export_blocks_from_pages(_port_pool(rk), _port_pool(rv),
                                          table)
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("width", WIDTHS)
def test_exported_blocks_adopt_back_unchanged(width):
    """ROADMAP A6's "done when": blocks exported from one pool and
    adopted into another at other ids export again bit-equal."""
    rng = np.random.default_rng(8)
    src_k, src_v = (_port_pool(_ref_pool(rng, width)) for _ in range(2))
    dst_k, dst_v = (_port_pool(_ref_pool(rng, width)) for _ in range(2))
    k_blocks, v_blocks = device.export_blocks_from_pages(src_k, src_v,
                                                         [1, 5, 2])
    device.adopt_blocks_into_pages(dst_k, dst_v, k_blocks, v_blocks,
                                   [6, 0, 3])
    again = device.export_blocks_from_pages(dst_k, dst_v, [6, 0, 3])
    for before, after in zip((k_blocks, v_blocks), again):
        for a, b in zip(_leaves(before), _leaves(after)):
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("width", WIDTHS)
def test_write_row_to_pages(width):
    rng = np.random.default_rng(9)
    rk, rv = _ref_pool(rng, width), _ref_pool(rng, width)
    W = 4
    cw = _cache_width(width)
    row_k = _plain(rng, (L, 1, H, W * BT, D), cw)
    row_v = _plain(rng, (L, 1, H, W * BT, D), cw)
    table = np.array([N, 2, 5, N + 2], np.int32)   # matched prefix, tail
    want = ref_dev.write_row_to_pages(_copy(rk), _copy(rv), row_k, row_v,
                                      jnp.asarray(table))
    pk, pv = _port_pool(rk), _port_pool(rv)
    device.write_row_to_pages(pk, pv, _torch(row_k), _torch(row_v), table)
    _assert_pages_equal(pk, want[0])
    _assert_pages_equal(pv, want[1])


def _cast_inputs(dtype):
    """EDGE and wide random normals as a reference array and a torch
    tensor with the same bits, in f32 or bf16."""
    rng = np.random.default_rng(10)
    x = np.concatenate([EDGE, (rng.standard_normal(4000)
                               * rng.choice([1e-3, 1.0, 30.0, 300.0], 4000)
                               ).astype(np.float32)])
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    bits = x.view(np.uint32) >> 16          # bf16 bit patterns, NaN kept
    ref = jnp.asarray(bits.astype(np.uint16).view(ml_dtypes.bfloat16))
    return ref, torch.from_numpy(bits.astype(np.uint16).view(np.int16)
                                 ).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_float8_cast_codes_equal_reference(dtype):
    ref, x = _cast_inputs(dtype)
    want = ref.astype(jnp.float8_e4m3fn)
    got = quant.cast_kv(x, torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if dtype == "f32":   # 449, 464, 500, 1e6, -1e6, inf, -inf
        assert _bits(got)[[0, 1, 4, 5, 6, 7, 8]].tolist() == [
            126, 126, 127, 127, 255, 127, 255]


@pytest.mark.parametrize("path", ["update_kv_cache", "attention_at",
                                  "write_paged_kv"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_float8_cast_on_every_write_path(dtype, path):
    """A K/V chunk written into a float8 dense cache or float8 pages
    holds the reference's codes."""
    ref, x = _cast_inputs(dtype)
    nkv, hd, chunk = 2, 8, 6
    n = chunk * nkv * hd
    k_ref = ref[:n].reshape(1, chunk, nkv, hd)
    k = x[:n].reshape(1, chunk, nkv, hd)
    if path == "write_paged_kv":
        pages = jnp.zeros((3, nkv, 4, hd), jnp.float8_e4m3fn)
        tables = jnp.asarray([[2, 0]], jnp.int32)
        pos = jnp.arange(1, 1 + chunk, dtype=jnp.int32)[None]
        want, _ = ref_pa.write_paged_kv(pages, pages, k_ref, k_ref, tables,
                                        pos)
        got = torch.zeros((4, nkv, 4, hd), dtype=torch.float8_e4m3fn)
        pa.write_paged_kv(got, got.clone(), k, k, torch.tensor([[2, 0]]),
                          torch.arange(1, 1 + chunk)[None], num_pages=3)
        np.testing.assert_array_equal(_bits(got[:3]), _bits(want))
        return
    cache = jnp.zeros((1, nkv, 16, hd), jnp.float8_e4m3fn)
    want, _ = ref_update_kv_cache(cache, cache, k_ref, k_ref,
                                       jnp.int32(3))
    got = torch.zeros((1, nkv, 16, hd), dtype=torch.float8_e4m3fn)
    if path == "update_kv_cache":
        update_kv_cache(got, got.clone(), k, k, 3)
    else:
        q = torch.zeros((1, chunk, nkv, hd))
        pos = torch.arange(3, 3 + chunk)[None]
        attention_at(q, k, k, got, got.clone(), pos, torch.tensor(3))
    np.testing.assert_array_equal(_bits(got), _bits(want))
