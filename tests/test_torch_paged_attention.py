"""The torch port's paged attention against the JAX package's.

Same numpy inputs through both: ``write_paged_kv`` (sentinel and
past-table writes drop), the gather path, the plain versions of the two
CUDA kernels against the Pallas kernels in interpret mode (as the JAX
package's own tests run them), over the reference's sweep of ragged
lengths, page boundaries, 1-token tails, sentinel entries and GQA groups
1-8, with and without ALiBi; and the routing of ``make_paged_attn_impl``.
Floats agree to rtol/atol 2e-4, integers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = dict(rtol=2e-4, atol=2e-4)

# the reference's sweeps (tests/test_paged_attention.py): lengths hit
# mid-page, an exact page boundary, a single-token tail page, a
# single-token sequence and a full table; GQA groups 2, 8, 1 and 2
SWEEP = [
    dict(nh=4, nkv=2, hd=16, bt=8, W=4, lens=[5, 8, 17]),
    dict(nh=8, nkv=1, hd=8, bt=16, W=3, lens=[1, 33, 48]),
    dict(nh=2, nkv=2, hd=32, bt=8, W=2, lens=[16, 9]),
    dict(nh=8, nkv=4, hd=8, bt=24, W=5, lens=[25, 120, 24, 1]),
]
# chunks from zero, mid-page, across pages, deep in; rows above a tile
PREFILL_SWEEP = [
    dict(nh=4, nkv=2, hd=16, bt=8, W=6, chunk=8, starts=[0, 8, 19]),
    dict(nh=8, nkv=2, hd=8, bt=8, W=8, chunk=5, starts=[3, 0, 40]),
    dict(nh=2, nkv=2, hd=32, bt=16, W=3, chunk=16, starts=[0, 13]),
    dict(nh=4, nkv=4, hd=8, bt=8, W=5, chunk=17, starts=[1, 20]),
]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _random_paged(rng, b, nkv, hd, bt, W, lens, extra_pages=3):
    """Pages + tables realizing per-row lengths ``lens`` under shuffled
    page ids; unallocated entries hold sentinels N and N + 7."""
    needed = [-(-int(l) // bt) for l in lens]
    N = sum(needed) + extra_pages
    pk = rng.standard_normal((N, nkv, bt, hd)).astype(np.float32)
    pv = rng.standard_normal((N, nkv, bt, hd)).astype(np.float32)
    ids = rng.permutation(N)
    tables = np.full((b, W), N + 7, np.int32)
    nxt = 0
    for i, n in enumerate(needed):
        tables[i, :n] = ids[nxt:nxt + n]
        if n < W:
            tables[i, n] = N
        nxt += n
    return pk, pv, tables, N


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _slopes(nh, alibi):
    if not alibi:
        return None, None
    np.testing.assert_allclose(np.asarray(ref_alibi_slopes(nh)),
                               alibi_slopes(nh).numpy(), rtol=1e-7)
    return ref_alibi_slopes(nh), alibi_slopes(nh)


@pytest.mark.parametrize("case", [
    # decode tokens of ragged rows, one row freed (all-sentinel table)
    dict(b=3, chunk=1, bt=8, W=4, starts=[4, 15, 9], freed=[2]),
    # a chunk crossing a page boundary, and one running off the table
    dict(b=2, chunk=6, bt=8, W=3, starts=[5, 21], freed=[]),
    # prefill from zero over 16-token pages, a past-table tail
    dict(b=2, chunk=20, bt=16, W=2, starts=[0, 20], freed=[]),
])
def test_write_paged_kv_matches_reference(case):
    rng = np.random.default_rng(len(str(case)))
    b, chunk, bt, W = case["b"], case["chunk"], case["bt"], case["W"]
    nkv, hd = 2, 8
    lens = [min(s + chunk, W * bt) for s in case["starts"]]
    pk, pv, tables, N = _random_paged(rng, b, nkv, hd, bt, W, lens)
    for i in case["freed"]:
        tables[i] = N
    k_new = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    pos = (np.asarray(case["starts"])[:, None]
           + np.arange(chunk)[None]).astype(np.int32)
    rk, rv = ref_pa.write_paged_kv(jnp.asarray(pk), jnp.asarray(pv),
                                   jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(tables), jnp.asarray(pos))
    drop = np.full((1, nkv, bt, hd), 7.0, np.float32)
    tk, tv = _t(np.concatenate([pk, drop])), _t(np.concatenate([pv, drop]))
    pa.write_paged_kv(tk, tv, _t(k_new), _t(v_new), _t(tables),
                      _t(pos).long(), num_pages=N)
    np.testing.assert_array_equal(tk[:N].numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv[:N].numpy(), np.asarray(rv))
    dropped = (np.asarray(case["starts"])[:, None] + np.arange(chunk)
               >= W * bt).any() or case["freed"]
    assert bool((tk[N] != 7.0).any()) == bool(dropped)
    with pytest.raises(ValueError, match="drop page"):
        pa.write_paged_kv(tk[:N], tv[:N], _t(k_new), _t(v_new),
                          _t(tables), _t(pos).long(), num_pages=N)


def _decode_inputs(case, alibi):
    rng = np.random.default_rng(len(str(case)) + alibi)
    lens = case["lens"]
    b = len(lens)
    pk, pv, tables, N = _random_paged(rng, b, case["nkv"], case["hd"],
                                      case["bt"], case["W"], lens)
    q = rng.standard_normal((b, 1, case["nh"], case["hd"])
                            ).astype(np.float32)
    return q, pk, pv, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", SWEEP)
def test_gather_matches_reference(case, alibi):
    q, pk, pv, tables, lens = _decode_inputs(case, alibi)
    qpos = (lens - 1)[:, None]
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_gather_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(qpos), rs)
    got = pa.paged_gather_attention(_t(q), _t(pk), _t(pv), _t(tables),
                                    _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", SWEEP)
def test_decode_plain_matches_reference_kernel(case, alibi):
    """The decode kernel's plain version against ``_paged_kernel`` run in
    interpret mode, and through the CPU wrapper (which takes the plain
    version and counts no launch)."""
    q, pk, pv, tables, lens = _decode_inputs(case, alibi)
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens), rs, interpret=True)
    got = pa.paged_flash_attention_plain(_t(q), _t(pk), _t(pv), _t(tables),
                                         _t(lens), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    before = pa.paged_flash_attention.launches
    via = pa.paged_flash_attention(_t(q), _t(pk), _t(pv), _t(tables),
                                   _t(lens), ps)
    assert pa.paged_flash_attention.launches == before
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", PREFILL_SWEEP)
def test_prefill_plain_matches_reference_kernel(case, alibi):
    """The prefill kernel's plain version against ``_paged_prefill_kernel``
    in interpret mode and against the gather path: each row's chunk
    attends over its prior pages plus its own keys, already written."""
    rng = np.random.default_rng(len(str(case)) + alibi)
    starts, chunk = case["starts"], case["chunk"]
    b = len(starts)
    lens = [s + chunk for s in starts]
    pk, pv, tables, N = _random_paged(rng, b, case["nkv"], case["hd"],
                                      case["bt"], case["W"], lens)
    q = rng.standard_normal((b, chunk, case["nh"], case["hd"])
                            ).astype(np.float32)
    qpos = (np.asarray(starts)[:, None] + np.arange(chunk)).astype(np.int32)
    rs, ps = _slopes(case["nh"], alibi)
    want = ref_pa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(qpos), rs, interpret=True)
    got = pa.paged_prefill_attention(_t(q), _t(pk), _t(pv), _t(tables),
                                     _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gathered = pa.paged_gather_attention(_t(q), _t(pk), _t(pv), _t(tables),
                                         _t(qpos).long(), ps)
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), **TOL)


ROUTES = ("decode", "prefill", "gather")


def _record_routes(monkeypatch, module, names):
    """Replace the three attention paths of ``module`` by recorders that
    return q; returns the list the calls are appended to."""
    calls = []
    for name, route in zip(names, ROUTES):
        monkeypatch.setattr(module, name,
                            lambda q, *a, _r=route, **k: calls.append(_r)
                            or q)
    return calls


@pytest.mark.parametrize("chunk,nh,nkv,bt", [
    (1, 32, 4, 16),      # decode: the decode kernel
    (1, 4, 2, 12),       # pages not a multiple of 8: gather
    (2, 4, 2, 8),        # a short chunk: the prefill kernel
    (64, 32, 4, 16),     # 512 rows, the cap: the prefill kernel
    (33, 32, 4, 16),     # 264 rows padded to 264 <= 512: prefill
    (65, 32, 4, 16),     # 520 rows: gather
    (128, 32, 4, 16),    # a 128-token bucket at g = 8: gather
    (16, 16, 16, 16),    # MHA (bloom): 16 rows
    (5, 4, 4, 8),        # 5 rows padded to 8
])
def test_routing_matches_reference(monkeypatch, chunk, nh, nkv, bt):
    """``make_paged_attn_impl`` sends the same (chunk, group, page size)
    to the same path as the reference's with its kernels on, and the
    "plain" backend always gathers."""
    rng = np.random.default_rng(chunk * 100 + bt)
    b, hd, W = 2, 8, 12
    pk, pv, tables, N = _random_paged(rng, b, nkv, hd, bt, W, [20, 7])
    q = rng.standard_normal((b, chunk, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    pos = (np.asarray([3, 11])[:, None] + np.arange(chunk)).astype(np.int32)
    ref_calls = _record_routes(monkeypatch, ref_pa, (
        "paged_flash_attention", "paged_prefill_attention",
        "paged_gather_attention"))
    impl, bind = ref_pa.make_paged_attn_impl(bt, "pallas", interpret=True)
    bind(jnp.asarray(tables))
    impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(pk),
         jnp.asarray(pv), jnp.asarray(pos), 0, None)
    port_calls = _record_routes(monkeypatch, pa, (
        "paged_flash_attention", "paged_prefill_attention",
        "paged_gather_attention"))
    drop = np.zeros((1, nkv, bt, hd), np.float32)
    pools = _t(np.concatenate([pk, drop])), _t(np.concatenate([pv, drop]))
    for backend in ("auto", "plain"):
        impl, bind = pa.make_paged_attn_impl(bt, backend, num_pages=N)
        bind(_t(tables))
        impl(_t(q), _t(k), _t(k), *pools, _t(pos).long(), 0, None)
    assert port_calls == ref_calls + ["gather"]
    assert pa.paged_route(True, chunk, nh // nkv, bt) == ref_calls[0]


@pytest.mark.parametrize("chunk,nh,nkv,want", [
    (128, 32, 4, "prefill"),    # a 128-token bucket at g = 8: 1024 rows
    (65, 32, 4, "prefill"),     # 520 rows
    (64, 32, 4, "prefill"),     # 512 rows, the reference's cap
    (1, 32, 4, "decode"),
])
def test_cuda_routing_keeps_no_row_cap(monkeypatch, chunk, nh, nkv, want):
    """On the card the hook sends every contiguous chunk to the prefill
    kernel, past the reference's 512-row cap (its TPU kernel's VMEM
    bound), so the serialized admission's bucket-padded final and the
    same tokens in a mixed slab share one kernel; off the card the cap
    stays (test_routing_matches_reference)."""
    rng = np.random.default_rng(chunk)
    b, hd, bt, W = 2, 8, 16, 12
    pk, pv, tables, N = _random_paged(rng, b, nkv, hd, bt, W, [20, 7])
    q = rng.standard_normal((b, chunk, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, chunk, nkv, hd)).astype(np.float32)
    pos = (np.asarray([3, 11])[:, None] + np.arange(chunk)).astype(np.int32)
    calls = _record_routes(monkeypatch, pa, (
        "paged_flash_attention", "paged_prefill_attention",
        "paged_gather_attention"))
    drop = np.zeros((1, nkv, bt, hd), np.float32)
    impl, bind = pa.make_paged_attn_impl(bt, "auto", num_pages=N,
                                         device_type="cuda")
    bind(_t(tables))
    impl(_t(q), _t(k), _t(k), _t(np.concatenate([pk, drop])),
         _t(np.concatenate([pv, drop])), _t(pos).long(), 0, None)
    assert calls == [want]
    assert pa.paged_route(True, chunk, nh // nkv, bt, max_rows=None) == want


@pytest.mark.parametrize("backend,device_type,head_dim,bt,want", [
    ("auto", "cpu", 64, 16, True),
    ("auto", "cpu", 256, 16, True),     # the plain versions take any hd
    ("auto", "cpu", 64, 12, True),      # ... and route 12-token pages
    ("auto", "cuda", 64, 16, True),
    ("auto", "cuda", 128, 8, True),
    ("auto", "cuda", 80, 16, True),     # bloom3b
    ("auto", "cuda", 96, 16, True),     # bloom1b1
    ("cuda", "cuda", 256, 16, True),    # gemma
    ("cuda", "cuda", 64, 16, True),
    ("plain", "cuda", 256, 16, False),
    ("plain", "cuda", 64, 12, False),
    ("plain", "cpu", 64, 16, False),
    ("auto", "cuda", 48, 16, "'plain'"),   # never a silent plain path
    ("cuda", "cuda", 48, 16, "'plain'"),   # on CUDA
    ("auto", "cuda", 64, 12, "multiple of 8 tokens.*'plain'"),
    ("cuda", "cuda", 64, 4, "multiple of 8 tokens.*'plain'"),
    ("cuda", "cpu", 64, 16, "CUDA kernels"),
    ("xla", "cpu", 64, 16, "unknown paged attention backend"),
])
def test_paged_backend_resolution(backend, device_type, head_dim, bt, want):
    if isinstance(want, bool):
        assert pa.resolve_paged_backend(backend, device_type, head_dim,
                                        bt) is want
    else:
        with pytest.raises(ValueError, match=want):
            pa.resolve_paged_backend(backend, device_type, head_dim, bt)


def test_decode_wrapper_refuses_chunks():
    q = torch.zeros((1, 2, 4, 8))
    pages = torch.zeros((3, 2, 8, 8))
    with pytest.raises(ValueError, match="decode-only"):
        pa.paged_flash_attention(q, pages, pages,
                                 torch.zeros((1, 2), dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32))
