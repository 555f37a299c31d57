"""The bf16 decode kernel's split arithmetic against the JAX package.

``paged_decode_split_plain`` computes each split's unnormalised (acc, m,
l) at fixed positions ``kv_split`` apart and merges the live splits in
split order, as the CUDA kernel does; the same numpy inputs go through
the reference's ``_paged_kernel`` (via ``paged_flash_attention``) in
interpret mode, as the JAX package's own tests run it.  llama-test heads
(4 q heads, 2 kv heads, head_dim 16); floats agree to rtol/atol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.ops import paged_attention as ref_pa
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu_torch.models.bridge import \
    kv_pages_from_numpy
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes

TOL = dict(rtol=2e-4, atol=2e-4)
NH, NKV, HD = 4, 2, 16          # llama-test

# (page tokens, table width, keys per split, row lengths; None: a freed
# slot, all-sentinel table, at a stale length of 30)
CASES = {
    "shorter_than_a_split": (8, 8, 32, [5, 20, 1]),
    "exactly_splits": (8, 8, 32, [32, 64]),
    "boundary_mid_page": (24, 4, 32, [40, 70, 96]),
    "freed_slot": (8, 6, 16, [None, 23]),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(seed, bt, W, lens, pages):
    """q, the reference's pools, the port's pools, tables and kv_lens for
    ``lens`` under shuffled page ids (sentinels N and N + 7)."""
    rng = np.random.default_rng(seed)
    live = [30 if n is None else n for n in lens]
    need = [0 if n is None else -(-n // bt) for n in lens]
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
            # without the drop page: sentinels clamp to page N - 1 in both
            port_pools.append(kv_pages_from_numpy(
                np.asarray(qp.data), np.asarray(qp.scale), None, 8,
                "cpu")[:N])
        else:
            ref_pools.append(jnp.asarray(x))
            port_pools.append(_t(x))
    return q, ref_pools, port_pools, tables, np.asarray(live, np.int32)


@pytest.mark.parametrize("pages", ["full", "int8"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_plain_matches_reference_kernel(name, alibi, pages):
    bt, W, kv_split, lens = CASES[name]
    q, (rk, rv), (tk, tv), tables, kv_lens = _inputs(
        len(name) + alibi, bt, W, lens, pages)
    rs, ps = (ref_alibi_slopes(NH), alibi_slopes(NH)) if alibi else (None,
                                                                    None)
    want = ref_pa.paged_flash_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(tables), jnp.asarray(kv_lens),
        rs, interpret=True)
    got = pa.paged_decode_split_plain(_t(q), tk, tv, _t(tables),
                                      _t(kv_lens), ps, kv_split=kv_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one split of the whole table is the unsplit plain version
    whole = pa.paged_decode_split_plain(_t(q), tk, tv, _t(tables),
                                        _t(kv_lens), ps, kv_split=W * bt)
    np.testing.assert_allclose(
        whole.numpy(), pa.paged_flash_attention_plain(
            _t(q), tk, tv, _t(tables), _t(kv_lens), ps).numpy(), **TOL)


def test_split_plain_zero_length_row_and_default_split():
    """A row with kv_len 0 gives exactly 0; at the default KV_SPLIT, on a
    table wider than one split, the result is the plain version's."""
    bt, W = 16, 24                       # 384 positions: 3 splits of 128
    q, _, (tk, tv), tables, _ = _inputs(5, bt, W, [300, 129, 7], "full")
    kv_lens = torch.tensor([300, 0, 129], dtype=torch.int32)
    got = pa.paged_decode_split_plain(_t(q), tk, tv, _t(tables), kv_lens)
    assert pa.decode_splits(W, bt) == 3
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    want = pa.paged_flash_attention_plain(_t(q), tk, tv, _t(tables),
                                          kv_lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("W,bt,kv_split,want", [
    (128, 16, 128, 16),      # the serving table: 2048 positions
    (1, 16, 128, 1),         # less than one split
    (8, 16, 128, 1),         # exactly one split
    (9, 16, 128, 2),         # one position past it
    (3, 24, 32, 3),          # 72 positions, boundaries mid-page
    (128, 16, 256, 8),
])
def test_decode_splits(W, bt, kv_split, want):
    assert pa.decode_splits(W, bt, kv_split) == want


def test_decode_splits_refuses_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        pa.decode_splits(0, 16)
    with pytest.raises(ValueError, match="positive"):
        pa.decode_splits(4, 16, 0)
