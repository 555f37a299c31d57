"""The torch port's host ``KVCacheManager`` against the JAX package's.

The reference's own manager cases (``tests/test_kvcache.py``) run on
both managers with the same inputs, step by step: lease tokens and
block ids, gathered runs, ``peek``, the blocks each store adds,
``snapshot`` and ``debug_state`` equal, through LRU eviction under live
leases and a random workload.  The port's ``store`` also takes the
device cache as torch tensors; a bf16 cache's blocks come back as their
bits.
"""

import types

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.runtime import \
    KVCacheManager as RefManager
from distributed_inference_demo_tpu.runtime.kvcache import \
    KVLease as RefLease
from distributed_inference_demo_tpu_torch import runtime as port_runtime
from distributed_inference_demo_tpu_torch.comm.wire import Bf16Bits
from distributed_inference_demo_tpu_torch.runtime.kvcache import (
    KVCacheManager, KVLease)


def _pair(num_blocks=8, bt=4, L=2, H=2, D=4):
    return [cls(L, H, D, num_blocks=num_blocks, block_tokens=bt,
                dtype=np.float32) for cls in (RefManager, KVCacheManager)]


def _row(rng, L=2, H=2, D=4, S=64):
    return (rng.normal(size=(L, 1, H, S, D)).astype(np.float32),
            rng.normal(size=(L, 1, H, S, D)).astype(np.float32))


def _same_lease(ref, got):
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert isinstance(ref, RefLease) and isinstance(got, KVLease)
    assert got.tokens == ref.tokens
    assert got.block_ids == ref.block_ids
    for a, b in zip(ref.gather(), got.gather()):
        np.testing.assert_array_equal(b, a)


def _same_state(ref, got):
    assert got.snapshot() == ref.snapshot()
    assert got.debug_state() == ref.debug_state()
    assert got.epoch == ref.epoch


def test_exports_equal_the_reference():
    assert port_runtime.KVCacheManager is KVCacheManager
    assert {"KVCacheManager", "ContinuousBatchingEngine", "ElasticHeader",
            "ElasticStageRuntime", "ElasticWorker"} <= set(
                port_runtime.__all__)
    for name in ("ContinuousBatchingEngine", "ElasticHeader",
                 "ElasticStageRuntime", "ElasticWorker"):
        assert getattr(port_runtime, name).__name__ == name


def test_match_caps_below_prompt_and_roundtrips_data():
    k, v = _row(np.random.default_rng(2))
    ref, got = _pair()
    prompt = np.arange(12)
    longer = np.concatenate([prompt, [7, 7, 7, 7, 7]])
    for m in (ref, got):
        assert m.match(prompt) is None
        assert m.store(prompt, k, v) == 3
    leases = [m.match(prompt) for m in (ref, got)]
    _same_lease(*leases)
    assert leases[1].tokens == 8
    for lease in leases:
        np.testing.assert_array_equal(lease.gather()[0], k[:, 0, :, :8])
    for lease in leases:
        lease.release()
    with ref.match(longer) as a, got.match(longer) as b:
        _same_lease(a, b)
        _same_state(ref, got)
    assert got.peek(longer) == ref.peek(longer) == 12
    _same_state(ref, got)
    with pytest.raises(RuntimeError, match="released lease"):
        b.gather()


def test_store_skips_existing_blocks():
    k, v = _row(np.random.default_rng(3))
    ref, got = _pair()
    tail = np.concatenate([np.arange(8), [50, 51, 52, 53]])
    for m in (ref, got):
        assert m.store(np.arange(8), k, v) == 2
        assert m.store(tail, k, v) == 1
    _same_state(ref, got)
    assert got.snapshot()["blocks_used"] == 3


def test_eviction_honors_live_leases():
    rng = np.random.default_rng(4)
    ref, got = _pair(num_blocks=4, bt=4)
    k, v = _row(rng)
    prompt = np.arange(8)
    probe = np.concatenate([prompt, [9]])
    for m in (ref, got):
        m.store(prompt, k, v)
    leases = [m.match(probe) for m in (ref, got)]
    _same_lease(*leases)
    for _ in range(6):
        ids, row = rng.integers(100, 200, size=12), _row(rng)
        assert got.store(ids, *row) == ref.store(ids, *row)
        _same_state(ref, got)
        assert got.snapshot()["blocks_used"] <= 4
    for lease in leases:
        np.testing.assert_array_equal(lease.gather()[0], k[:, 0, :, :8])
        lease.release()
    for _ in range(4):
        ids, row = rng.integers(200, 300, size=16), _row(rng)
        assert got.store(ids, *row) == ref.store(ids, *row)
    assert got.peek(probe) == ref.peek(probe)
    _same_state(ref, got)


def test_accounting_balances_to_zero_after_drain():
    rng = np.random.default_rng(5)
    ref, got = _pair(num_blocks=8, bt=4)
    for _ in range(5):
        ids = rng.integers(0, 50, size=rng.integers(4, 20))
        row = _row(rng)
        assert got.store(ids, *row) == ref.store(ids, *row)
        got.tree.check()
    for m in (ref, got):
        while True:
            freed = m.tree.evict_lru_leaf()
            if not freed:
                break
            m.pool.free(freed)
    _same_state(ref, got)
    snap = got.snapshot()
    assert (snap["blocks_used"], snap["resident_bytes"], snap["nodes"]) \
        == (0, 0, 0)


@pytest.mark.parametrize("seed,num_blocks,bt", [(6, 6, 2), (7, 5, 3)])
def test_random_workload_equal_step_by_step(seed, num_blocks, bt):
    """The reference's random match / store / release sweep, both
    managers on the same ops: every lease, gather, store count and
    snapshot equal at every step, and the pool never over-commits."""
    rng = np.random.default_rng(seed)
    ref, got = _pair(num_blocks=num_blocks, bt=bt)
    leases = []
    for _ in range(300):
        op = rng.random()
        prompt = rng.integers(0, 4, size=rng.integers(2, 14))
        if op < 0.45:
            row = _row(rng)
            assert got.store(prompt, *row) == ref.store(prompt, *row)
        elif op < 0.8:
            pair = (ref.match(prompt), got.match(prompt))
            _same_lease(*pair)
            if pair[0] is not None and len(leases) < 3:
                leases.append(pair)
            elif pair[0] is not None:
                for lease in pair:
                    lease.release()
        elif leases:
            for lease in leases.pop(rng.integers(len(leases))):
                lease.release()
        got.tree.check()
        _same_state(ref, got)
        assert got.pool.free_blocks + got.pool.used_blocks == num_blocks
    for pair in leases:
        for lease in pair:
            lease.release()
    _same_state(ref, got)


def test_byte_budget_and_for_model(monkeypatch):
    ref, got = _pair(num_blocks=8, bt=4)
    assert got.pool.block_bytes == ref.pool.block_bytes
    monkeypatch.setenv("DWT_KVCACHE_BYTES", str(3 * got.pool.block_bytes))
    ref, got = _pair(num_blocks=8, bt=4)
    assert got.pool.num_blocks == ref.pool.num_blocks == 3
    cfg = types.SimpleNamespace(num_layers=2, num_kv_heads=2, head_dim=4,
                                dtype=np.float32)
    tcfg = types.SimpleNamespace(num_layers=2, num_kv_heads=2, head_dim=4,
                                 dtype=torch.float32)
    monkeypatch.setenv("DWT_KVCACHE_BYTES", "1")
    assert RefManager.for_model(cfg, 8, 4) is None
    assert KVCacheManager.for_model(tcfg, 8, 4) is None
    monkeypatch.delenv("DWT_KVCACHE_BYTES")
    got = KVCacheManager.for_model(tcfg, 8, 4)
    assert got.snapshot() == RefManager.for_model(cfg, 8, 4).snapshot()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_store_takes_torch_cache_rows(dtype):
    """A torch cache ``[L, B, H, S, D]`` (row 1 of 2) stores the same
    blocks as its numpy twin; a bf16 cache's run comes back as its
    bits (``Bf16Bits``), equal to the tensor's."""
    rng = np.random.default_rng(8)
    k, v = (torch.from_numpy(rng.normal(size=(2, 2, 2, 32, 4))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    got = KVCacheManager(2, 2, 4, num_blocks=8, block_tokens=4, dtype=dtype)
    ref = RefManager(2, 2, 4, num_blocks=8, block_tokens=4,
                     dtype=np.float32)
    prompt = np.arange(13)
    assert got.store(prompt, k, v, row=1) == 3
    assert ref.store(prompt, k.float().numpy(), v.float().numpy(),
                     row=1) == 3
    with got.match(prompt) as lease, ref.match(prompt) as rlease:
        gk, gv = lease.gather()
        assert lease.tokens == rlease.tokens == 12
        if dtype == torch.bfloat16:
            assert isinstance(gk, Bf16Bits)
            want = k[:, 1, :, :12].view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(gk, want)
            gk = torch.from_numpy(gk.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(gk, rlease.gather()[0])
    snap = got.snapshot()
    assert snap["capacity_bytes"] == 8 * 2 * 2 * 2 * 4 * 4 * \
        torch.empty(0, dtype=dtype).element_size()
