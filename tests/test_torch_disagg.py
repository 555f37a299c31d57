"""The port's disaggregated prefill/decode (``runtime/disagg.py``) against
the JAX package's.

A port ``PrefillWorker`` prefills chunk by chunk (``InferenceEngine``'s
prefill programs over a dense row) and streams the prompt's whole blocks
as page frames to a port ``DecodeWorker``, whose batching engine adopts
them (``submit_premigrated``) and decodes; a ``DisaggCoordinator``
hands requests out.  Greedy tokens must equal the reference's colocated
engine on the same weights; the exported blocks equal the reference
worker's to 2e-4 (f32) and the frames' bytes and counts equal the
reference fabric's for the same requests; both pools end with every
page tree-owned; the decode side moves no byte host to device beyond
the adopt (``h2d_bytes`` 0).  Interop: a reference ``PrefillWorker``
streams pages over one ``LoopbackNetwork`` to a port ``DecodeWorker``.
``llama-test`` in f32 on the CPU.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.comm.transport import \
    LoopbackNetwork as RefNetwork
from distributed_inference_demo_tpu.comm.transport import \
    LoopbackTransport as RefTransport
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.base import KVCache as RefKVCache
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime import disagg as ref_disagg
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.comm.transport import (
    LoopbackNetwork, LoopbackTransport)
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import KVCache
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.disagg import (
    DecodeWorker, DisaggCoordinator, PrefillWorker)

GREEDY = SamplingParams(greedy=True)
WAIT = 120
MAX_SEQ = 64
PROMPTS = [(np.arange(n) % 50 + 3).astype(np.int32) for n in (37, 20, 9)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def colocated(weights):
    """The reference's colocated greedy stream (``InferenceEngine``)."""
    rcfg, rp, _, _ = weights
    eng = RefEngine(rcfg, rp, max_seq=MAX_SEQ,
                    sampling=RefSamplingParams(greedy=True))
    return lambda prompt, n: eng.generate(prompt[None], n).tokens[0].tolist()


def _fabric(pkg, weights, kv_dtype="bf16"):
    """(coordinator, prefill worker, decode worker, decode engine, stop)
    of one package on its own loopback network."""
    rcfg, rp, cfg, params = weights
    if pkg == "port":
        net, T = LoopbackNetwork(), LoopbackTransport
        engine = ContinuousBatchingEngine(
            cfg, params, max_seq=MAX_SEQ, max_batch=2, sampling=GREEDY,
            kv_cache_blocks=0, kv_dtype=kv_dtype, device="cpu")
        pw = PrefillWorker(cfg, params, T("p0", net), max_seq=MAX_SEQ,
                           prefill_chunk=8, kv_dtype=kv_dtype, device="cpu")
        dw = DecodeWorker(engine, T("d0", net))
        coord = DisaggCoordinator(T("coord", net), ["p0"], "d0")
    else:
        net, T = RefNetwork(), RefTransport
        engine = RefBatching(rcfg, rp, max_seq=MAX_SEQ, max_batch=2,
                             sampling=RefSamplingParams(greedy=True),
                             kv_cache_blocks=0, kv_dtype=kv_dtype)
        pw = ref_disagg.PrefillWorker(rcfg, rp, T("p0", net),
                                      max_seq=MAX_SEQ, prefill_chunk=8,
                                      kv_dtype=kv_dtype)
        dw = ref_disagg.DecodeWorker(engine, T("d0", net))
        coord = ref_disagg.DisaggCoordinator(T("coord", net), ["p0"], "d0")
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in (pw, dw)]
    for t in threads:
        t.start()

    def stop():
        pw.stop()
        dw.stop()
        for t in threads:
            t.join(timeout=5)
        coord.close()
        engine.close()
    return coord, pw, dw, engine, stop


def _no_pool_leaks(pw, engine):
    """Idle: the prefill worker has closed its last handoff (its ack
    round can finish after the coordinator heard the decode side), and
    both pools' pages are all tree-owned."""
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if pw._inflight_rid is not None or pw._backlog:
            time.sleep(0.02)
            continue
        d, p = engine.kv_cache.snapshot(), pw.kv_cache.snapshot()
        if (d["blocks_used"] == d["tree_blocks"]
                and p["blocks_used"] == p["tree_blocks"]):
            return
        time.sleep(0.05)
    raise AssertionError(f"page leak: decode {d}, prefill {p}")


def _counters(pw, dw, engine) -> dict:
    """The fabric's integer counters (the wall-clock fields left out)."""
    drop = ("last_migration_ms",)
    return {"prefill": {k: v for k, v in pw.stats.items() if k not in drop},
            "decode": {k: v for k, v in dw.stats.items() if k not in drop},
            "disagg": dict(engine.disagg_stats),
            "prefill_pool": pw.kv_cache.stats,
            "h2d": engine.kv_cache.snapshot()["h2d_bytes"]}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_disagg_fabric_equals_reference(weights, colocated, kv_dtype):
    """Three requests (a repeat prompt hits the prefill worker's tree, a
    short one ships no page), then a join the decode side refuses: the
    port fabric's tokens equal the reference fabric's, and its counters
    (pages, frame bytes, retransmits, adopted pages, the prefill pool's
    hits) equal the reference's exactly.  Over full-width pages the
    tokens are the colocated engine's."""
    got = {}
    for pkg in ("ref", "port"):
        coord, pw, dw, engine, stop = _fabric(pkg, weights, kv_dtype)
        try:
            toks = [coord.submit(p, 6).wait(timeout=WAIT).tolist()
                    for p in PROMPTS + [PROMPTS[0]]]
            with pytest.raises(RuntimeError,
                               match="exceeds KV-cache capacity"):
                coord.submit(PROMPTS[0], 60).wait(timeout=WAIT)
            _no_pool_leaks(pw, engine)
            got[pkg] = (toks, _counters(pw, dw, engine))
            assert pw.debug_state()["role"] == "prefill"
            assert dw.debug_state()["staged_migrations"] == {}
            assert coord.debug_state()["alive_prefill_workers"] == ["p0"]
        finally:
            stop()
    assert got["port"] == got["ref"]
    toks, counters = got["port"]
    assert counters["h2d"] == 0
    # every migrated page adopted but the refused join's two
    assert counters["decode"]["adopted_pages"] == \
        counters["prefill"]["migrated_pages"] - 2 > 0
    assert counters["prefill_pool"]["hits"] >= 1
    if kv_dtype == "bf16":
        assert toks == [colocated(p, 6) for p in PROMPTS + [PROMPTS[0]]]


def test_exported_blocks_equal_reference_worker(weights):
    """The prefill worker's chunked row and its block export: the port's
    blocks equal the reference worker's to 2e-4 (f32)."""
    rcfg, rp, cfg, params = weights
    prompt = (np.arange(33) % 43 + 2).astype(np.int32)
    bt, C = 16, 8
    n_mig = (len(prompt) - 1) // bt
    rpw = ref_disagg.PrefillWorker(rcfg, rp, RefTransport("rp", RefNetwork()),
                                   max_seq=MAX_SEQ, prefill_chunk=C)
    row = RefKVCache.create(rcfg, rcfg.num_layers, 1, MAX_SEQ)
    cache = RefKVCache(row.keys, row.values, jnp.int32(0))
    ppw = PrefillWorker(cfg, params, LoopbackTransport("pp", LoopbackNetwork()),
                        max_seq=MAX_SEQ, prefill_chunk=C, device="cpu")
    prow = KVCache.create(cfg, cfg.num_layers, 1, MAX_SEQ + C)
    for pos in range(0, n_mig * bt, C):
        chunk = np.zeros((1, C), np.int32)
        step = min(C, n_mig * bt - pos)
        chunk[0, :step] = prompt[pos:pos + step]
        cache = rpw._chunk_mid(rpw.params, jnp.asarray(chunk), cache,
                               jnp.int32(pos))
        prow = ppw._chunk_mid(torch.from_numpy(chunk.astype(np.int64)),
                              KVCache(prow.keys, prow.values, pos), pos)
    rk, rv = rpw._export_blocks(cache.keys, cache.values, 0, n_mig)
    pk, pv = ppw._export_blocks(prow.keys, prow.values, 0, n_mig)
    assert tuple(pk.shape) == rk.shape
    np.testing.assert_allclose(pk.numpy(), rk, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(pv.numpy(), rv, rtol=2e-4, atol=2e-4)


def test_reference_prefill_worker_feeds_a_port_decode_worker(weights,
                                                             colocated):
    """Interop: a reference ``PrefillWorker`` and coordinator on the
    reference's ``LoopbackNetwork``, a port ``DecodeWorker`` on the same
    fabric.  The reference's f32 page frames adopt into the port's pool
    and the greedy tokens equal the reference's colocated engine's."""
    rcfg, rp, cfg, params = weights
    net = RefNetwork()
    engine = ContinuousBatchingEngine(
        cfg, params, max_seq=MAX_SEQ, max_batch=2, sampling=GREEDY,
        kv_cache_blocks=0, device="cpu")
    pw = ref_disagg.PrefillWorker(rcfg, rp, RefTransport("p0", net),
                                  max_seq=MAX_SEQ, prefill_chunk=8)
    dw = DecodeWorker(engine, LoopbackTransport("d0", net))
    coord = ref_disagg.DisaggCoordinator(RefTransport("coord", net),
                                         ["p0"], "d0")
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in (pw, dw)]
    for t in threads:
        t.start()
    try:
        for p in PROMPTS:
            assert coord.submit(p, 6).wait(timeout=WAIT).tolist() == \
                colocated(p, 6)
        assert dw.stats["adopted_pages"] == pw.stats["migrated_pages"] > 0
        assert engine.disagg_stats["premigrated_requests"] == 2
        assert engine.kv_cache.snapshot()["h2d_bytes"] == 0
        _no_pool_leaks(pw, engine)
    finally:
        pw.stop()
        dw.stop()
        for t in threads:
            t.join(timeout=5)
        coord.close()
        engine.close()


def test_submit_premigrated_validates_and_dedups(weights):
    """The join seam's refusals are the reference's, and the decode
    worker drops duplicate, out-of-order and stale-attempt frames."""
    rcfg, rp, cfg, params = weights
    eng = ContinuousBatchingEngine(cfg, params, max_seq=MAX_SEQ,
                                   max_batch=1, sampling=GREEDY,
                                   kv_cache_blocks=0, device="cpu")
    ref = RefBatching(rcfg, rp, max_seq=MAX_SEQ, max_batch=1,
                      sampling=RefSamplingParams(greedy=True),
                      kv_cache_blocks=0)
    try:
        bt = eng.kv_cache.block_tokens
        prompt = np.arange(2 * bt + 1, dtype=np.int32) + 2
        good = np.zeros((2, cfg.num_layers, cfg.num_kv_heads, bt,
                         cfg.head_dim), np.float32)
        for args in ((prompt, 4, good[:, :, :, :-1], good[:, :, :, :-1]),
                     (prompt[:bt], 4, good, good)):
            errs = []
            for e, conv in ((ref, lambda a: a), (eng, torch.from_numpy)):
                with pytest.raises(ValueError) as err:
                    e.submit_premigrated(args[0], args[1], conv(args[2]),
                                         conv(args[3]))
                errs.append(str(err.value).replace("torch.Size", ""))
            assert errs[0].split(";")[0] == errs[1].split(";")[0]
        assert eng.submit_premigrated(prompt, 2, None, None).wait(
            timeout=WAIT).shape == (2,)
    finally:
        eng.close()
        ref.close()

    class _NoJoin:
        def submit_premigrated(self, *a, **k):
            raise AssertionError("no join expected")

    from distributed_inference_demo_tpu_torch.runtime.disagg import \
        _page_frame
    net = LoopbackNetwork()
    dw = DecodeWorker(_NoJoin(), LoopbackTransport("dx", net))
    LoopbackTransport("px", net)
    blk = torch.zeros(1, cfg.num_layers, cfg.num_kv_heads, 16, cfg.head_dim)
    f0 = _page_frame(blk, blk, 0)
    assert dw.handle_message("pg:r9:0:0", f0)
    dw.handle_message("pg:r9:0:0", f0)          # duplicate
    dw.handle_message("pg:r9:0:3", f0)          # hole
    assert dw._staged["r9"]["expected"] == 1
    dw.handle_message("pg:r9:1:0", f0)          # a newer attempt
    assert dw._staged["r9"]["attempt"] == 1
    dw.handle_message("pg:r9:0:1", f0)          # the stale attempt's
    assert dw.stats["dropped_frames"] == 3
