"""The port's live migration against the JAX package's.

``ContinuousBatchingEngine.export_request`` / ``import_request`` and
``runtime/migration.py`` (``MigrationWorker``'s two phases over a
loopback fabric, ``CoServingWorker``, ``MigrationController``) in the
port: a request decoding on one engine moves to another mid-stream; its
greedy tokens must equal the reference engine's unmigrated stream on the
same weights, at most the in-flight step replays, both pools end with
every page tree-owned, the target's staging drains, and the engines'
``migration`` stats fragments equal the reference's for the same
scenario.  The same over int8 pages, a speculative row (verify-boundary
export), a float8 pool (in process; the wire refuses it, as the
reference's does), and the abandon-on-timeout mailbox rule.  ``llama-test`` in f32
on the CPU.
"""

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.migration import \
    MigrationController as RefController
from distributed_inference_demo_tpu_torch.comm.transport import (
    LoopbackNetwork, LoopbackTransport)
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime import batching as B
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.disagg import PageStager
from distributed_inference_demo_tpu_torch.runtime.migration import (
    CoServingWorker, MigrationController, MigrationWorker)

GREEDY = SamplingParams(greedy=True)
PROMPT = (np.arange(17) % 50 + 3).astype(np.int32)
MAX_NEW = 48
WAIT = 120
KW = dict(max_seq=96, max_batch=2, kv_cache_blocks=32, kv_block_tokens=8)


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
def reference(weights):
    """The reference engine's unmigrated greedy stream, per (kv_dtype,
    prompt, max_new)."""
    rcfg, rp, _, _ = weights
    memo = {}

    def run(prompt, max_new, kv_dtype="bf16"):
        key = (kv_dtype, np.asarray(prompt).tobytes(), max_new)
        if key not in memo:
            eng = RefBatching(rcfg, rp, sampling=RefSamplingParams(
                greedy=True), kv_dtype=kv_dtype, **KW)
            try:
                memo[key] = eng.submit(prompt, max_new).wait(WAIT).tolist()
            finally:
                eng.close()
        return memo[key]
    return run


def _engine(weights, **kw):
    _, _, cfg, params = weights
    return ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                    device="cpu", **dict(KW, **kw))


def _wait_tokens(req, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(req.tokens) < n:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"only {len(req.tokens)}/{n} tokens within {timeout}s")
        time.sleep(0.002)


def _idle_no_leaks(*engines):
    """Idle: every allocated page is tree-owned (bounded wait for the
    asynchronous completions)."""
    deadline = time.monotonic() + 5.0
    while True:
        snaps = [e.kv_cache.snapshot() for e in engines]
        if all(s["blocks_used"] == s["tree_blocks"] for s in snaps):
            return
        if time.monotonic() > deadline:
            raise AssertionError("page leak: " + ", ".join(
                f"{s['blocks_used']}/{s['tree_blocks']}" for s in snaps))
        time.sleep(0.05)


def _seam(src, dst, rid):
    """Detach ``rid`` on src after two tokens and import it on dst with
    no wire between: (checkpoint, full token list)."""
    req = src.submit(PROMPT, MAX_NEW, request_id=rid)
    _wait_tokens(req, 2)
    ckpt = src.export_request(rid, detach=True)
    assert src.get_request(rid) is None
    return ckpt, dst.import_request(ckpt).wait(WAIT).tolist()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_export_import_roundtrip_equals_reference(weights, reference,
                                                  kv_dtype):
    """The checkpoint alone carries the row: the resumed stream equals
    the reference's unmigrated one, the checkpoint has the reference's
    schema, and both engines' ``migration`` fragments equal the
    reference engines' for the same seam."""
    rcfg, rp, _, _ = weights
    ref = reference(PROMPT, MAX_NEW, kv_dtype)
    src, dst = (_engine(weights, kv_dtype=kv_dtype) for _ in range(2))
    rsrc, rdst = (RefBatching(rcfg, rp, sampling=RefSamplingParams(
        greedy=True), kv_dtype=kv_dtype, **KW) for _ in range(2))
    try:
        ckpt, got = _seam(src, dst, "seam")
        rckpt, rgot = _seam(rsrc, rdst, "seam")
        assert got == rgot == ref
        assert set(ckpt) == set(rckpt)
        assert ckpt["tokens"] == ref[:len(ckpt["tokens"])]
        assert ckpt["length"] == len(PROMPT) + len(ckpt["tokens"]) - 1
        assert ckpt["kv_dtype"] == kv_dtype
        assert int(ckpt["k"].shape[0]) == -(-ckpt["length"] // 8)
        for e, r in ((src, rsrc), (dst, rdst)):
            assert e.stats()["migration"] == r.stats()["migration"]
            assert e.debug_state()["migration"] == \
                r.debug_state()["migration"]
        with pytest.raises(KeyError):
            src.export_request("no-such-rid")
        with pytest.raises(ValueError, match="kv_dtype"):
            other = "int8" if kv_dtype != "int8" else "bf16"
            ckpt2 = dict(ckpt, kv_dtype=other)
            dst.import_request(ckpt2)
        _idle_no_leaks(src, dst)
    finally:
        for e in (src, dst, rsrc, rdst):
            e.close()


@pytest.fixture(scope="module", params=["bf16", "int8"])
def pair(request, weights):
    """Two engines with migration workers on one loopback fabric."""
    net = LoopbackNetwork()
    src_e, dst_e = (_engine(weights, kv_dtype=request.param)
                    for _ in range(2))
    src_w = MigrationWorker(src_e, LoopbackTransport("src", net),
                            ack_timeout=10.0)
    dst_w = MigrationWorker(dst_e, LoopbackTransport("dst", net),
                            ack_timeout=10.0)
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in (src_w, dst_w)]
    for t in threads:
        t.start()
    yield SimpleNamespace(kv_dtype=request.param, src_e=src_e, dst_e=dst_e,
                          src_w=src_w, dst_w=dst_w)
    src_w.stop()
    dst_w.stop()
    for t in threads:
        t.join(timeout=2)
    src_e.close()
    dst_e.close()


def test_live_migration_over_loopback_equals_reference(pair, reference):
    """A request decoding on src moves to dst mid-flight: the client's
    stream never breaks, its tokens equal the reference's unmigrated
    stream, at most one boundary step replays, the target's staging
    drains, both pools end leak-free, and one trace id spans the
    source's and the target's spans."""
    ref = reference(PROMPT, MAX_NEW, pair.kv_dtype)
    pair.src_w.tracer.drain()
    pair.dst_w.tracer.drain()
    req = pair.src_e.submit(PROMPT, MAX_NEW, request_id="m1")
    _wait_tokens(req, 2)
    assert "m1" in pair.src_w.pick_migratable(4)
    replay_before = pair.src_w.stats["replayed_steps"]
    assert pair.src_w.migrate_out("m1", "dst") is True
    streamed = []
    while True:
        tok = req.stream.get(timeout=WAIT)
        if tok is None:
            break
        streamed.append(tok)
    assert req.error is None and req.done.is_set()
    assert [int(t) for t in req.wait(WAIT)] == ref
    assert streamed == ref                  # the stream never broke
    assert pair.src_w.stats["migrated_out"] >= 1
    assert pair.dst_w.stats["migrated_in"] >= 1
    assert pair.src_w.stats["moved_pages"] > 0
    assert pair.src_w.stats["moved_bytes"] > 0
    assert pair.src_w.stats["replayed_steps"] - replay_before <= 1
    assert pair.dst_w.stager._staged == {}
    assert pair.dst_w.staged_bytes == 0
    spans = pair.src_w.tracer.drain() + pair.dst_w.tracer.drain()
    assert {"migration_export", "migration_freeze", "migration_handoff",
            "migration_adopt"} <= {s["name"] for s in spans}
    assert len({s["trace_id"] for s in spans}) == 1
    _idle_no_leaks(pair.src_e, pair.dst_e)


def test_speculative_row_exports_at_a_verify_boundary(weights, reference):
    """A prompt-lookup row exports with its adaptive K and acceptance
    EWMA and resumes on a plain-configured twin: the target rebuilds its
    n-gram history from prompt + tokens, and the greedy stream equals
    the reference's unmigrated one."""
    ref = reference(PROMPT, MAX_NEW)
    src, dst = (_engine(weights, prompt_lookup=True, num_draft=2)
                for _ in range(2))
    try:
        ckpt, got = _seam(src, dst, "spec")
        assert got == ref
        assert ckpt["spec_k"] in src._spec_buckets
        assert 0.0 <= ckpt["spec_ewma"] <= 1.0
        _idle_no_leaks(src, dst)
    finally:
        src.close()
        dst.close()


def test_export_timeout_abandons_the_mailbox(weights, reference):
    """A scheduler stalled past ``export_request``'s timeout must not
    run the export later with no caller left: the box is abandoned, its
    late service is a no-op, and the row decodes on to the reference's
    stream."""
    eng = _engine(weights)
    release = threading.Event()
    try:
        ref = reference(PROMPT, MAX_NEW)
        req = eng.submit(PROMPT, MAX_NEW, request_id="ab")
        _wait_tokens(req, 1)
        entered = threading.Event()

        class _WedgedDone:
            @staticmethod
            def is_set():
                entered.set()
                release.wait(20)
                return True

        wedge = {"req": SimpleNamespace(rid="wedge", cancelled=False,
                                        done=_WedgedDone()),
                 "detach": False, "ckpt": None, "err": None,
                 "claimed": False, "abandoned": False,
                 "event": threading.Event()}
        with eng._submit_lock:
            eng._export_q.append(wedge)
            eng._queue.put(B._WAKE)
        assert entered.wait(20)
        with pytest.raises(TimeoutError, match="abandoned"):
            eng.export_request("ab", detach=True, timeout=0.2)
        release.set()
        assert req.wait(WAIT).tolist() == ref
        assert eng.migration_stats["detached_requests"] == 0
        assert eng.get_request("ab") is None
        assert isinstance(wedge["err"], ValueError)
    finally:
        release.set()
        eng.close()


class _FakeRegistry:
    def __init__(self, loads, draining=(), down=()):
        self.loads = dict(loads)
        self.draining = set(draining)
        self.down = set(down)

    def replica_ids(self):
        return sorted(self.loads)

    def is_up(self, rid):
        return rid not in self.down

    def is_draining(self, rid):
        return rid in self.draining

    def routable_replicas(self):
        return [r for r in sorted(self.loads)
                if r not in self.down and r not in self.draining]

    def set_draining(self, rid, flag=True):
        (self.draining.add if flag else self.draining.discard)(rid)

    def get(self, rid):
        if rid not in self.loads:
            return None
        return SimpleNamespace(
            last_stats={"active_slots": self.loads[rid], "queue_depth": 0})


@pytest.mark.parametrize("case", [
    (dict(loads={"a": 5, "b": 1}), dict(load_gap=2, max_moves_per_round=4)),
    (dict(loads={"a": 9, "b": 1}), dict(load_gap=2, max_moves_per_round=1)),
    (dict(loads={"a": 2, "b": 1}), dict(load_gap=2)),
    (dict(loads={"a": 2, "b": 1}, draining={"a"}),
     dict(load_gap=5, max_moves_per_round=8)),
    (dict(loads={"a": 3, "b": 1}, draining={"a", "b"}), dict()),
    (dict(loads={"a": 7}), dict(load_gap=1)),
    (dict(loads={"a": 6, "b": 0, "c": 2}, down={"b"}), dict(load_gap=1)),
])
def test_controller_policy_equals_reference(case):
    reg_kw, kw = case
    mover = lambda s, d, n: n                                  # noqa: E731
    port = MigrationController(_FakeRegistry(**reg_kw), mover, **kw)
    ref = RefController(_FakeRegistry(**reg_kw), mover, **kw)
    assert port.pick_rebalance() == ref.pick_rebalance()
    assert port.rebalance_once() == ref.rebalance_once()
    assert port.stats == ref.stats


def test_controller_drain_and_coserving_stager_rule():
    reg = _FakeRegistry({"a": 3, "b": 0})

    def mover(src, dst, n):
        moved = min(n, reg.loads[src])
        reg.loads[src] -= moved
        reg.loads[dst] += moved
        return moved

    c = MigrationController(reg, mover, max_moves_per_round=1)
    assert c.drain("a", deadline_s=5.0, poll_s=0.01) == 3
    assert reg.loads == {"a": 0, "b": 3} and "a" in reg.draining
    assert c.stats["drained_requests"] == 3
    net = LoopbackNetwork()
    t = LoopbackTransport("cs", net)
    dec = SimpleNamespace(stager=PageStager("cs"), transport=t,
                          device_id="cs")
    with pytest.raises(ValueError, match="share one PageStager"):
        CoServingWorker(dec, SimpleNamespace(stager=PageStager("cs")))
    co = CoServingWorker(dec, SimpleNamespace(stager=dec.stager))
    assert co.device_id == "cs" and co.transport is t


def test_float8_pool_moves_in_process_and_is_refused_by_the_wire(
        weights, reference):
    """A float8 page pool does what the reference's does: its checkpoint
    carries float8 pages and an in-process import resumes it (greedy,
    equal to the same engine's unmigrated stream); over the wire its
    page frame is refused with the reference's error, since the wire has
    no float8 code, and the row keeps decoding where it was."""
    from distributed_inference_demo_tpu.runtime.disagg import \
        _page_frame as ref_page_frame
    from distributed_inference_demo_tpu_torch.comm.wire import WireError
    import ml_dtypes
    src, dst = (_engine(weights, kv_cache_dtype="float8_e4m3fn")
                for _ in range(2))
    try:
        want = src.submit(PROMPT, MAX_NEW).wait(WAIT).tolist()
        ckpt, got = _seam(src, dst, "f8")
        assert ckpt["k"].dtype == torch.float8_e4m3fn and got == want
        net = LoopbackNetwork()
        w_src = MigrationWorker(src, LoopbackTransport("s", net),
                                ack_timeout=2.0)
        MigrationWorker(dst, LoopbackTransport("t", net), ack_timeout=2.0)
        req = src.submit(PROMPT, MAX_NEW, request_id="f8w")
        _wait_tokens(req, 2)
        with pytest.raises(WireError) as err:
            w_src.migrate_out("f8w", "t")
        f8 = np.zeros((1, 2), ml_dtypes.float8_e4m3fn)
        with pytest.raises(ValueError) as ref_err:
            ref_page_frame(f8, f8, 0)
        assert str(err.value) == str(ref_err.value)
        assert req.wait(WAIT).tolist() == want
        _idle_no_leaks(src, dst)
    finally:
        src.close()
        dst.close()
