"""The port's gateway (``runtime/gateway/``) against the JAX package's.

The router and the registry are copies: the same calls give the same
route decisions (policy, replica, match, candidates), routing tables and
registry states, exactly, with the tier second chance fed by a port
replica's ``/stats`` digest.  End to end, the same wire contract both
ways: the port gateway in front of port replicas, the reference gateway
in front of port replicas, and the port gateway in front of reference
replicas.  Replica 0 dies mid-stream through a ``comm/faults``
``crash_after`` rule; the client's streamed answer must equal the
unfailed answer, step numbers continuous, with the survivor counting one
resumed request and no page leak.  ``llama-test`` in f32 on the CPU.
"""

import json
import threading
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.comm.faults import \
    FaultPlan as RefFaultPlan
from distributed_inference_demo_tpu.comm.faults import \
    FaultRule as RefFaultRule
from distributed_inference_demo_tpu.comm.faults import \
    InjectedCrash as RefInjectedCrash
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime import gateway as ref_gateway
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.comm.faults import (
    FaultPlan, FaultRule, InjectedCrash)
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime import gateway
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.runtime.kvcache.tiered import \
    chain_digests

WAIT = 120
PKGS = {"port": (gateway, InferenceHTTPServer, FaultPlan, FaultRule,
                 InjectedCrash),
        "ref": (ref_gateway, RefServer, RefFaultPlan, RefFaultRule,
                RefInjectedCrash)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _decision(d):
    return (d.rid, d.policy, d.match_tokens, list(d.candidates))


def _drive_router(mod, tier_stats):
    """A fixed script of router calls; returns everything it observed."""
    loads = {}

    def prober(h, p):
        return {"queue_depth": loads.get(p, 0),
                "pending_prefill_tokens": 0}

    reg = mod.ReplicaRegistry([("10.0.0.1", 7000 + i) for i in range(3)],
                              prober=prober)
    router = mod.PrefixAwareRouter(reg, min_prefix_tokens=16,
                                   block_tokens=8)
    rids = reg.replica_ids()
    out = []
    toks = list(range(200, 232))
    out.append(_decision(router.route(toks)))               # hash
    router.reconcile(rids[1], tier_stats)                   # tier digest
    out.append(_decision(router.route(toks)))               # host_tier
    router.record(rids[0], toks)
    out.append(_decision(router.route(toks)))               # prefix
    out.append(_decision(router.route(list(range(500, 516)))))
    for i in range(5):
        router.acquire(rids[2])
    loads[7002] = 9
    reg.probe_all()
    out.append(_decision(router.route(list(range(900, 940)))))
    router.flush_replica(rids[1])
    out.append(router.tier_match_tokens(rids[1], toks))
    out.append(router.routing_table())
    return out


def test_router_decisions_equal_reference_with_a_port_tier_digest(tmp_path):
    """The tier second chance reads the digest a port replica publishes
    (its ``/stats`` kvcache fragment); every decision and the routing
    table equal the reference router's on the same calls."""
    toks = list(range(200, 232))
    keys = [tuple(toks[i * 8:(i + 1) * 8]) for i in range(4)]
    digest = [d.hex()[:16] for d in chain_digests(keys)]
    stats = {"kvcache": {"tier": {"block_tokens": 8, "digest": digest}}}
    got = _drive_router(gateway, stats)
    assert got == _drive_router(ref_gateway, stats)
    assert [g[1] for g in got[:4]] == ["hash", "host_tier", "prefix",
                                       "hash"]


def test_registry_debounce_equals_reference():
    """Eviction after ``sustain`` failures, cooldown, readmission and
    draining: the same injected clock and events give the same registry
    views and debug state."""
    def drive(mod):
        clock = _Clock()
        reg = mod.ReplicaRegistry([("h", 1), ("h", 2)], sustain=2,
                                  readmit_cooldown_s=5.0, clock=clock,
                                  prober=lambda h, p: {"queue_depth": p})
        out = []
        for event in ("fail", "fail", "ok", "tick", "ok", "ok"):
            if event == "fail":
                reg.record_failure("h:1", reason="probe: refused")
            elif event == "tick":
                clock.t += 6.0
            else:
                reg.record_success("h:1", {"queue_depth": 3})
            out.append((reg.up_replicas(), reg.routable_replicas()))
        reg.set_draining("h:2")
        out.append((reg.routable_replicas(), reg.is_draining("h:2")))
        state = reg.debug_state()
        out.append({k: v for k, v in state.items() if "age" not in k})
        out.append(dict(reg.failure_reasons))
        return out
    assert drive(gateway) == drive(ref_gateway)


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


def _engine(pkg, weights, sampled):
    rcfg, rp, cfg, params = weights
    kw = dict(max_seq=96, max_batch=2, kv_cache_blocks=0,
              kv_block_tokens=8, seed=11)
    if pkg == "port":
        return ContinuousBatchingEngine(
            cfg, params, device="cpu", sampling=(
                SamplingParams(temperature=0.9, top_k=40) if sampled
                else SamplingParams(greedy=True)), **kw)
    return RefBatching(rcfg, rp, sampling=(
        RefSamplingParams(temperature=0.9, top_k=40) if sampled
        else RefSamplingParams(greedy=True)), **kw)


class _CrashyBackend:
    """An engine whose token stream consults a fault plan: the
    crash_after rule raises mid-stream, a replica dying between decode
    steps (its server turns it into an error line)."""

    def __init__(self, inner, plan, crash, rid):
        self._inner, self._plan, self._crash, self._rid = \
            inner, plan, crash, rid

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def generate_stream(self, *a, **kw):
        for item in self._inner.generate_stream(*a, **kw):
            ev = self._plan.on_recv(self._rid)
            if ev is not None:
                raise self._crash(f"{self._rid}: injected crash_after "
                                  f"(seq {ev.get('seq')})")
            yield item


def _post_stream(host, port, body):
    conn = HTTPConnection(host, port, timeout=WAIT)
    try:
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        headers = dict(resp.getheaders())
        lines = [json.loads(ln) for ln in resp.read().splitlines()
                 if ln.strip()]
        return resp.status, headers, lines
    finally:
        conn.close()


@pytest.mark.parametrize("gw_pkg,rep_pkg,sampled", [
    ("port", "port", False),
    ("port", "port", True),
    ("ref", "port", False),
    ("port", "ref", False),
], ids=["port-port", "port-port-sampled", "ref-gateway-port-replicas",
        "port-gateway-ref-replicas"])
def test_midstream_crash_resumes_equal_to_the_unfailed_answer(
        weights, gw_pkg, rep_pkg, sampled):
    gw_mod = PKGS[gw_pkg][0]
    _, server_cls, plan_cls, rule_cls, crash = PKGS[rep_pkg]
    plan = plan_cls(seed=7, rules=[rule_cls(kind="crash_after", n_msgs=3,
                                            max_count=1)])
    engines = [_engine(rep_pkg, weights, sampled) for _ in range(2)]
    servers = []
    for i, eng in enumerate(engines):
        backend = (_CrashyBackend(eng, plan, crash, "replica0") if i == 0
                   else eng)
        srv = server_cls(backend, port=0)
        srv.start()
        servers.append(srv)
    registry = gw_mod.ReplicaRegistry([(s.host, s.port) for s in servers],
                                      sustain=3, readmit_cooldown_s=60.0,
                                      probe_interval_s=0.2)
    router = gw_mod.PrefixAwareRouter(registry, min_prefix_tokens=8,
                                      block_tokens=8)
    gw = gw_mod.GatewayHTTPServer(registry, router, port=0, retry_limit=1,
                                  resume_limit=1)
    threading.Thread(target=gw.httpd.serve_forever, daemon=True).start()
    try:
        toks = list(range(2, 18))
        router.record(f"{servers[0].host}:{servers[0].port}", toks)
        body = {"prompt_ids": [toks], "max_new_tokens": 8, "stream": True}
        st, _, ref_lines = _post_stream(servers[1].host, servers[1].port,
                                        body)
        assert st == 200
        want = [d["tokens"][0] for d in ref_lines]
        assert len(want) == 8
        st, headers, lines = _post_stream(gw.host, gw.port, body)
        assert st == 200
        assert [e["kind"] for e in plan.events] == ["crash_after"]
        assert not any("error" in d for d in lines)
        assert [d["tokens"][0] for d in lines] == want
        assert [d["step"] for d in lines] == list(range(8))
        st1 = engines[1].stats()
        assert st1["resumed"]["requests"] == 1
        assert st1["resumed"]["diverged"] == 0
        mgr = engines[1].kv_cache
        assert mgr.used_blocks == mgr.tree.block_count
    finally:
        gw.shutdown()
        for srv, eng in zip(servers, engines):
            srv.shutdown()
            eng.close()


class _SeveringStub:
    """A replica double streaming 8 fixed tokens as chunked JSONL that
    honors ``resume`` (starting after the delivered prefix, steps
    continued) and, with ``sever_after``, kills its socket after that
    many lines.  It records every resume payload it receives: the
    gateway's journal, as the survivor sees it."""

    TOKENS = list(range(100, 108))

    def __init__(self, sever_after=None):
        import socket
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.resumes = []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"queue_depth": 0}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                start = 0
                if req.get("resume") is not None:
                    outer.resumes.append(req["resume"])
                    start = len(req["resume"]["delivered_tokens"])
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for i in range(start, len(outer.TOKENS)):
                    if sever_after is not None and i - start >= sever_after:
                        self.wfile.flush()
                        self.close_connection = True
                        self.connection.shutdown(socket.SHUT_RDWR)
                        return
                    data = json.dumps({"step": i, "tokens": [
                        outer.TOKENS[i]]}).encode() + b"\n"
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.host, self.port = self.httpd.server_address
        self.rid = f"{self.host}:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_journal_and_resume_payload_equal_reference():
    """A replica's socket dies after 3 lines: both gateways forward the
    same client lines and send the survivor the same resume payload
    (the journal of delivered tokens)."""
    got = []
    for mod in (gateway, ref_gateway):
        dead, alive = _SeveringStub(sever_after=3), _SeveringStub()
        registry = mod.ReplicaRegistry(
            [(dead.host, dead.port), (alive.host, alive.port)],
            readmit_cooldown_s=60.0)
        router = mod.PrefixAwareRouter(registry, min_prefix_tokens=8,
                                       block_tokens=8)
        gw = mod.GatewayHTTPServer(registry, router, port=0,
                                   resume_limit=1)
        threading.Thread(target=gw.httpd.serve_forever, daemon=True).start()
        try:
            toks = list(range(2, 18))
            router.record(dead.rid, toks)
            st, _, lines = _post_stream(gw.host, gw.port, {
                "prompt_ids": [toks], "max_new_tokens": 8, "stream": True})
            got.append((st, lines, alive.resumes))
        finally:
            gw.shutdown()
            dead.close()
            alive.close()
    assert got[0] == got[1]
    st, lines, resumes = got[0]
    assert [d["tokens"][0] for d in lines] == _SeveringStub.TOKENS
    assert resumes == [{"delivered_tokens": [100, 101, 102],
                        "rng_step_offset": 3}]


def test_shared_prefix_routes_to_the_replica_whose_tier_holds_it(weights):
    """A port replica whose page pool demoted a prefix publishes it in
    ``/stats``; the port gateway's prober reads it and routes a request
    sharing that prefix to that replica (policy host_tier), where it
    promotes from the tier."""
    _, _, cfg, params = weights
    engines = [ContinuousBatchingEngine(
        cfg, params, device="cpu", sampling=SamplingParams(greedy=True),
        max_seq=64, max_batch=2, prompt_buckets=(16, 64), kv_cache_blocks=6,
        kv_block_tokens=8, kv_host_tier_bytes=1 << 22) for _ in range(2)]
    servers = [InferenceHTTPServer(e, port=0) for e in engines]
    for s in servers:
        s.start()
    registry = gateway.ReplicaRegistry([(s.host, s.port) for s in servers],
                                       probe_interval_s=0.2)
    router = gateway.PrefixAwareRouter(registry, min_prefix_tokens=16,
                                       block_tokens=8)
    gw = gateway.GatewayHTTPServer(registry, router, port=0)
    threading.Thread(target=gw.httpd.serve_forever, daemon=True).start()
    try:
        shared = list(range(100, 132))
        b = engines[1]
        b.generate(np.asarray([shared + [1]]), 2)
        for i in range(3):                    # evict: demote the prefix
            b.generate(np.asarray([list(range(10 * i, 10 * i + 33))]), 2)
        assert b._kv_tier.stats["demoted_blocks"] >= 4
        registry.probe_all()
        toks = shared + [7, 8]
        d = router.route(toks)
        assert d.policy == "host_tier"
        assert d.rid == f"{servers[1].host}:{servers[1].port}"
        st, headers, lines = _post_stream(
            gw.host, gw.port, {"prompt_ids": [toks], "max_new_tokens": 4,
                               "stream": True})
        assert st == 200 and len(lines) == 4
        assert headers["X-DWT-Replica"] == d.rid
        assert b._kv_tier.stats["promoted_blocks"] >= 2
        assert b.stats()["kvcache"]["h2d_bytes"] > 0
    finally:
        gw.shutdown()
        for s, e in zip(servers, engines):
            s.shutdown()
            e.close()


def test_cli_gateway_command(capsys):
    """``gateway`` is a command now: without replicas it refuses as the
    reference's does; the drain client mode reports an unreachable
    gateway; a bad replica spec is refused."""
    assert cli.main(["gateway"]) == 1
    assert "--replicas is required" in capsys.readouterr().err
    assert cli.main(["gateway", "--replicas", "nohost"]) == 1
    assert "expected host:port" in capsys.readouterr().err
    assert cli.main(["gateway", "--drain", "h:1", "--http-port", "1"]) == 1
    assert "unreachable" in capsys.readouterr().err
