"""The port's telemetry layer against the JAX package's, same inputs.

The catalog registers the reference's ``dwt_*`` series (names, types,
help text, labels) on the port's own registry and passes the metric-name
lint; the same operations render byte-equal expositions; ``slo``,
``anomaly``, ``tracing``, ``runlog`` and ``postmortem`` driven with the
reference tests' fake-clock inputs give equal outputs; ``profiling``'s
signatures, sampling, sketch and recompile-storm accounting equal the
reference's, its timer synchronizes the card on sampled dispatches only,
and its bandwidth ceiling is the card's, never ``ROOFLINE_LEDGER.json``'s.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from distributed_inference_demo_tpu.telemetry import anomaly as r_anomaly
from distributed_inference_demo_tpu.telemetry import postmortem as r_pm
from distributed_inference_demo_tpu.telemetry import profiling as r_prof
from distributed_inference_demo_tpu.telemetry import runlog as r_runlog
from distributed_inference_demo_tpu.telemetry import slo as r_slo
from distributed_inference_demo_tpu.telemetry import tracing as r_tracing
from distributed_inference_demo_tpu.telemetry.flightrecorder import \
    set_flight_recorder as r_set_flight
from distributed_inference_demo_tpu_torch.runtime import cuda_graph
from distributed_inference_demo_tpu_torch.telemetry import anomaly
from distributed_inference_demo_tpu_torch.telemetry import catalog
from distributed_inference_demo_tpu_torch.telemetry import postmortem
from distributed_inference_demo_tpu_torch.telemetry import profiling
from distributed_inference_demo_tpu_torch.telemetry import runlog
from distributed_inference_demo_tpu_torch.telemetry import slo
from distributed_inference_demo_tpu_torch.telemetry import tracing
from distributed_inference_demo_tpu_torch.telemetry.flightrecorder import \
    set_flight_recorder

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = dict(anomaly=r_anomaly, pm=r_pm, prof=r_prof, runlog=r_runlog,
           slo=r_slo, tracing=r_tracing, set_flight=r_set_flight)
PORT = dict(anomaly=anomaly, pm=postmortem, prof=profiling, runlog=runlog,
            slo=slo, tracing=tracing, set_flight=set_flight_recorder)


class FakeClock:
    def __init__(self, t: float = 1000.0, step: float = 0.0):
        self.t, self.step, self.calls = t, step, 0

    def __call__(self) -> float:
        self.calls += 1
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _isolate_globals():
    for m in (REF, PORT):
        m["set_flight"](None)
        m["pm"].set_postmortem_writer(None)
    yield
    for m in (REF, PORT):
        m["set_flight"](None)
        m["pm"].set_postmortem_writer(None)


def _both(fn):
    """``fn(modules)`` on the reference's modules and on the port's."""
    return fn(REF), fn(PORT)


# -- catalog / metrics --------------------------------------------------------

_FRESH = r"""
import json, sys
from distributed_inference_demo_tpu.telemetry import catalog as rc
from distributed_inference_demo_tpu_torch.telemetry import catalog as pc
from distributed_inference_demo_tpu_torch.runtime import engine as pe

def series(c):
    return [[m.name, m.type, m.help, list(m.label_names)]
            for m in c.REGISTRY.collect()]

def drive(c, count_loop):
    c.HTTP_REQUESTS.inc(route="/generate", code="200")
    c.HTTP_REQUESTS.inc(route="/generate", code="200")
    c.HTTP_REQUESTS.inc(route="other", code="404")
    c.HTTP_REQUEST_SECONDS.observe(0.0123, route="/generate")
    c.HTTP_GENERATED_TOKENS.inc(17)
    count_loop("ContinuousBatchingEngine", 4)
    c.update_batching_series({
        "slots": 4, "queue_depth": 1, "active_slots": 2, "steps": 31,
        "latency": {"completed": 3, "ttft_p50_ms": 12.5,
                    "ttft_p95_ms": 20.0, "e2e_p50_ms": 80.0},
        "mixed": {"dispatches": 5, "prefill_tokens": 64,
                  "budget_utilization": 0.5},
        "kvcache": {"hits": 2, "misses": 1, "stored_blocks": 7,
                    "resident_bytes": 4096, "capacity_bytes": 65536,
                    "blocks_used": 5, "tree_blocks": 3,
                    "page_dtype": "int8", "quant_scale_bytes": 128}})
    c.update_flight_series()
    c.update_profiling_series()
    c.slo.update_slo_series()
    c.record_monitor_round({"bandwidth": {"w1": 1e9},
                            "latency": {"w1": 0.002}, "flops": 5e12})
    c.PROFILE_DISPATCH_SECONDS.observe(0.004, signature="paged_step|b8|c1|bf16")
    c.ANOMALY_EVENTS.inc(kind="recompile_storm")
    return c.REGISTRY.render()

from distributed_inference_demo_tpu.runtime import engine as re
out = {"ref": series(rc), "port": series(pc)}
out["ref_text"] = drive(rc, re.count_device_loop)
out["port_text"] = drive(pc, pe.count_device_loop)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fresh_catalogs():
    """Both catalogs in a fresh interpreter: each registry holds exactly
    what its catalog registers, before and after the same operations."""
    res = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


def test_catalog_registers_the_reference_series(fresh_catalogs):
    ref, port = fresh_catalogs["ref"], fresh_catalogs["port"]
    assert len(port) == len(ref) > 100
    assert port == ref
    assert all(name.startswith("dwt_") for name, *_ in port)


def test_exposition_of_the_same_operations_is_byte_equal(fresh_catalogs):
    text = fresh_catalogs["port_text"]
    assert text == fresh_catalogs["ref_text"]
    assert 'dwt_http_requests_total{route="/generate",code="200"} 2' in text
    assert ('dwt_engine_device_loop_steps_total'
            '{engine="ContinuousBatchingEngine"} 4') in text


def _load_lint():
    path = REPO / "tools" / "check_metrics_names.py"
    spec = importlib.util.spec_from_file_location("check_metrics_names",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_catalog_is_lint_clean():
    lint = _load_lint()
    assert lint.check_registry(catalog.REGISTRY) == []
    assert lint.check_required(catalog.REGISTRY) == []
    # the port's registry is its own: the reference's holds other objects
    from distributed_inference_demo_tpu.telemetry import catalog as rc
    assert catalog.REGISTRY is not rc.REGISTRY
    assert catalog.HTTP_REQUESTS is not rc.HTTP_REQUESTS


def test_memory_info_copy_equals_the_reference_probe():
    from distributed_inference_demo_tpu.monitor.probes import memory_info
    port, ref = catalog.memory_info(), memory_info()
    assert sorted(port) == sorted(ref) == ["available", "total"]
    assert port["total"] == ref["total"] > 0


# -- slo ---------------------------------------------------------------------

def _drive_slo(m):
    """test_slo.py's ledger inputs: decomposition, goodput judging,
    burn windows under an injected clock, the summary and the tail."""
    clk = FakeClock()
    led = m["slo"].SloLedger(ttft_slo_ms=100.0, tpot_slo_ms=10.0,
                             target=0.9, clock=clk)
    recs = [
        led.close_request(rid="r1", tenant="acme", trace_id=0xABCD,
                          queue_wait_s=0.02, ttft_s=0.08, e2e_s=1.30,
                          tokens=12, migration_pause_s=0.25, migrated=True,
                          replica="engine:aa"),
        led.close_request(rid="r2", queue_wait_s=0.5, ttft_s=0.1,
                          e2e_s=0.0, tokens=2, migration_pause_s=0.2),
        led.close_request(rid="g", tenant="t", ttft_s=0.05,
                          e2e_s=0.05 + 0.005 * 9, tokens=10),
        led.close_request(rid="b1", tenant="t", ttft_s=0.5,
                          e2e_s=0.5 + 0.005 * 9, tokens=10),
        led.close_request(rid="err", tenant="t", ttft_s=0.05, e2e_s=0.1,
                          tokens=10, error="Boom"),
        led.close_request(rid="a", tenant="acme", ttft_s=0.05, e2e_s=0.1,
                          tokens=10, error="X"),
    ]
    burns = [led.burn_rates("acme")]
    clk.t += 301.0
    burns.append(led.burn_rates("acme"))
    clk.t += 3600.0
    burns.append(led.burn_rates("acme"))
    tenants = [m["slo"].sanitize_tenant(t) for t in
               (None, "", "acme-prod", 'ev"il\n{label}', "x" * 200)]
    m["slo"].set_slo_ledger(led)
    try:
        state = m["slo"].debug_state(tail=4)
        lines = m["slo"].timelines_jsonl(tail=3)
    finally:
        m["slo"].set_slo_ledger(None)
    for r in recs:
        r.pop("ts", None)
    for r in state["recent"]:
        r.pop("ts", None)
    return recs, burns, tenants, led.summary(), state, len(lines)


def test_slo_ledger_equals_reference():
    ref, port = _both(_drive_slo)
    assert port == ref


# -- anomaly -----------------------------------------------------------------

def _stages(slow_ms):
    return [{"role": "header", "device_id": "h", "compute_p95_ms": 2.0},
            {"role": "worker", "device_id": "w1", "compute_p95_ms": 2.0},
            {"role": "tail", "device_id": "w2", "compute_p95_ms": slow_ms}]


def _scenario_stats(scenario):
    """test_anomaly.py's observation sequences, one stats dict a tick."""
    if scenario == "straggler":
        return [{"stages": _stages(20.0)}] * 10
    if scenario == "slo":
        return [{"steps": i, "latency": {"ttft_p95_ms": 250.0,
                                         "per_token_p95_ms": 80.0}}
                for i in range(8)]
    if scenario == "stall":
        return [{"steps": 42, "active_slots": 3, "queue_depth": 0}] * 8
    if scenario == "saturation":
        return [{"steps": i, "queue_depth": 99,
                 "speculative": {"rounds": 100, "num_draft": 4,
                                 "acceptance_rate": 0.05}}
                for i in range(4)]
    # recompile storm: captures booked past a program's budget
    return [{"compile": {"mixed_step": {"compiles": n, "variant_budget": 2,
                                        "compile_seconds": 1.5,
                                        "cache_entries": n}}}
            for n in (2, 3, 3, 3, 3, 3)]


@pytest.mark.parametrize("scenario", ["straggler", "slo", "stall",
                                      "saturation", "storm"])
def test_anomaly_detector_equals_reference(scenario):
    def drive(m):
        clock = FakeClock()
        th = m["anomaly"].Thresholds(
            straggler_factor=3.0, straggler_min_ms=1.0, ttft_slo_ms=100.0,
            tpot_slo_ms=50.0, queue_depth=16, accept_floor=0.2,
            accept_min_drafted=40, stall_s=30.0, sustain=3,
            cooldown_s=300.0, recompile_slack=0)
        det = m["anomaly"].AnomalyDetector(th, clock=clock)
        fired = []
        for stats in _scenario_stats(scenario):
            fired += [a.to_dict() for a in det.observe(stats)]
            clock.advance(11.0 if scenario == "stall" else 1.0)
        return fired, det.state()

    (rf, rs), (pf, ps) = _both(drive)
    assert pf == rf and ps == rs
    assert len(pf) == (2 if scenario in ("slo", "saturation") else 1)


def test_anomaly_monitor_writes_one_bundle_like_the_reference(tmp_path):
    def drive(m):
        clock = FakeClock()
        out = tmp_path / ("ref" if m is REF else "port")
        m["pm"].set_postmortem_writer(
            m["pm"].PostmortemWriter(str(out), clock=clock))
        mon = m["anomaly"].AnomalyMonitor(
            m["anomaly"].AnomalyDetector(
                m["anomaly"].Thresholds(sustain=1, recompile_slack=0),
                clock=clock), min_interval_s=0.0, clock=clock)
        fired = mon.observe(lambda: {"compile": {"mixed_step": {
            "compiles": 3, "variant_budget": 2}}})
        manifest = json.loads(
            (pathlib.Path(mon.bundles[0]) / "manifest.json").read_text())
        files = sorted(p.name for p in pathlib.Path(mon.bundles[0]).iterdir())
        return ([a.kind for a in fired], len(mon.bundles),
                manifest["reason"], manifest["detail"], files)

    ref, port = _both(drive)
    assert port == ref
    assert port[0] == ["recompile_storm"]


# -- tracing / runlog / postmortem ------------------------------------------

def test_tracing_export_equals_reference():
    def drive(m):
        rec = m["tracing"].TraceRecorder("engine:abc")
        rec.record("engine.prefill", 0xAB12, ts=1000.25, dur=0.125,
                   rid="r1", tenant="t")
        rec.record("engine.decode", 0xAB12, ts=1000.375, dur=0.5,
                   rid="r1", tenant="t", tokens=9)
        rec.record("compute", 7, parent_id=3, ts=1001.0, dur=0.001)
        spans = rec.drain()
        for s in spans:
            s.pop("span_id", None)
        chrome = m["tracing"].to_chrome_trace(spans)
        return spans, chrome, len(rec)

    ref, port = _both(drive)
    assert port == ref
    assert [e["name"] for e in port[1]["traceEvents"]
            if e["ph"] == "X"] == ["engine.prefill", "engine.decode",
                                   "compute"]


def test_runlog_lines_equal_reference(tmp_path):
    def drive(m):
        path = tmp_path / ("ref.jsonl" if m is REF else "port.jsonl")
        rl = m["runlog"].RunLog(str(path), run_id="run-1")
        rl.event("serve_start", model="llama-test", max_seq=64)
        rl.event("generate", engine="InferenceEngine", batch=1,
                 prompt_len=6, new_tokens=8)
        rl.close()
        rows = [json.loads(ln) for ln in path.read_text().splitlines()]
        for r in rows:
            r.pop("ts", None)
        return rows

    ref, port = _both(drive)
    assert port == ref and [r["event"] for r in port] == ["serve_start",
                                                           "generate"]


def test_postmortem_bundle_equals_reference(tmp_path):
    def drive(m):
        out = tmp_path / ("ref" if m is REF else "port")
        rl = m["runlog"].RunLog(str(tmp_path / f"{out.name}.jsonl"),
                                run_id="run-1")
        m["runlog"].set_run_log(rl)
        try:
            rl.event("serve_start", model="llama-test")
            w = m["pm"].PostmortemWriter(str(out), clock=FakeClock())
            path = pathlib.Path(w.write_bundle(
                "slo_ttft", detail={"why": "test"},
                config={"model": "llama-test"},
                spans=[{"name": "compute", "proc": "h", "trace_id": 1,
                        "span_id": 2, "ts_us": 1000, "dur_us": 500}]))
        finally:
            m["runlog"].set_run_log(None)
            rl.close()
        manifest = json.loads((path / "manifest.json").read_text())
        tail = [json.loads(ln)["event"] for ln in
                (path / "runlog_tail.jsonl").read_text().splitlines()]
        return (sorted(p.name for p in path.iterdir()), manifest["reason"],
                manifest["detail"], sorted(manifest), tail,
                json.loads((path / "config.json").read_text()))

    ref, port = _both(drive)
    assert port == ref


# -- profiling ---------------------------------------------------------------

def test_signatures_and_parsing_equal_reference():
    cases = [("paged_step", 1, 1, "bf16"), ("paged_multi_step", 5, 4,
                                            "int8"),
             ("mixed_step", 8, 4, "int4"), ("decode_loop", 3, 32,
                                            "bfloat16"),
             ("prefill", 0, -3, "float8_e4m3fn")]
    for prog, b, c, kv in cases:
        sig = profiling.dispatch_signature(prog, batch=b, chunk=c,
                                           kv_dtype=kv)
        assert sig == r_prof.dispatch_signature(prog, batch=b, chunk=c,
                                                kv_dtype=kv)
        assert profiling.parse_signature(sig) == r_prof.parse_signature(sig)
    assert [profiling.batch_bucket(n) for n in range(10)] == \
        [r_prof.batch_bucket(n) for n in range(10)]
    with pytest.raises(ValueError):
        profiling.parse_signature("nope")


def test_sampling_cadence_and_snapshot_equal_reference():
    def drive(m):
        clock = FakeClock(step=0.002)
        prof = m["prof"].DispatchProfiler(sample_n=3, clock=clock)
        sampled = []
        for sig in ["a|b1|c1|bf16"] * 7 + ["b|b2|c4|int8"] * 4:
            t0 = prof.begin(sig)
            sampled.append(t0 is not None)
            prof.end(sig, t0, hbm_bytes=1000)
        return sampled, prof.snapshot(), prof.dispatch_counts(), clock.calls

    os.environ.pop("DWT_ROOFLINE_GBS", None)
    ref, port = _both(drive)
    # the ceilings differ by design (TPU ledger against the card's), so
    # the roofline fraction is the one field left out of the comparison
    for snap in (ref[1], port[1]):
        for e in snap.values():
            e.pop("roofline_frac", None)
    assert port == ref
    assert port[0][:3] == [False, False, True]


def test_unsampled_dispatches_touch_no_clock_and_no_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))

    def boom():
        raise AssertionError("the unsampled path read the clock")

    prof = profiling.DispatchProfiler(sample_n=4, clock=boom)
    card = torch.device("cuda", 0)
    for _ in range(3):
        t0 = prof.begin("x|b1|c1|bf16")
        assert t0 is None
        assert prof.end("x|b1|c1|bf16", t0, out=card) is None
    assert synced == []
    off = profiling.DispatchProfiler(sample_n=0, clock=boom)
    assert off.begin("x|b1|c1|bf16") is None and off.dispatch_counts() == {}


def test_sampled_dispatch_synchronizes_the_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    prof = profiling.DispatchProfiler(sample_n=1, clock=FakeClock(step=1.0))
    card = torch.device("cuda", 0)
    for out in (card, [torch.zeros(2), card], {"k": card}):
        prof.end("x|b1|c1|bf16", prof.begin("x|b1|c1|bf16"), out=out)
    assert synced == [card] * 3
    # CPU outputs have nothing to wait for
    prof.end("x|b1|c1|bf16", prof.begin("x|b1|c1|bf16"),
             out=torch.zeros(3))
    assert len(synced) == 3


def test_sketch_bytes_equal_reference():
    def drive(m):
        rec = m["prof"].WorkloadSketchRecorder()
        t = 100.0
        for i, (plen, tenant) in enumerate([(40, "a"), (600, "b"),
                                            (40, "a"), (3000, "a")]):
            rec.record_request(plen, tenant=tenant, now=t + i * 0.5)
        rec.record_prefix(32, 40)
        rec.record_prefix(0, 600)
        for n in (10, 20, 200):
            rec.record_decode(n)
        return rec.to_json()

    ref, port = _both(drive)
    assert port == ref
    assert json.loads(port)["requests"] == 4


def test_watermarks_and_kv_bytes_equal_reference():
    def drive(m):
        w = m["prof"].HbmWatermarks()
        for owner, n in [("kv_page_pool", 100), ("kv_page_pool", 300),
                         ("kv_page_pool", 50), ("draft_scratch", 7)]:
            w.sample(owner, n)
        before = w.watermarks()
        w.reset("kv_page_pool")
        return before, w.watermarks()

    ref, port = _both(drive)
    assert port == ref
    import jax.numpy as jnp
    for kv in (None, "bf16", "int8", "int4"):
        assert (profiling.kv_dispatch_bytes(3, 22, 4, 64, kv, torch.bfloat16)
                == r_prof.kv_dispatch_bytes(3, 22, 4, 64, kv, jnp.bfloat16))


def test_graph_captures_are_booked_as_compiles(monkeypatch):
    """A capture books one compile under the program's name; past the
    two-variant budget the reference's detector calls it a storm."""
    class FakeStep:
        def __init__(self, step, device, generator, enabled, pool):
            self.graph, self.replays = object(), 0

    monkeypatch.setattr(cuda_graph, "StepGraph", FakeStep)
    profiling.reset_observatory()
    try:
        tracker = profiling.get_compile_tracker()
        tracker.register("mixed_step", variant_budget=2)
        graphs = cuda_graph.StepGraphs(torch.device("cpu"))
        for _ in range(3):
            graphs.capture(lambda: None, program="mixed_step")
        graphs.capture(lambda: None)            # an unnamed capture
        snap = tracker.snapshot()["mixed_step"]
        assert (snap["compiles"], snap["cache_entries"],
                snap["variant_budget"]) == (3, 3, 2)
        assert snap["compile_seconds"] >= 0
        clock = FakeClock()
        th = anomaly.Thresholds(sustain=1, recompile_slack=0)
        fired = anomaly.AnomalyDetector(th, clock=clock).observe(
            {"compile": tracker.snapshot()})
        assert [a.kind for a in fired] == ["recompile_storm"]
        assert fired[0].detail["program"] == "mixed_step"
    finally:
        profiling.reset_observatory()


def test_a_cpu_step_books_no_compile():
    profiling.reset_observatory()
    try:
        profiling.get_compile_tracker().register("decode_loop")
        cuda_graph.StepGraphs(torch.device("cpu")).capture(
            lambda: None, program="decode_loop")
        assert profiling.get_compile_tracker().snapshot()["decode_loop"][
            "compiles"] == 0
    finally:
        profiling.reset_observatory()


@pytest.mark.parametrize("case", ["env", "cpu", "h100", "other_card"])
def test_roofline_ceiling_is_the_cards(monkeypatch, case):
    ledger = json.loads((REPO / "ROOFLINE_LEDGER.json").read_text())
    tpu_gbs = {float(v["hbm_gbs"]) for v in ledger.values()
               if isinstance(v, dict) and "hbm_gbs" in v}
    monkeypatch.delenv("DWT_ROOFLINE_GBS", raising=False)
    if case == "env":
        monkeypatch.setenv("DWT_ROOFLINE_GBS", "1234.5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: case in (
        "h100", "other_card"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: (
        "NVIDIA H100 80GB HBM3" if case == "h100" else "Some Card"))
    profiling._ROOFLINE_CACHE.clear()
    try:
        got = profiling.roofline_ceiling_gbs()
    finally:
        profiling._ROOFLINE_CACHE.clear()
    want = {"env": 1234.5, "cpu": None, "h100": 3350.0,
            "other_card": None}[case]
    assert got == want
    assert got not in tpu_gbs
