"""The pipeline header behind HTTP: the port's ``HeaderBackend`` and
``DynamicBatchingHeaderBackend`` against the JAX package's, and the CLI's
``serve --chain`` and ``worker``.

Each backend drives an in-process chain of two stages over loopback, on
the reference's weights, behind its package's ``InferenceHTTPServer``.
Blocking and streamed ``/generate``, ``/classify``, ``/stats`` with its
stages, ``/metrics`` and ``/health`` answer alike.  Four concurrent
requests through a ``pool_size`` 4 backend give the serial tokens;
``close`` fails the queued waiters instead of hanging them.
``cli.main(["serve", "--chain", ...])`` over ``worker`` processes answers
a request with the reference's tokens, and every chain refusal's text
equals the reference CLI's.  ``llama-test`` in f32 on the CPU.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu import cli as ref_cli
from distributed_inference_demo_tpu.runtime import dynamic_batch as ref_db
from distributed_inference_demo_tpu.runtime import \
    http_server as ref_http
from distributed_inference_demo_tpu.runtime import worker_main as ref_wm
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.runtime import worker_main
from distributed_inference_demo_tpu_torch.runtime.dynamic_batch import \
    DynamicBatchingHeaderBackend
from distributed_inference_demo_tpu_torch.runtime.http_server import (
    HeaderBackend, InferenceHTTPServer)
from test_torch_chain_procs import Proc, npz  # noqa: F401 (fixture)
from test_torch_ring import (PROMPT, PROMPT2, _few_torch_threads,
                             build_port_chain, build_ref_chain,
                             engine_tokens, stop_chain, weights)

__all__ = ["_few_torch_threads"]
LABELS = [4, 9, 17]


def _request(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module", params=["header", "dynamic"])
def servers(request):
    """(reference server, port server) over two-stage chains."""
    made = []
    for ref in (True, False):
        header, _, threads = (build_ref_chain() if ref
                              else build_port_chain())
        if request.param == "header":
            backend = (ref_http.HeaderBackend if ref else HeaderBackend)(
                header, max_seq=128, num_stages=2)
        else:
            backend = (ref_db.DynamicBatchingHeaderBackend if ref else
                       DynamicBatchingHeaderBackend)(
                header, max_seq=128, num_stages=2, pool_size=4)
        server = (ref_http.InferenceHTTPServer if ref
                  else InferenceHTTPServer)(backend, model_name="llama-test")
        server.start()
        made.append((server, backend, header, threads))
    yield [m[0] for m in made]
    for server, backend, header, threads in made:
        server.shutdown()
        if hasattr(backend, "close"):
            backend.close()
        stop_chain(header, threads)


def _metric_families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE dwt_stage")}


def test_routes_answer_as_the_reference(servers):
    ports = [s.port for s in servers]
    body = {"prompt_ids": PROMPT.tolist(), "max_new_tokens": 8}
    (rc, rb), (pc, pb) = (_request(p, "/generate", body) for p in ports)
    assert rc == pc == 200 and json.loads(pb) == json.loads(rb)
    want = engine_tokens("llama-test", PROMPT, 8)
    assert json.loads(pb)["tokens"] == want.tolist()
    stream = dict(body, stream=True)
    (rc, rb), (pc, pb) = (_request(p, "/generate", stream) for p in ports)
    assert rc == pc == 200
    assert ([json.loads(x) for x in pb.splitlines() if x]
            == [json.loads(x) for x in rb.splitlines() if x])
    cls = {"prompt_ids": PROMPT2.tolist(), "label_token_ids": LABELS}
    (rc, rb), (pc, pb) = (_request(p, "/classify", cls) for p in ports)
    assert rc == pc == 200 and json.loads(pb) == json.loads(rb)
    (rc, rb), (pc, pb) = (_request(p, "/stats") for p in ports)
    rs, ps = json.loads(rb)["stages"], json.loads(pb)["stages"]
    assert [s["role"] for s in ps] == [s["role"] for s in rs] == [
        "header", "tail"]
    assert [set(s) for s in ps] == [set(s) for s in rs]
    assert [s["steps"] for s in ps] == [s["steps"] for s in rs]
    (rc, rb), (pc, pb) = (_request(p, "/metrics") for p in ports)
    assert rc == pc == 200
    assert _metric_families(pb) == _metric_families(rb) != set()
    (_, rb), (_, pb) = (_request(p, "/health") for p in ports)
    assert json.loads(pb)["backend"] == json.loads(rb)["backend"]
    # past the capacity: the reference's 400
    big = {"prompt_ids": [[1] * 100], "max_new_tokens": 100}
    (rc, rb), (pc, pb) = (_request(p, "/generate", big) for p in ports)
    assert rc == pc == 400


def test_pool_size_4_concurrent_requests_give_serial_tokens():
    prompts = [PROMPT, PROMPT2, np.array([[1, 2]], np.int32),
               np.array([[7, 7, 7, 3, 1]], np.int32)]
    ns = [10, 6, 8, 3]
    wants = [engine_tokens("llama-test", p, n) for p, n in zip(prompts, ns)]
    header, workers, threads = build_port_chain()
    backend = DynamicBatchingHeaderBackend(header, max_seq=128,
                                           num_stages=2, pool_size=4)
    try:
        results = {}

        def run(i):
            results[i] = backend.generate(prompts[i], ns[i]).tokens

        ts = [threading.Thread(target=run, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for i, want in enumerate(wants):
            np.testing.assert_array_equal(results[i], want)
        steps = list(backend.generate_stream(prompts[0], 5))
        np.testing.assert_array_equal(np.stack(steps, axis=1),
                                      wants[0][:, :5])
        assert {s["role"] for s in backend.stats()["stages"]} == {
            "header", "tail"}

        # close fails what is queued behind the running window
        long = backend.submit(PROMPT, 60)
        assert long.stream.get(timeout=60) is not None   # window running
        queued = [backend.submit(p, 4) for p in prompts[1:]]
        backend.close()
        assert long.done.wait(60) and long.error is None
        for r in queued:
            assert r.done.wait(60)
            assert isinstance(r.error, RuntimeError) and "closed" in str(
                r.error)
        with pytest.raises(RuntimeError, match="closed"):
            backend.generate(PROMPT, 4)
    finally:
        backend.close()
        stop_chain(header, threads)
    assert all(w.rt.pages_free == w.rt.num_pages for w in workers)


def test_cli_serve_chain_over_worker_processes(npz, capsys, monkeypatch):
    """Two ``worker --elastic`` processes, then ``serve --chain``: its
    header reshards them onto the plan and answers ``POST /generate``
    (serialized and under ``--pool-size 4``) with the reference's greedy
    tokens, on the reference's weights, and ``/stats`` with every
    stage."""
    _, _, cfg, full, _ = weights()
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, full))
    header_port = _free_port()
    want = engine_tokens("llama-test", PROMPT, 8).tolist()
    procs = []
    try:
        tail = Proc(["-m", "distributed_inference_demo_tpu_torch", "worker",
                     "--elastic", "--model", "llama-test", "--device", "cpu",
                     "--device-id", "w2", "--port", "0", "--header",
                     f"header@127.0.0.1:{header_port}", "--greedy",
                     "--max-seq", "128", "--weights-npz", npz])
        procs.append(tail)
        w2 = tail.ready()
        mid = Proc(["-m", "distributed_inference_demo_tpu_torch", "worker",
                    "--elastic", "--model", "llama-test", "--device", "cpu",
                    "--device-id", "w1", "--port", "0", "--header",
                    f"header@127.0.0.1:{header_port}", "--next",
                    f"w2@{w2}", "--greedy", "--max-seq", "128",
                    "--weights-npz", npz])
        procs.append(mid)
        w1 = mid.ready()
        answers = []

        def serve_briefly(self):
            self.start()
            body = {"prompt_ids": PROMPT.tolist(), "max_new_tokens": 8}
            answers.append(_request(self.port, "/generate", body))
            answers.append(_request(self.port, "/stats"))

        monkeypatch.setattr(InferenceHTTPServer, "serve_forever",
                            serve_briefly)
        for pool in ("1", "4"):
            assert cli.main([
                "serve", "--model", "llama-test", "--device", "cpu",
                "--greedy", "--max-seq", "128", "--http-port", "0",
                "--port", str(header_port), "--chain",
                f"w1@{w1},w2@{w2}", "--pool-size", pool,
                "--step-timeout", "60", "--request-timeout", "60",
                "--kv-layout", "paged"]) == 0
            out = capsys.readouterr().out
            assert ("SERVE_PIPELINE ['header', 'w1', 'w2'] "
                    "ranges=[(0, 1), (1, 2), (2, 4)]") in out
            code, body = answers[-2]
            assert code == 200 and json.loads(body)["tokens"] == want
            stages = json.loads(answers[-1][1])["stages"]
            assert [s.get("device_id") for s in stages] == [
                "header", "w1", "w2"]
    finally:
        for p in procs:
            p.kill()


def _free_port() -> int:
    """A free port below the kernel's ephemeral range (and zmq's random
    range above it).  The header binds it only after both workers are up;
    a port the kernel hands out could meanwhile become another process's
    connection or ``bind(0)`` under a busy parallel test run, and the
    header's bind would then fail."""
    import random
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 12000), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def test_chain_refusals_equal_reference(capsys):
    base = ["serve", "--model", "llama-test"]
    plan = '{"seed": 1, "rules": []}'
    for extra in (["--pool-size", "2"],
                  ["--fault-plan", plan],
                  ["--chaos", "--fault-plan", plan],
                  ["--chain", "w@127.0.0.1:1", "--prefill-chunk", "4"],
                  ["--chain", "w@127.0.0.1:1", "--stream-block", "4"],
                  ["--chain", "w@127.0.0.1:1", "--kv-cache-blocks", "8"],
                  ["--chain", "w@127.0.0.1:1", "--batch-slots", "2"]):
        assert cli.main(base + ["--device", "cpu"] + extra) == 1
        err = capsys.readouterr().err
        assert ref_cli.main(base + extra) == 1
        assert err == capsys.readouterr().err and err, extra
    stage = ["--model", "llama-test", "--device-id", "w", "--port", "0"]
    for extra in (["--header", "h@127.0.0.1:1", "--fault-plan", plan],
                  ["--stage-id", "1"],
                  ["--stage-id", "1", "--num-stages", "2", "--layer-start",
                   "0", "--layer-end", "2", "--header", "h@127.0.0.1:1",
                   "--kv-cache-blocks", "8"],
                  ["--role", "prefill", "--live-migration"]):
        assert worker_main.main(stage + extra) == 1
        err = capsys.readouterr().err
        assert ref_wm.main(stage + extra) == 1
        assert err == capsys.readouterr().err and err, extra
    # tp under a draft model and worker --tp are served; the port
    # refuses what the reference refuses of them, with its text
    tp_draft = ["serve", "--model", "llama-test", "--tp", "2",
                "--draft-model", "llama-test", "--chain", "w@127.0.0.1:1"]
    assert cli.main(tp_draft + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert ref_cli.main(tp_draft) == 1
    assert err == capsys.readouterr().err and err
    tp_stage = ["--model", "llama-test", "--stage-id", "1", "--num-stages",
                "2", "--layer-start", "0", "--layer-end", "2", "--device-id",
                "w", "--port", "0", "--header", "h@127.0.0.1:1", "--tp", "2",
                "--kv-cache-blocks", "8"]
    assert cli.main(["worker", "--device", "cpu", *tp_stage]) == 1
    err = capsys.readouterr().err
    assert ref_wm.main(tp_stage) == 1
    assert err == capsys.readouterr().err and err
    assert os.environ.get("DWT_FAULT_PLAN") is None
