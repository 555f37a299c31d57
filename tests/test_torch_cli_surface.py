"""The port's ``generate``, ``classify`` and ``chat`` commands against the
JAX package's CLI, run in process as ``tests/test_cli.py`` runs them.

Both CLIs build their engines over the same weights: the port's
``cli._params`` is handed the reference's ``llama-test`` init through the
bridge (the port's own random init draws from a ``torch.Generator``).
Each command prints the same JSON or renders the same stream, and the
refusals (``--prompt`` without ``--tokenizer``, a label count that does
not match the dataset) exit 1 with the same message.
"""

import io
import json
import string
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu import cli as ref_cli
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.runtime.engine import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu.runtime.http_server import \
    InferenceHTTPServer as RefServer
from distributed_inference_demo_tpu.tokenizer import Tokenizer as RefTokenizer
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer
from distributed_inference_demo_tpu_torch.sp_tokenizer import (
    CONTROL, NORMAL, UNKNOWN, build_model_proto)
from distributed_inference_demo_tpu_torch.tokenizer import Tokenizer

ENGINE_ARGS = ["--model", "llama-test", "--max-seq", "64", "--greedy"]


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


@pytest.fixture()
def bridged(weights, monkeypatch):
    """The port CLI's engines get the reference's seed-0 weights."""
    _, _, cfg, p = weights
    monkeypatch.setattr(cli, "_params",
                        lambda args: (torch.device("cpu"), cfg, p))


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL)]
    words = ["hello", "world", "the", "cat", "sat", "on", "mat", "a"]
    pieces += [(f"▁{w}", -float(i + 1), NORMAL) for i, w in enumerate(words)]
    pieces += [(c, -50.0, NORMAL) for c in string.ascii_lowercase]
    path = tmp_path_factory.mktemp("tok") / "tiny.model"
    path.write_bytes(build_model_proto(pieces))
    return str(path)


def _run(main, argv, stdin=None, monkeypatch=None):
    out, err = io.StringIO(), io.StringIO()
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("prompt", ["ids", "text"])
def test_generate_equals_reference(bridged, tokenizer_file, prompt):
    tail = (["--prompt-ids", "5,17,42,7,99"] if prompt == "ids" else
            ["--prompt", "the cat sat on the mat",
             "--tokenizer", tokenizer_file])
    tail += ["--max-new-tokens", "6"]
    rc, out, _ = _run(cli.main, ["generate", *ENGINE_ARGS, "--device", "cpu",
                                 *tail])
    rrc, rout, _ = _run(ref_cli.main, ["generate", *ENGINE_ARGS,
                                       "--attn-backend", "jnp", *tail])
    assert rc == rrc == 0
    port, ref = json.loads(out), json.loads(rout)
    assert sorted(port) == sorted(ref)
    assert port["tokens"] == ref["tokens"] and len(port["tokens"][0]) == 6
    if prompt == "text":
        assert port["text"] == ref["text"]
        tok = Tokenizer.from_file(tokenizer_file)
        assert port["text"] == [tok.decode(port["tokens"][0])]


def test_generate_refusals_equal_reference(bridged):
    for argv in (["--prompt", "hi"], []):
        rc, _, err = _run(cli.main, ["generate", *ENGINE_ARGS, "--device",
                                     "cpu", *argv])
        rrc, _, rerr = _run(ref_cli.main, ["generate", *ENGINE_ARGS, *argv])
        assert rc == rrc == 1 and err == rerr and err
    # --sp is exclusive with --tp: the reference's text
    argv = ["--prompt-ids", "1,2", "--sp", "2", "--tp", "2"]
    rc, _, err = _run(cli.main, ["generate", *ENGINE_ARGS, "--device", "cpu",
                                 *argv])
    rrc, _, rerr = _run(ref_cli.main, ["generate", *ENGINE_ARGS, *argv])
    assert rc == rrc == 1 and "--sp" in err and err == rerr


def _dataset(tmp_path, weights, names=("a", "b", "c")):
    """Four rows of token ids labelled with the reference engine's own
    predictions, so the accuracy is 1.0 on both sides."""
    rcfg, rp, _, _ = weights
    eng = RefEngine(rcfg, rp, max_seq=64, attn_backend="jnp")
    labels = [4, 9, 33]
    rng = np.random.RandomState(1)
    rows = []
    for _ in range(4):
        ids = rng.randint(0, 250, 5)
        rows.append((" ".join(map(str, ids)),
                     names[int(eng.classify(ids[None, :], labels)[0])]))
    path = tmp_path / "ds.csv"
    path.write_text("".join(f'"{t}",{n}\n' for t, n in rows))
    from distributed_inference_demo_tpu_torch.tasks import load_csv_dataset
    ds = load_csv_dataset(str(path))
    label_ids = ",".join(str(labels[names.index(n)]) for n in ds.label_names)
    return path, label_ids


def test_classify_equals_reference(bridged, weights, tmp_path):
    path, label_ids = _dataset(tmp_path, weights)
    argv = ["classify", *ENGINE_ARGS, "--dataset", str(path),
            "--label-token-ids", label_ids]
    rc, out, _ = _run(cli.main, argv + ["--device", "cpu"])
    rrc, rout, _ = _run(ref_cli.main, argv + ["--attn-backend", "jnp"])
    assert rc == rrc == 0
    port, ref = json.loads(out), json.loads(rout)
    assert port == ref
    assert port["total"] == 4 and port["accuracy"] == 1.0
    # the labels equal the port engine's own classify
    _, _, cfg, p = weights
    eng = InferenceEngine(cfg, p, max_seq=64, device="cpu")
    lab = [int(t) for t in label_ids.split(",")]
    from distributed_inference_demo_tpu_torch.tasks import load_csv_dataset
    texts = load_csv_dataset(str(path)).texts
    want = [int(eng.classify(np.asarray([[int(t) for t in x.split()]]),
                             lab)[0]) for x in texts]
    assert port["predictions"] == want


def test_classify_refuses_a_label_count_like_the_reference(bridged, weights,
                                                           tmp_path):
    path, _ = _dataset(tmp_path, weights)
    argv = ["classify", *ENGINE_ARGS, "--dataset", str(path),
            "--label-token-ids", "4,9"]
    rc, _, err = _run(cli.main, argv + ["--device", "cpu"])
    rrc, _, rerr = _run(ref_cli.main, argv)
    assert rc == rrc == 1 and err == rerr and "--label-token-ids" in err


@pytest.mark.parametrize("mode", ["ids", "text"])
def test_chat_equals_reference(weights, tokenizer_file, monkeypatch, mode):
    """``chat`` against a running server of each package: the same turns
    render the same stream."""
    rcfg, rp, cfg, p = weights
    tok = mode == "text"
    port_srv = InferenceHTTPServer(
        InferenceEngine(cfg, p, max_seq=64,
                        sampling=SamplingParams(greedy=True), device="cpu"),
        tokenizer=Tokenizer.from_file(tokenizer_file) if tok else None)
    ref_srv = RefServer(
        RefEngine(rcfg, rp, max_seq=64, sampling=RefSamplingParams(
            greedy=True), attn_backend="jnp"),
        tokenizer=RefTokenizer.from_file(tokenizer_file) if tok else None)
    turns = ("the cat\nhello world\n/quit\n" if tok
             else "5,17,42,7\n9,8\nnot,ids\n/quit\n")
    outs = []
    try:
        for main, srv in ((cli.main, port_srv), (ref_cli.main, ref_srv)):
            srv.start()
            argv = ["chat", "--url", f"http://127.0.0.1:{srv.port}",
                    "--max-new-tokens", "6"]
            outs.append(_run(main, argv + ([] if tok else ["--ids"]),
                             stdin=turns, monkeypatch=monkeypatch))
    finally:
        port_srv.shutdown()
        ref_srv.shutdown()
    (rc, out, err), (rrc, rout, rerr) = outs
    assert rc == rrc == 0
    assert out.replace(str(port_srv.port), "P") == \
        rout.replace(str(ref_srv.port), "P")
    assert err == rerr
    if not tok:
        assert "--ids mode expects comma-separated ints" in err
        want = port_srv.backend.generate(np.asarray([[5, 17, 42, 7]]), 6)
        assert " ".join(map(str, want.tokens[0].tolist())) in out


def test_serve_tokenizer_run_log_and_postmortem_dir(bridged, tokenizer_file,
                                                     tmp_path, monkeypatch):
    """``serve --tokenizer --run-log --postmortem-dir`` on both CLIs: the
    served text answers are the same, the run logs record the same
    events, and the crash handler is installed."""
    import sys
    import threading
    import urllib.request

    from distributed_inference_demo_tpu.runtime import http_server as r_http
    from distributed_inference_demo_tpu.telemetry import postmortem as r_pm
    from distributed_inference_demo_tpu_torch.runtime import http_server
    from distributed_inference_demo_tpu_torch.telemetry import postmortem

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(threading, "excepthook", threading.excepthook)
    for pm in (postmortem, r_pm):
        monkeypatch.setattr(pm, "_crash_installed", False)
    answers = []

    def serve_once(self):
        self.start()
        for stop in (None, "zz"):
            body = {"prompt": "the cat sat", "max_new_tokens": 5}
            if stop:
                body["stop"] = stop
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                answers.append(json.loads(resp.read()))

    outs = []
    for main, mod, pm, side in ((cli.main, http_server, postmortem, "port"),
                                (ref_cli.main, r_http, r_pm, "ref")):
        monkeypatch.setattr(mod.InferenceHTTPServer, "serve_forever",
                            serve_once)
        log = tmp_path / f"{side}.jsonl"
        argv = ["serve", *ENGINE_ARGS, "--tokenizer", tokenizer_file,
                "--run-log", str(log), "--postmortem-dir",
                str(tmp_path / f"pm-{side}"), "--http-port", "0"]
        argv += ["--device", "cpu"] if side == "port" else [
            "--attn-backend", "jnp"]
        hook = sys.excepthook
        try:
            rc, out, _ = _run(main, argv)
            assert rc == 0 and "HTTP_READY" in out
            assert sys.excepthook is not hook       # the crash handler
        finally:
            pm.set_postmortem_writer(None)
        outs.append([json.loads(ln)["event"]
                     for ln in log.read_text().splitlines()])
    assert answers[:2] == answers[2:]
    assert answers[0]["text"] and answers[1]["stop_reason"] == ["length"]
    # the blocking request logs its generate; the stop path streams
    assert outs[0] == outs[1] == ["serve_start", "generate"]
