"""The torch port's checkpoint loader against the JAX package's and HF.

The port reads the safetensors format itself (its package is not on the
machine with the card): the reader agrees with ``safetensors.safe_open``
on bf16 and f32 leaves over two shards.  Random HF models of the llama,
qwen2, gemma and bloom test configs map through ``params_from_state_dict``
to the reference's parameters bit for bit, and the port's logits agree
with HF's at 2e-4.  ``load_or_init`` on a checkpoint directory equals the
reference's for an ``-int8`` config; the orbax format and a family with
no mapper are refused (mixtral's mapper: ``test_torch_moe.py``);
``serve --checkpoint`` answers a greedy request.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config  # noqa: E402
from distributed_inference_demo_tpu.models import \
    loader as ref_loader  # noqa: E402
from distributed_inference_demo_tpu.ops import quant as ref_quant  # noqa: E402
from distributed_inference_demo_tpu_torch import cli  # noqa: E402
from distributed_inference_demo_tpu_torch.models import (  # noqa: E402
    KVCache, StageSpec, get_model_config)
from distributed_inference_demo_tpu_torch.models import loader  # noqa: E402
from distributed_inference_demo_tpu_torch.models.decoder import \
    stage_forward  # noqa: E402
from distributed_inference_demo_tpu_torch.ops import quant  # noqa: E402
from distributed_inference_demo_tpu_torch.runtime.http_server import \
    InferenceHTTPServer  # noqa: E402

PROMPT = np.array([[5, 17, 42, 7, 99, 3, 12, 56, 200, 131]])
FAMILIES = ["llama-test", "qwen2-test", "gemma-test", "bloom-test"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _hf_model(name):
    """A random HF model of one of the test configs (seeded)."""
    torch.manual_seed(0)
    cfg = get_model_config(name)
    common = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads,
                  intermediate_size=cfg.intermediate_size,
                  max_position_embeddings=cfg.max_seq_len,
                  rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                  tie_word_embeddings=cfg.tie_embeddings)
    if cfg.family == "qwen2":
        model = transformers.Qwen2ForCausalLM(
            transformers.Qwen2Config(**common))
    elif cfg.family == "llama":
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            attention_bias=False, mlp_bias=False, **common))
    elif cfg.family == "gemma":
        model = transformers.GemmaForCausalLM(transformers.GemmaConfig(
            head_dim=cfg.head_dim, hidden_act="gelu_pytorch_tanh",
            hidden_activation="gelu_pytorch_tanh", attention_bias=False,
            **common))
    else:
        model = transformers.BloomForCausalLM(transformers.BloomConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            n_layer=cfg.num_layers, n_head=cfg.num_heads,
            layer_norm_epsilon=cfg.norm_eps))
    return cfg, model.float().eval()


def _numpy_sd(model):
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def _forward(params, cfg, ids):
    spec = StageSpec(0, 1, 0, cfg.num_layers)
    out, _ = stage_forward(
        params, cfg, spec, torch.from_numpy(ids),
        KVCache.create(cfg, cfg.num_layers, ids.shape[0], 32),
        torch.arange(ids.shape[1]).expand(ids.shape))
    return out.numpy()


def _assert_tree_equal(params, rp):
    for part in ("layers", "embed", "final_norm", "lm_head"):
        got, want = getattr(params, part), getattr(rp, part)
        assert sorted(got) == sorted(want), part
        for k, w in want.items():
            g = got[k]
            if isinstance(w, ref_quant.AnyQuantized):
                assert isinstance(g, quant.AnyQuantized), (part, k)
                np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
                np.testing.assert_array_equal(g.scale.numpy(),
                                              np.asarray(w.scale))
                continue
            w = np.asarray(w)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (part, k)
            gb = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 \
                else g.numpy()
            wb = w.view(np.int16) if w.dtype.name == "bfloat16" else w
            np.testing.assert_array_equal(gb, wb, err_msg=f"{part}/{k}")


def test_safetensors_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    g = torch.Generator().manual_seed(0)
    shards = {
        "model-00001-of-00002.safetensors": {
            "a.bf16": torch.randn(7, 5, generator=g).to(torch.bfloat16),
            "b.f32": torch.randn(3, generator=g),
            "c.i8": torch.randint(-100, 100, (4, 4), generator=g,
                                  dtype=torch.int8)},
        "model-00002-of-00002.safetensors": {
            "d.bf16": torch.randn(2, 3, 3, generator=g).to(torch.bfloat16),
            "e.f32": torch.randn(6, 2, generator=g),
            "scalar": torch.tensor(1.5)}}
    for fname, tensors in shards.items():
        safetensors_torch.save_file(tensors, str(tmp_path / fname),
                                    metadata={"format": "pt"})
    got = loader.load_safetensors_dir(str(tmp_path))
    want = {}
    for fname in shards:
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    only = loader.load_safetensors_dir(str(tmp_path),
                                       key_filter=lambda k: "bf16" in k)
    assert sorted(only) == ["a.bf16", "d.bf16"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        loader.load_safetensors_dir(str(tmp_path / "empty"))


def test_reader_runs_without_the_safetensors_package(tmp_path):
    """The machine with the card has no ``safetensors`` package: the
    port's loader reads a checkpoint in an interpreter where importing it
    fails."""
    import pathlib
    import subprocess
    import sys
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(
        torch.bfloat16)
    safetensors_torch.save_file({"w": t}, str(tmp_path / "m.safetensors"))
    code = (
        "import sys\n"
        "sys.modules['safetensors'] = None\n"
        "from distributed_inference_demo_tpu_torch.models import loader\n"
        f"w = loader.load_safetensors_dir({str(tmp_path)!r})['w']\n"
        "print(w.dtype, w.float().sum().item())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(loader.__file__).parents[2])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["torch.bfloat16", "66.0"]


@pytest.mark.parametrize("name", FAMILIES)
def test_params_from_state_dict_bit_equal_and_match_hf(name):
    cfg, model = _hf_model(name)
    sd = _numpy_sd(model)
    rp = ref_loader.params_from_state_dict(sd, ref_get_model_config(name))
    params = loader.params_from_state_dict(sd, cfg, "cpu")
    _assert_tree_equal(params, rp)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(PROMPT).long()
                     ).logits.float().numpy()
    np.testing.assert_allclose(_forward(params, cfg, PROMPT), want,
                               rtol=2e-4, atol=2e-4)
    # bf16 configs cast the f32 checkpoint as the reference does (RNE)
    b16 = cfg.replace(dtype_name="bfloat16")
    _assert_tree_equal(
        loader.params_from_state_dict(sd, b16, "cpu"),
        ref_loader.params_from_state_dict(
            sd, ref_get_model_config(name).replace(dtype_name="bfloat16")))


@pytest.mark.parametrize("name", ["llama-test-int8", "bloom-test-int4"])
def test_load_or_init_checkpoint_equals_reference(name, tmp_path):
    cfg, model = _hf_model(name)
    model.save_pretrained(tmp_path, safe_serialization=True)
    rp = ref_loader.load_or_init(name, ref_get_model_config(name),
                                 checkpoint_dir=str(tmp_path))
    params = loader.load_or_init(name, cfg, str(tmp_path), device="cpu")
    assert isinstance(params.layers["wq"], quant.AnyQuantized)
    _assert_tree_equal(params, rp)
    # quantize=False keeps the float tree of the same checkpoint
    flt = loader.load_or_init(name, cfg, str(tmp_path), quantize=False,
                              device="cpu")
    assert isinstance(flt.layers["wq"], torch.Tensor)


def test_orbax_directory_and_mixtral_are_refused(tmp_path):
    (tmp_path / loader.ORBAX_META).write_text("{}")
    cfg = get_model_config("llama-test-int8")
    with pytest.raises(ValueError, match="orbax"):
        loader.load_or_init("llama-test-int8", cfg, str(tmp_path),
                            device="cpu")
    # mixtral has a mapper since; a family without one is refused
    with pytest.raises(NotImplementedError, match="no state-dict mapper"):
        loader.params_from_state_dict(
            {}, get_model_config("llama-test").replace(family="falcon"),
            "cpu")


def test_random_path_is_seeded_and_quantized():
    cfg = get_model_config("llama-test-int4")
    a = loader.load_or_init("llama-test-int4", cfg, None, seed=3,
                            device="cpu")
    b = loader.load_or_init("llama-test-int4", cfg, "/nonexistent", seed=3,
                            device="cpu")
    assert isinstance(a.layers["w_up"], quant.QuantizedArray4)
    assert torch.equal(a.layers["w_up"].q, b.layers["w_up"].q)


def test_cli_serve_checkpoint_answers_greedy(tmp_path, monkeypatch, capsys):
    """``serve --model llama-test-int8 --checkpoint DIR --device cpu``
    serves the checkpoint's quantized weights: its greedy tokens equal an
    engine over ``load_or_init`` of the same directory."""
    from distributed_inference_demo_tpu_torch.ops.sampling import \
        SamplingParams
    from distributed_inference_demo_tpu_torch.runtime.engine import \
        InferenceEngine

    cfg, model = _hf_model("llama-test-int8")
    model.save_pretrained(tmp_path, safe_serialization=True)
    prompt = PROMPT[0].tolist()
    seen = {}

    def serve_briefly(self):
        self.start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/generate",
            data=json.dumps({"prompt_ids": [prompt],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            seen["tokens"] = json.loads(resp.read().decode())["tokens"]

    monkeypatch.setattr(InferenceHTTPServer, "serve_forever", serve_briefly)
    assert cli.main(["serve", "--model", "llama-test-int8", "--checkpoint",
                     str(tmp_path), "--device", "cpu", "--greedy",
                     "--max-seq", "64", "--http-port", "0"]) == 0
    params = loader.load_or_init("llama-test-int8", cfg, str(tmp_path),
                                 device="cpu")
    want = InferenceEngine(cfg, params, max_seq=64,
                           sampling=SamplingParams(greedy=True),
                           device="cpu").generate(PROMPT, 6).tokens
    assert seen["tokens"] == want.tolist()
    assert "SERVE_ENGINE llama-test-int8" in capsys.readouterr().out
