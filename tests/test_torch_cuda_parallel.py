"""Tensor parallelism on a card: two ranks over gloo share the one card
(NCCL refuses two ranks on one device), each rank's attention through
the flash kernel at its head count.

Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch, without the repo's conftest:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import \
    rank_launches
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine

GREEDY = SamplingParams(greedy=True)


@pytest.mark.cuda
def test_tp2_tokens_on_the_card_equal_tp1():
    """The tp=2 engine's f32 greedy tokens equal tp=1's, and each rank
    launched the flash kernel L times for the one prefill (llama-test at
    256 wide: 4 heads of 64, a head dim the kernel has)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_model_config("llama-test").replace(hidden_size=256,
                                                 intermediate_size=512)
    params = init_full_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, "cuda")
    prompt = np.arange(1, 33).reshape(1, 32) % cfg.vocab_size
    want = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY
                           ).generate(prompt, 8).tokens
    with local_tp_mesh(2) as mesh:
        eng = InferenceEngine(cfg, params, max_seq=64, sampling=GREEDY,
                              mesh=mesh, cuda_graph=False)
        rank_launches(mesh, reset=True)
        got = eng.generate(prompt, 8).tokens
        counts = [r["flash"]["launches"] for r in rank_launches(mesh)]
    np.testing.assert_array_equal(got, want)
    assert counts == [cfg.num_layers] * 2
