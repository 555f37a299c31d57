"""The pipeline (``parallel/pipeline.py``) on a card: two pp ranks over
gloo share the one card (NCCL refuses two ranks on one device).

Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch, without the repo's conftest:

    python -m pytest tests/test_torch_cuda_pipeline.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import StageParams
from distributed_inference_demo_tpu_torch.models.decoder import \
    init_full_params
from distributed_inference_demo_tpu_torch.ops import quant
from distributed_inference_demo_tpu_torch.parallel.mesh import (MeshConfig,
                                                                local_mesh)
from distributed_inference_demo_tpu_torch.parallel.pipeline import \
    pipeline_loss
from distributed_inference_demo_tpu_torch.parallel.tensor import \
    rank_launches

LOGIT_TOL_REL = 5e-2      # of max(1, max |twin logit|), as chip_smoke's


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pp2_int8_forward_through_the_dense_kernel(cuda_device):
    """``pipeline_apply`` over a small bf16 llama's int8 tree at pp=2:
    the last rank's logits equal its dequantised twin's within
    LOGIT_TOL_REL of the twin's largest (the loss alone barely sees the
    layers: the final norm fixes the hidden state's scale), and each
    rank launched the dense kernel 7 x its layers x the microbatches
    (one 128-row product each: the prefill kernel)."""
    cfg = get_model_config("llama-test-int8").replace(
        hidden_size=256, intermediate_size=512, num_layers=4,
        dtype_name="bfloat16")
    params = init_full_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, cuda_device,
        quantize=True)
    twin = StageParams(
        layers={k: v.dequantize(cfg.dtype) if isinstance(
            v, quant.AnyQuantized) else v for k, v in params.layers.items()},
        embed=params.embed, final_norm=params.final_norm,
        lm_head=params.lm_head)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 2, 64)))
    targets = torch.roll(ids, -1, 2)
    targets[..., -1] = -100
    with local_mesh(MeshConfig(pp=2), cuda_device) as mesh:
        _, want = pipeline_loss(twin, cfg, mesh, ids, targets,
                                return_logits=True)
        rank_launches(mesh, reset=True)
        _, got = pipeline_loss(params, cfg, mesh, ids, targets,
                               return_logits=True)
        counts = [(r["quant_dense"]["launches"],
                   r["quant_dense"]["decode_launches"])
                  for r in rank_launches(mesh)]
    got, want = got.float(), want.float()
    assert got.shape == (2, 2, 64, cfg.vocab_size)
    assert torch.isfinite(got).all()
    tol = LOGIT_TOL_REL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert counts == [(7 * 2 * 2, 0)] * 2
