"""The flash kernel's two bf16 instances: which one a launch takes, and
what the wrapper refuses before any launch.

``flash_rows_per_block`` is plain Python, so the instance each of the
main path's shapes gets is pinned here on the CPU; the wrapper's checks
run on CPU tensors too.  Both instances are held against the plain
version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu_torch.ops import flash_attention as fa

H100_SMS = 132


@pytest.mark.parametrize("b,nkv,rows,want", [
    (1, 4, 64 * 8, 16),        # serve prefill: 64 tokens, TinyLlama g = 8
    (1, 4, 2048 * 8, 64),      # the longest plain-serve prompt
    (1, 4, 1500 * 8, 64),      # the serve phase's long prompt
    (1, 16, 37, 16),           # ragged rows: bloom-560m heads, g = 1
    (1, 4, 256 * 8, 16),       # 32 64-row blocks per kv head: 128 < 132
    (1, 4, 257 * 8, 64),       # 33: 132, one full wave
    (1, 16, 512, 16),          # g = 1 either side: 128 blocks
    (1, 16, 513, 64),          # 144 blocks
    (4, 4, 64 * 8, 16),        # b = 4, 64-token chunks: 128 blocks
    (4, 4, 512 * 8, 64),       # b = 4, 512-token chunks
])
def test_rows_per_block_at_the_path_shapes(b, nkv, rows, want):
    assert fa.flash_rows_per_block(b, nkv, rows, H100_SMS) == want


def test_rows_per_block_follows_the_sm_count():
    """The threshold is one wave of the card's SMs, whatever their
    number: 32 64-row blocks fill a 32-SM card, not a 33-SM one."""
    assert fa.flash_rows_per_block(1, 4, 512, 32) == 64
    assert fa.flash_rows_per_block(1, 4, 512, 33) == 16
    assert fa.flash_rows_per_block(1, 1, 1, 1) == 64


def _tensors(dtype, hd=64, offset=(0, 0, 0)):
    """q [1, 16, 4, hd] and caches [1, 2, 64, hd], each starting
    ``offset`` elements into its storage."""
    def make(shape, off):
        n = int(np.prod(shape))
        return torch.zeros(n + off, dtype=dtype)[off:].view(shape)
    return (make((1, 16, 4, hd), offset[0]), make((1, 2, 64, hd), offset[1]),
            make((1, 2, 64, hd), offset[2]))


@pytest.mark.parametrize("dtype,hd,offset,match", [
    (torch.bfloat16, 64, (1, 0, 0), "q must be 16-byte aligned"),
    (torch.bfloat16, 64, (0, 4, 0), "k_cache must be 16-byte aligned"),
    (torch.bfloat16, 64, (0, 0, 2), "v_cache must be 16-byte aligned"),
    (torch.bfloat16, 48, (0, 0, 0), "head_dim"),
    (torch.float16, 64, (0, 0, 0), "float32 or bfloat16"),
])
def test_wrapper_refuses_what_the_instances_do_not_take(dtype, hd, offset,
                                                        match):
    q, kc, vc = _tensors(dtype, hd, offset)
    with pytest.raises(ValueError, match=match):
        fa._check_cuda_args(q, kc, vc, 0, 16, None)


@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, (0, 8, 16)),   # 16-byte multiples
    (torch.float32, (1, 1, 1)),     # the f32 kernel makes scalar loads
])
def test_wrapper_takes_what_the_instances_take(dtype, offset):
    q, kc, vc = _tensors(dtype, 64, offset)
    fa._check_cuda_args(q, kc, vc, 0, 16, None)
