"""The f32 prefill kernels' launch rule (``csrc/f32_tile.cuh``): which
instance a launch takes, the blocks it makes, and the counters it moves.

``f32_rows_per_block`` is plain Python, shared by the flash wrapper and
the paged prefill wrapper, so the instance each of the main path's f32
shapes gets is pinned here on the CPU, either side of its threshold.  The
counters are checked through the wrappers' launch functions with the C
entry point replaced by a recorder (there is no card here); the kernels
themselves are held against their plain versions on the card by
``tests/test_torch_cuda_f32_prefill.py`` and ``chip_smoke.py``.
"""

import contextlib
import types

import pytest
import torch

from distributed_inference_demo_tpu_torch.ops import flash_attention as fa
from distributed_inference_demo_tpu_torch.ops import paged_attention as pa

H100_SMS = 132


@pytest.mark.parametrize("b,nkv,rows,hd,full_width,sms,want,blocks", [
    # TinyLlama (g = 8): the 64-token serve chunk, the fleet's f32 suffix
    # prefill: 16-row blocks, 4x the 64-row ones
    (1, 4, 64 * 8, 64, True, H100_SMS, 16, 128),
    # the bf16 kernel's threshold (one wave: 132 64-row blocks) is not
    # the f32 one's (one and a half: 198)
    (1, 4, 257 * 8, 64, True, H100_SMS, 16, 516),
    # either side of it: 392 and 393 tokens (196 and 200 64-row blocks)
    (1, 4, 392 * 8, 64, True, H100_SMS, 16, 784),
    (1, 4, 393 * 8, 64, True, H100_SMS, 64, 200),
    # the longest plain-serve prompt and the 1500-token one
    (1, 4, 2048 * 8, 64, True, H100_SMS, 64, 1024),
    (1, 4, 1500 * 8, 64, True, H100_SMS, 64, 752),
    # g = 1 (bloom-560m heads, ALiBi): 192 and 208 64-row blocks
    (1, 16, 768, 64, True, H100_SMS, 16, 768),
    (1, 16, 769, 64, True, H100_SMS, 64, 208),
    # b = 4 at 64- and 512-token chunks; b = 8 at 64 (the bench's)
    (4, 4, 64 * 8, 64, True, H100_SMS, 16, 512),
    (4, 4, 512 * 8, 64, True, H100_SMS, 64, 1024),
    (8, 4, 64 * 8, 64, True, H100_SMS, 64, 256),
    # hd 128 has the 64-row instance; hd 256 does not
    (1, 8, 2048 * 4, 128, True, H100_SMS, 64, 1024),
    (1, 1, 2048 * 8, 256, True, H100_SMS, 16, 1024),
    # byte pages (int8, e4m3) take 16-row blocks at any length
    (1, 4, 2048 * 8, 64, False, H100_SMS, 16, 4096),
    # the threshold follows the SM count: 32 64-row blocks are 1.5 waves
    # of 21 SMs, not of 22
    (1, 4, 512, 64, True, 21, 64, 32),
    (1, 4, 512, 64, True, 22, 16, 128),
])
def test_f32_rows_per_block_and_blocks(b, nkv, rows, hd, full_width, sms,
                                       want, blocks):
    got = fa.f32_rows_per_block(b, nkv, rows, hd, sms, full_width)
    assert got == want
    # the grid the C entry point makes: row blocks x kv heads x rows
    assert b * nkv * -(-rows // got) == blocks


class _Recorder:
    """A stand-in for a ctypes launch function: records its arguments and
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers' stream lookups answered without a card."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("wrapper,dtype,rows,wide,f32_wide", [
    ("flash", torch.float32, 16, 0, 0),
    ("flash", torch.float32, 64, 0, 1),
    ("flash", torch.bfloat16, 16, 0, 0),
    ("flash", torch.bfloat16, 64, 1, 0),
    ("paged", torch.float32, 16, 0, 0),
    ("paged", torch.float32, 64, 0, 1),
    ("paged", torch.bfloat16, pa.PREFILL_ROWS, 0, 0),
])
def test_launch_counts_and_passes_rows(monkeypatch, no_card, wrapper, dtype,
                                       rows, wide, f32_wide):
    """One launch moves ``launches`` by one, the bf16 64-row one
    ``wide_launches`` (flash), the f32 64-row one ``f32_wide_launches``;
    the C entry point receives the rows a block."""
    rec = _Recorder()
    q = torch.zeros((1, 16, 4, 64), dtype=dtype)
    if wrapper == "flash":
        monkeypatch.setattr(fa, "_kernel_fn", lambda: (rec, None))
        fn = fa.flash_attention
        kc = torch.zeros((1, 2, 64, 64), dtype=dtype)
        before = (fn.launches, fn.wide_launches, fn.f32_wide_launches)
        fa._launch(q, kc, kc.clone(), 0, 16, None, rows)
        after = (fn.launches, fn.wide_launches, fn.f32_wide_launches)
        # (..., scale, dtype, rows_per_block, stream)
        assert rec.calls[0][-2] == rows
    else:
        monkeypatch.setattr(pa, "_kernel_fns",
                            lambda: {("prefill", "full"): rec})
        fn = pa.paged_prefill_attention
        pk = torch.zeros((3, 2, 16, 64), dtype=dtype)
        tables = torch.zeros((1, 2), dtype=torch.int32)
        starts = torch.zeros((1,), dtype=torch.int32)
        before = (fn.launches, 0, fn.f32_wide_launches)
        pa._prefill_launch(q, pk, pk.clone(), tables, starts, None, "full",
                           rows)
        after = (fn.launches, 0, fn.f32_wide_launches)
        assert rec.calls[0][-2] == rows
    assert tuple(a - b for a, b in zip(after, before)) == (1, wide, f32_wide)
