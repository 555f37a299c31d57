"""Weight contractions and the KV page-width arithmetic.

Counterpart of ``distributed_inference_demo_tpu/ops/quant.py``, for float
weights and full-width (bf16/f32) KV pages only: ``QuantizedArray``,
``QuantizedArray4`` and ``QuantizedKVPages`` are ported in a later slice,
and until then a quantized configuration is refused where weights are
made or served, and an int8/int4 page width where pages are sized.
"""

import os
from typing import Optional

import numpy as np
import torch

QUANT_LATER = "quantized weights are ported in a later slice"
KV_QUANT_LATER = ("int8/int4 KV pages are ported in a later slice "
                  "(ROADMAP A2)")
KV_DTYPES = ("bf16", "int8", "int4")


def resolve_kv_dtype(kv_dtype: Optional[str] = None) -> str:
    """``kv_dtype`` arg over ``DWT_KV_DTYPE`` env over "bf16" — the one
    owner of KV-width resolution.  "bf16" names the full-width pages,
    which hold the model's own dtype (bf16 or f32)."""
    dt = kv_dtype or os.environ.get("DWT_KV_DTYPE", "") or "bf16"
    if dt not in KV_DTYPES:
        raise ValueError(
            f"unknown kv dtype {dt!r}; expected one of {KV_DTYPES}")
    return dt


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def kv_token_head_bytes(head_dim: int, kv_dtype: Optional[str],
                        base_dtype) -> int:
    """Bytes one (token, kv-head) of ONE tensor (K or V) occupies in the
    page pool.  Full-width pages only; the quantized widths raise."""
    if resolve_kv_dtype(kv_dtype) != "bf16":
        raise NotImplementedError(KV_QUANT_LATER)
    return head_dim * _itemsize(base_dtype)


def kv_scale_token_head_bytes(kv_dtype: Optional[str]) -> int:
    """The scale-sidecar share of :func:`kv_token_head_bytes`: 0 for
    full-width pages; the quantized widths raise."""
    if resolve_kv_dtype(kv_dtype) != "bf16":
        raise NotImplementedError(KV_QUANT_LATER)
    return 0


def require_float_weights(cfg) -> None:
    """Raise for an ``-int8`` / ``-int4`` configuration."""
    if cfg.quantization != "none":
        raise NotImplementedError(
            f"{cfg.quantization} weights: {QUANT_LATER}")


def dense(x: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum of activations with a float weight (the reference's
    ``dense`` with the dequantize step left out)."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(QUANT_LATER)
    return torch.einsum(eq, x, w)
