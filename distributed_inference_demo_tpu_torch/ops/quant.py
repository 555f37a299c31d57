"""Weight contractions and quantized KV pages.

Counterpart of ``distributed_inference_demo_tpu/ops/quant.py``.  Float
weights only: ``QuantizedArray`` and ``QuantizedArray4`` are ported in a
later slice (ROADMAP A2), and until then a quantized configuration is
refused where weights are made or served.  The KV half is ported:
``QuantizedKVPages`` (int8, or int4 packed two codes a byte, with a
per-(token, kv head) f32 scale sidecar), its quantizer and the page-width
arithmetic.
"""

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

QUANT_LATER = "quantized weights are ported in a later slice"
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


# ---------------------------------------------------------------------------
# quantized KV pages
#
# Per-token granularity over head_dim: a page is written once per token
# at insert time, so the token's own absmax (int8) or min/max (int4) is
# the only statistic there is, and the sidecar keeps the data leaf's
# leading axes with a trailing 1, so one index serves data and scales.


@dataclass
class QuantizedKVPages:
    """Narrow KV pages with a per-(..., token) scale sidecar over the last
    axis.

    ``data``: int8 ``(..., hd)`` (bits 8, symmetric) or uint8
    ``(..., hd/2)`` (bits 4, asymmetric, low nibble = even lane);
    ``scale``: f32 ``(..., 1)``; ``zero``: f32 ``(..., 1)``, the minimum,
    for int4, None for int8.  Every leaf keeps the full leading axes, so
    ``pages[i]`` (a layer of a stacked pool, or a gather of page ids)
    indexes every leaf alike and returns views where torch does: a
    write into a per-layer view lands in the pool."""

    data: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    bits: int

    def leaves(self):
        return [t for t in (self.data, self.scale, self.zero)
                if t is not None]

    def __getitem__(self, idx) -> "QuantizedKVPages":
        return QuantizedKVPages(
            data=self.data[idx], scale=self.scale[idx],
            zero=None if self.zero is None else self.zero[idx],
            bits=self.bits)

    @property
    def shape(self):
        """LOGICAL shape (full head_dim, nibbles unpacked)."""
        d = self.data.shape[-1] * (2 if self.bits == 4 else 1)
        return (*self.data.shape[:-1], d)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in self.leaves())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """``code * scale`` (int8) or ``code * scale + zero`` (int4) in f32,
        then ``dtype``: the reference's operation order."""
        if self.bits == 8:
            return (self.data.float() * self.scale).to(dtype)
        lo = (self.data & 0xF).float()
        hi = (self.data >> 4).float()
        v = torch.stack([lo, hi], dim=-1)             # (..., hd/2, 2)
        v = v.reshape(*v.shape[:-2], v.shape[-2] * 2)
        return (v * self.scale + self.zero).to(dtype)


def quantize_kv_pages(x: torch.Tensor, bits: int) -> QuantizedKVPages:
    """Per-(..., token) quantization over the LAST axis (head_dim), in
    the reference's f32 operation order, so the same f32 input gives the
    same codes, scales and zeros.  int8 is symmetric, absmax / 127; int4
    is asymmetric over [min, max] in 15 levels, two codes a byte, the
    even lane in the low nibble.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    xf = x.float()
    if bits == 8:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
        scale = absmax.clamp_min(1e-8) / 127.0
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        return QuantizedKVPages(data=q, scale=scale, zero=None, bits=8)
    if bits != 4:
        raise ValueError(f"kv quantization is int8 or int4, got {bits}")
    d = xf.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even head_dim, got {d}")
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    scale = (mx - mn).clamp_min(1e-8) / 15.0
    q = torch.round((xf - mn) / scale).clamp(0, 15).to(torch.uint8)
    pairs = q.reshape(*q.shape[:-1], d // 2, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 4)
    return QuantizedKVPages(data=packed, scale=scale, zero=mn, bits=4)


def quantize_kv_like(ref, x: torch.Tensor):
    """Payload matching the pool tensor ``ref``: a dtype cast for a plain
    pool, quantized leaves for a quantized one."""
    if isinstance(ref, QuantizedKVPages):
        return quantize_kv_pages(x, ref.bits)
    return x.to(ref.dtype)


def dequantize_kv(x, dtype=torch.float32) -> torch.Tensor:
    """Full-width view of ``x`` (a plain tensor or QuantizedKVPages)."""
    if isinstance(x, QuantizedKVPages):
        return x.dequantize(dtype)
    return x.to(dtype)


def alloc_kv_pages(shape, kv_dtype: Optional[str], base_dtype, device=None):
    """One zeroed pool for a ``(..., pages, nkv, bt, head_dim)`` shape: a
    plain ``base_dtype`` tensor for "bf16", :class:`QuantizedKVPages` for
    int8/int4.  ``shape`` counts every page the pool holds, the port's
    drop page included (``ops/paged_attention.write_paged_kv``); zeros
    keep every page, the drop page too, finite for the reads that clamp
    into it."""
    kv_dtype = resolve_kv_dtype(kv_dtype)
    *lead, d = shape
    if kv_dtype == "bf16":
        return torch.zeros(shape, dtype=base_dtype, device=device)
    side = dict(dtype=torch.float32, device=device)
    if kv_dtype == "int8":
        return QuantizedKVPages(
            data=torch.zeros((*lead, d), dtype=torch.int8, device=device),
            scale=torch.zeros((*lead, 1), **side), zero=None, bits=8)
    return QuantizedKVPages(
        data=torch.zeros((*lead, d // 2), dtype=torch.uint8, device=device),
        scale=torch.zeros((*lead, 1), **side),
        zero=torch.zeros((*lead, 1), **side), bits=4)


def kv_token_head_bytes(head_dim: int, kv_dtype: Optional[str],
                        base_dtype) -> int:
    """Bytes one (token, kv-head) of ONE tensor (K or V) occupies in the
    page pool, the scale/zero sidecar included: the one owner of the
    page-width arithmetic."""
    kv_dtype = resolve_kv_dtype(kv_dtype)
    if kv_dtype == "bf16":
        return head_dim * _itemsize(base_dtype)
    if kv_dtype == "int8":
        return head_dim + 4                  # int8 lanes + f32 scale
    return head_dim // 2 + 8                 # packed nibbles + scale + zero


def kv_scale_token_head_bytes(kv_dtype: Optional[str]) -> int:
    """The sidecar-only share of :func:`kv_token_head_bytes`."""
    return {"bf16": 0, "int8": 4, "int4": 8}[resolve_kv_dtype(kv_dtype)]


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
