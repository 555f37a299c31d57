"""Weight-only int8 / int4 quantization and quantized KV pages.

Counterpart of ``distributed_inference_demo_tpu/ops/quant.py``.

The weight rails: ``QuantizedArray`` (int8, symmetric per output channel)
and ``QuantizedArray4`` (int4, symmetric per ``group`` input rows, two
codes a byte along the input axis), their quantizers in the reference's
f32 operation order, and ``maybe_quantize``, which rewraps a float tree
for an ``-int8`` / ``-int4`` configuration.  ``dense`` contracts
activations with a float or quantized weight: a quantized weight is
dequantized to the activation dtype right at the contraction, as the
reference defines it.  On the card that contraction is one hand-written
kernel (``ops/quant_dense.py``), so the dequantized weight never reaches
device memory; on the CPU it is that kernel's plain version.

The KV half: ``QuantizedKVPages`` (int8, or int4 packed two codes a byte,
with a per-(token, kv head) f32 scale sidecar), its quantizer and the
page-width arithmetic; and the ``kv_cache_dtype`` storage cast to
float8 e4m3 (:func:`cast_kv`), which rounds as the reference's does.
"""

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .quant_dense import quant_dense

KV_DTYPES = ("bf16", "int8", "int4")
# the expert products of mixtral's MoE MLP (models/decoder._moe_mlp): a
# layer's [E, K, N] stack against the shared tokens, then against each
# expert's own plane of the activations
EXPERT_EQS = ("bsh,ehi->besi", "besi,eih->besh")


# the one reduced-precision storage the kv_cache_dtype knob takes: float8
# e4m3 (no inf; 0x7f / 0xff are NaN), half a bf16 cache's bytes
FLOAT8 = torch.float8_e4m3fn
KV_CACHE_DTYPES = ("float8_e4m3fn",)
_F8_MAX = 448.0          # the largest finite e4m3 value (code 0x7e)
_F8_OVERFLOW = 464.0     # halfway to the next step: past it, NaN


def resolve_kv_cache_dtype(kv_cache_dtype) -> Optional[torch.dtype]:
    """The ``kv_cache_dtype`` storage cast as a torch dtype, or None (the
    model's own dtype).  Takes "float8_e4m3fn" or ``torch.float8_e4m3fn``;
    anything else raises."""
    if not kv_cache_dtype:
        return None
    name = (str(kv_cache_dtype).replace("torch.", "")
            if isinstance(kv_cache_dtype, torch.dtype) else kv_cache_dtype)
    if name not in KV_CACHE_DTYPES:
        raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}; "
                         f"expected one of {KV_CACHE_DTYPES}")
    return FLOAT8


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor's uint8 view (the same bytes, so every indexing op
    torch has for uint8 works: some have no float8 kernel, on the CPU
    ``index_copy_`` and ``gather``); any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == FLOAT8 else t


def cast_kv(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as ``dtype``, for a KV write.  To float8 e4m3 it rounds as
    the reference's ``astype(float8_e4m3fn)`` (ml_dtypes, XLA) does:
    to nearest even, subnormals included, and a value past 464 in
    magnitude, an infinity or a NaN becomes NaN with its sign (0x7f /
    0xff).  torch's own cast saturates to +-448 instead (on the CPU), so
    the codes past 448 are set here and torch's are kept only below,
    where the two agree.  Elementwise on the device: no host sync."""
    if dtype != FLOAT8 or x.dtype == FLOAT8:
        return x.to(dtype)
    xf = x.float()
    mag = xf.abs()
    codes = xf.to(FLOAT8).view(torch.uint8)
    sign = torch.signbit(xf).to(torch.uint8) << 7
    codes = torch.where(mag > _F8_MAX, sign | 0x7E, codes)
    codes = torch.where((mag > _F8_OVERFLOW) | torch.isnan(xf), sign | 0x7F,
                        codes)
    return codes.view(FLOAT8)


def resolve_kv_dtype(kv_dtype: Optional[str] = None) -> str:
    """``kv_dtype`` arg over ``DWT_KV_DTYPE`` env over "bf16" — the one
    owner of KV-width resolution.  "bf16" names the full-width pages,
    which hold the model's own dtype (bf16 or f32)."""
    dt = kv_dtype or os.environ.get("DWT_KV_DTYPE", "") or "bf16"
    if dt not in KV_DTYPES:
        raise ValueError(
            f"unknown kv dtype {dt!r}; expected one of {KV_DTYPES}")
    return dt


# ---------------------------------------------------------------------------
# quantized weights
#
# Both classes keep the stacked layer axis (and any other leading axis) on
# every leaf, so ``w[i]`` indexes every leaf alike: a layer's view for
# ``StageParams.layer`` and a stage's slice for ``slice_stage``.


@dataclass
class QuantizedArray:
    """int8 values + float32 scale broadcastable over the last axis.

    ``q``: int8, the weight's shape; ``scale``: f32 ``(*1s, out)``, with
    the layer axis kept when quantized ``stacked``."""

    q: torch.Tensor
    scale: torch.Tensor
    bits = 8

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def nbytes(self):
        return self.q.nbytes + self.scale.nbytes

    def __getitem__(self, idx) -> "QuantizedArray":
        return QuantizedArray(q=self.q[idx], scale=self.scale[idx])

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def quantize_array(w: torch.Tensor, stacked: bool = False
                   ) -> QuantizedArray:
    """Symmetric per-output-channel (last axis) int8 quantization:
    ``max(absmax, 1e-8) / 127`` and round half to even, as the
    reference's.  With ``stacked`` the leading axis is the layer stack
    and gets its own scales."""
    wf = w.float()
    axes = tuple(range(1 if stacked else 0, w.ndim - 1))
    absmax = wf.abs().amax(dim=axes, keepdim=True) if axes else wf.abs()
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedArray(q=q, scale=scale)


@dataclass
class QuantizedArray4:
    """Packed int4 values + group-wise float32 scales.

    ``q``: uint8 ``(..., in/2, out)``, two codes a byte along the input
    axis (low nibble = even input index), each code offset by 8;
    ``scale``: f32 ``(..., in/group, 1, out)``."""

    q: torch.Tensor
    scale: torch.Tensor
    group: int
    bits = 4

    @property
    def shape(self):
        return (*self.q.shape[:-2], self.q.shape[-2] * 2, self.q.shape[-1])

    @property
    def nbytes(self):
        return self.q.nbytes + self.scale.nbytes

    def __getitem__(self, idx) -> "QuantizedArray4":
        return QuantizedArray4(q=self.q[idx], scale=self.scale[idx],
                               group=self.group)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        lo = (self.q & 0xF).to(torch.int8) - 8
        hi = (self.q >> 4).to(torch.int8) - 8
        v = torch.stack([lo, hi], dim=-2)          # (..., in/2, 2, out)
        *lead, half, _, out = v.shape
        full = half * 2
        v = v.reshape(*lead, full // self.group, self.group, out).float()
        v = v * self.scale                         # (..., in/g, 1, out)
        return v.reshape(*lead, full, out).to(dtype)


DEFAULT_INT4_GROUP = 64


def int4_group_for(inner: int) -> int:
    """The group size used for an input dim, shared by the quantizer and
    the layer-chunked init."""
    return min(DEFAULT_INT4_GROUP, inner)


def quantize_array4(w: torch.Tensor, group: Optional[int] = None
                    ) -> QuantizedArray4:
    """Symmetric group-wise int4 quantization along the input axis (axis
    -2): ``max(absmax, 1e-8) / 7``, round half to even, clip to [-8, 7],
    offset by 8 and pack two to a byte.  The input size must be even."""
    wf = w.float()
    *lead, inner, out = wf.shape
    if inner % 2:
        raise ValueError(f"int4 packing needs an even input dim, got "
                         f"{inner}")
    group = int4_group_for(inner) if group is None else min(group, inner)
    if inner % group:
        raise ValueError(f"group={group} does not divide input dim "
                         f"{inner}")
    gw = wf.reshape(*lead, inner // group, group, out)
    absmax = gw.abs().amax(dim=-2, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 7.0
    q = torch.round(gw / scale).clamp(-8, 7).to(torch.int8)
    pairs = (q.reshape(*lead, inner // 2, 2, out) + 8).to(torch.uint8)
    packed = pairs[..., 0, :] | (pairs[..., 1, :] << 4)
    return QuantizedArray4(q=packed, scale=scale, group=group)


AnyQuantized = (QuantizedArray, QuantizedArray4)

# the large matmul operands (mixtral's [L, E, K, N] expert stacks too);
# norm scales, biases and the MoE router keep the model dtype
_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_layer_params(layers: dict, mode: str = "int8") -> dict:
    def quant(v):
        if mode == "int4":
            return quantize_array4(v)
        return quantize_array(v, stacked=True)
    return {k: (quant(v)
                if k in _QUANTIZABLE and not isinstance(v, AnyQuantized)
                else v)
            for k, v in layers.items()}


def maybe_quantize(params, cfg):
    """Apply the config's quantization mode to a full StageParams tree
    (no-op for "none")."""
    if cfg.quantization not in ("int8", "int4"):
        return params
    from ..models.base import StageParams
    return StageParams(layers=quantize_layer_params(params.layers,
                                                    cfg.quantization),
                       embed=params.embed, final_norm=params.final_norm,
                       lm_head=params.lm_head)


def _is_matmul(eq: str) -> bool:
    """``eq`` contracts x's last axis with w's first: ``...k,kn->...n``."""
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return (len(b) == 2 and a[-1] == b[0] and b[1] not in a
            and out == a[:-1] + b[1])


def expert_weight(w, e: int):
    """Expert ``e``'s 2-D view of one layer's quantized [E, K, N] stack.
    An int8 stack's scale is shared by every expert (``[1, 1, N]``: the
    reference reduces over E and K), so each expert takes its one row;
    an int4 stack's has the E axis (``[E, K/g, 1, N]``)."""
    if isinstance(w, QuantizedArray4):
        return w[e]
    return QuantizedArray(q=w.q[e],
                          scale=w.scale[e if w.scale.shape[0] > 1 else 0])


def _expert_bmm(x: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
    """A float [E, K, N] expert stack's product, one batched matmul over
    the experts on the weight as stored (``torch.einsum`` copies the
    whole stack into [K, E x N] for the first equation, every call)."""
    E = w.shape[0]
    if eq == EXPERT_EQS[0]:                      # x [b, s, K], shared
        b, s, k = x.shape
        xe = x.reshape(1, b * s, k).expand(E, -1, -1)
    else:                                        # x [b, E, s, K]
        b, _, s, k = x.shape
        xe = x.transpose(0, 1).reshape(E, b * s, k)
    return torch.bmm(xe, w).view(E, b, s, -1).transpose(0, 1)


def dense(x: torch.Tensor, w, eq: str) -> torch.Tensor:
    """einsum of activations with a float or quantized weight.

    A quantized weight is dequantized to the activation dtype at the
    contraction (the reference's definition).  A 2-D quantized weight
    goes through ``ops/quant_dense.quant_dense``: on the card its kernel,
    which never writes the dequantized weight to device memory; on the
    CPU its plain version, ``x @ w.dequantize(x.dtype)``.  A 3-D expert
    stack takes one such product per expert (``EXPERT_EQS``), stacked on
    axis 1, so each expert's result is its 2-D product.  A float weight
    is a plain einsum everywhere, a float expert stack one ``bmm``."""
    eq = eq.replace(" ", "")
    if not isinstance(w, AnyQuantized):
        if w.ndim == 3 and eq in EXPERT_EQS:
            return _expert_bmm(x, w, eq)
        return torch.einsum(eq, x, w)
    if w.q.ndim == 3 and eq in EXPERT_EQS:
        shared = eq == EXPERT_EQS[0]
        outs = []
        for e in range(w.q.shape[0]):
            xe = x if shared else x[:, e]
            y = quant_dense(xe.reshape(-1, xe.shape[-1]),
                            expert_weight(w, e))
            outs.append(y.reshape(*xe.shape[:-1], y.shape[-1]))
        return torch.stack(outs, dim=1)
    if w.q.ndim != 2 or not _is_matmul(eq):
        raise ValueError(f"the quantized dense product takes x[..., K] @ "
                         f"W[K, N] or an expert stack ({EXPERT_EQS}); got "
                         f"{eq!r} over a {w.q.ndim}-D weight")
    y = quant_dense(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


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


def _levels(span: torch.Tensor, levels: float,
            compiled: bool) -> torch.Tensor:
    """``span / levels``, or ``span * (1 / levels)`` with the reciprocal
    rounded to f32 first, as XLA rewrites the division by a constant in
    the reference's compiled programs."""
    if compiled:
        return span * float(np.float32(1.0) / np.float32(levels))
    return span / levels


def quantize_kv_pages(x: torch.Tensor, bits: int,
                      compiled: bool = False) -> QuantizedKVPages:
    """Per-(..., token) quantization over the LAST axis (head_dim), in
    the reference's f32 operation order, so the same f32 input gives the
    same codes, scales and zeros.  int8 is symmetric, absmax / 127; int4
    is asymmetric over [min, max] in 15 levels, two codes a byte, the
    even lane in the low nibble.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does.  ``compiled``: the scales of the reference's
    jitted programs (its kvcache seam), where XLA multiplies by the
    reciprocal of 127 or 15 instead of dividing (one ulp apart at most)."""
    xf = x.float()
    if bits == 8:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
        scale = _levels(absmax.clamp_min(1e-8), 127.0, compiled)
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        return QuantizedKVPages(data=q, scale=scale, zero=None, bits=8)
    if bits != 4:
        raise ValueError(f"kv quantization is int8 or int4, got {bits}")
    d = xf.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even head_dim, got {d}")
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    scale = _levels((mx - mn).clamp_min(1e-8), 15.0, compiled)
    q = torch.round((xf - mn) / scale).clamp(0, 15).to(torch.uint8)
    pairs = q.reshape(*q.shape[:-1], d // 2, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 4)
    return QuantizedKVPages(data=packed, scale=scale, zero=mn, bits=4)


def quantize_kv_like(ref, x: torch.Tensor, compiled: bool = False):
    """Payload matching the pool tensor ``ref``: a dtype cast
    (:func:`cast_kv`) for a plain pool, quantized leaves (see
    :func:`quantize_kv_pages` for ``compiled``) for a quantized one."""
    if isinstance(ref, QuantizedKVPages):
        return quantize_kv_pages(x, ref.bits, compiled)
    return cast_kv(x, ref.dtype)


def dequantize_kv(x, dtype=torch.float32) -> torch.Tensor:
    """Full-width view of ``x`` (a plain tensor or QuantizedKVPages)."""
    if isinstance(x, QuantizedKVPages):
        return x.dequantize(dtype)
    return x.to(dtype)


def alloc_kv_pages(shape, kv_dtype: Optional[str], base_dtype, device=None):
    """One zeroed pool for a ``(..., pages, nkv, bt, head_dim)`` shape: a
    plain ``base_dtype`` tensor for "bf16" (the model's dtype, or float8
    under a ``kv_cache_dtype`` cast), :class:`QuantizedKVPages` for
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
