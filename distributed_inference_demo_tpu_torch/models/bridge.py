"""Weights and KV pages carried across from the JAX package.

``params_from_numpy`` takes the JAX package's ``StageParams`` leaves as
numpy arrays, ``{"layers": {...}, "embed": {...}, "final_norm": {...},
"lm_head": {...}}``, and returns the port's ``StageParams`` on a device,
so both packages can run on the same weights.  ``kv_pages_from_numpy``
does the same for a quantized page pool.  The conversion from JAX arrays
to numpy happens in the caller, never here: this module does not import
JAX.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import QuantizedKVPages, require_float_weights
from .base import ModelConfig, StageParams


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device``.  A bfloat16 array (numpy
    dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    travels as its uint16 bit pattern."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None
                      ) -> StageParams:
    """The reference's parameter tree (numpy leaves) as the port's
    ``StageParams`` on ``device`` (CUDA unless the CPU is asked for)."""
    require_float_weights(cfg)
    device = resolve_device(device)

    def part(name):
        leaves = tree.get(name)
        if leaves is None:
            return None
        return {k: tensor_from_numpy(v, device) for k, v in leaves.items()}

    return StageParams(layers=part("layers"), embed=part("embed"),
                       final_norm=part("final_norm"),
                       lm_head=part("lm_head"))


def kv_pages_from_numpy(data: np.ndarray, scale: np.ndarray,
                        zero, bits: int, device=None) -> QuantizedKVPages:
    """The reference's ``QuantizedKVPages`` pool of one layer, ``[N, nkv,
    bt, ·]`` (its ``data``, ``scale`` and ``zero`` leaves as numpy arrays,
    ``zero`` None for int8), as the port's on ``device``, with the port's
    drop page appended after the N pages.  The drop page is zeroed, so
    every page stays finite."""
    device = resolve_device(device)

    def leaf(arr):
        arr = np.asarray(arr)
        pad = [(0, 1)] + [(0, 0)] * (arr.ndim - 1)
        return tensor_from_numpy(np.pad(arr, pad), device)

    return QuantizedKVPages(data=leaf(data), scale=leaf(scale),
                            zero=None if zero is None else leaf(zero),
                            bits=int(bits))
