"""Weights and KV pages carried across from the JAX package.

``params_from_numpy`` takes the JAX package's ``StageParams`` leaves as
numpy arrays, ``{"layers": {...}, "embed": {...}, "final_norm": {...},
"lm_head": {...}}``, and returns the port's ``StageParams`` on a device,
so both packages can run on the same weights.  A quantized leaf of the
reference (``QuantizedArray`` / ``QuantizedArray4``) travels as a dict of
its fields, ``{"q": ..., "scale": ...}`` plus ``"group"`` for int4, and
becomes the port's class over the same codes and scales.
``kv_pages_from_numpy`` does the same for a quantized page pool, and
``shard_from_numpy`` cuts the tree into one rank's tensor-parallel (or
expert-parallel) slice, and ``vision_params_from_numpy`` carries the
reference's vision tower and projector (``models/vision.py``).  The
conversion from JAX arrays to numpy happens in the caller, never here:
this module does not import JAX.  :func:`save_npz_tree` writes such a
tree to one ``.npz`` file, and ``params_from_numpy`` takes that file's
path too: how a port process (``worker --weights-npz``) runs on the
reference's weights.
"""

import os

import numpy as np
import torch

from ..comm.wire import Bf16Bits
from ..device import resolve_device
from ..ops.quant import QuantizedArray, QuantizedArray4, QuantizedKVPages
from .base import ModelConfig, StageParams


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device``.  A bfloat16 array (numpy
    dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    travels as its uint16 bit pattern."""
    bits = isinstance(arr, Bf16Bits)
    arr = np.ascontiguousarray(arr)
    if bits or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


_PARTS = ("layers", "embed", "final_norm", "lm_head")
_BF16 = "@bf16"


def save_npz_tree(tree: dict, path) -> None:
    """Write a tree as :func:`params_from_numpy` takes it to one ``.npz``
    file: a leaf at ``part/name`` (a quantized leaf's fields at
    ``part/name/field``), a bfloat16 array as its uint16 bits under a
    ``@bf16`` suffix, an absent part as nothing."""
    flat = {}

    def put(key, arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            flat[key + _BF16] = arr.view(np.uint16)
        else:
            flat[key] = arr

    for part in _PARTS:
        for name, v in (tree.get(part) or {}).items():
            if isinstance(v, dict):
                for field, arr in v.items():
                    put(f"{part}/{name}/{field}", arr)
            else:
                put(f"{part}/{name}", v)
    np.savez(path, **flat)


def load_npz_tree(path) -> dict:
    """The tree :func:`save_npz_tree` wrote (bfloat16 leaves as
    ``comm.wire.Bf16Bits``; a part with no leaf as an empty dict)."""
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            arr = f[key]
            if key.endswith(_BF16):
                key, arr = key[:-len(_BF16)], arr.view(Bf16Bits)
            part, name, *field = key.split("/")
            leaves = tree.setdefault(part, {})
            if field:
                leaves.setdefault(name, {})[field[0]] = (
                    int(arr) if field[0] == "group" else arr)
            else:
                leaves[name] = arr
    return tree


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> StageParams:
    """The reference's parameter tree (numpy leaves), or the path of an
    ``.npz`` file :func:`save_npz_tree` wrote, as the port's
    ``StageParams`` on ``device`` (CUDA unless the CPU is asked for)."""
    device = resolve_device(device)
    if isinstance(tree, (str, os.PathLike)):
        tree = load_npz_tree(tree)

    def leaf(v):
        if not isinstance(v, dict):
            return tensor_from_numpy(v, device)
        q = tensor_from_numpy(v["q"], device)
        scale = tensor_from_numpy(v["scale"], device)
        if "group" in v:
            return QuantizedArray4(q=q, scale=scale, group=int(v["group"]))
        return QuantizedArray(q=q, scale=scale)

    def part(name):
        leaves = tree.get(name)
        if leaves is None:
            return None
        return {k: leaf(v) for k, v in leaves.items()}

    return StageParams(layers=part("layers"), embed=part("embed"),
                       final_norm=part("final_norm"),
                       lm_head=part("lm_head"))


def vision_params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's vision params (``init_vision_params``'s tree:
    top-level leaves and a ``layers`` dict of stacked leaves, as numpy
    arrays) as the port's ``models/vision.py`` tree on ``device``."""
    device = resolve_device(device)
    return {k: ({n: tensor_from_numpy(a, device) for n, a in v.items()}
                if isinstance(v, dict) else tensor_from_numpy(v, device))
            for k, v in tree.items()}


def shard_from_numpy(tree: dict, cfg: ModelConfig, shape: dict, rank: int,
                     device=None, specs=None) -> StageParams:
    """Rank ``rank``'s slice of the reference's parameter tree (numpy
    leaves, as :func:`params_from_numpy` takes them) on a mesh of axis
    sizes ``shape`` (``{"tp": 2}``): the tree cut by the port's spec tree
    (``parallel/sharding.py``; default the engines' tp layout, replicated
    embed, vocab-parallel head), then carried across.  A rank's slice
    equals the reference's ``shard_params`` shard on the mesh's device
    ``rank``."""
    from ..parallel.sharding import (rank_coords, shard_tree,
                                     stage_param_spec_tree)

    def leaf(v):
        if not isinstance(v, dict):
            return np.asarray(v)
        if "group" in v:
            return QuantizedArray4(q=np.asarray(v["q"]),
                                   scale=np.asarray(v["scale"]),
                                   group=int(v["group"]))
        return QuantizedArray(q=np.asarray(v["q"]),
                              scale=np.asarray(v["scale"]))

    full = StageParams(**{n: (None if tree.get(n) is None else
                              {k: leaf(v) for k, v in tree[n].items()})
                          for n in ("layers", "embed", "final_norm",
                                    "lm_head")})
    if specs is None:
        specs = stage_param_spec_tree(full, cfg, vocab_parallel_embed=False)
    part = shard_tree(full, specs, rank_coords(shape, rank), shape)

    def back(v):
        if isinstance(v, QuantizedArray4):
            return {"q": v.q, "scale": v.scale, "group": v.group}
        if isinstance(v, QuantizedArray):
            return {"q": v.q, "scale": v.scale}
        return v

    return params_from_numpy(
        {n: (None if getattr(part, n) is None else
             {k: back(v) for k, v in getattr(part, n).items()})
         for n in ("layers", "embed", "final_norm", "lm_head")},
        cfg, device)


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
