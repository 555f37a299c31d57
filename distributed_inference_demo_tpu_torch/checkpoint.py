"""Checkpoint/resume: parameter trees and train state, in safetensors.

Counterpart of ``distributed_inference_demo_tpu/checkpoint.py``, which
writes orbax checkpoints.  The card machine has neither orbax nor the
``safetensors`` package, so the port writes safetensors itself
(``models/loader.write_safetensors``) and reads them with its own reader
(``models/loader.read_safetensors``).

- :func:`save_params` / :func:`load_params`: one parameter tree in
  ``params.safetensors`` beside the reference's ``framework_meta.json``
  sidecar (the same keys and values: model name, quantization, the
  config's sizes, user metadata).  Loading validates the model's
  identity with the reference's messages and restores onto the skeleton
  of the config's tree (:func:`_abstract_params`, on the ``meta``
  device: nothing is materialised), so shapes, dtypes and quantized
  leaves survive bit for bit.  A leaf is stored under ``part/key``, a
  quantized leaf's codes and scales under ``part/key/q`` and
  ``part/key/scale``; an int4 leaf's group size goes in the file's
  ``__metadata__``, with the port's ``format`` marker.
- :class:`TrainCheckpointManager`: step-versioned ``{params, opt_state}``
  checkpoints in ``directory/<step>/``, with retention (``max_to_keep``),
  ``latest_step`` / ``all_steps`` found on disk, and crash-resume
  semantics: a step is written aside and renamed into place, so a crash
  leaves no half step.  The optimizer is a factory over a list of
  tensors (``functools.partial(torch.optim.AdamW, ...)``), built over
  the tree's float leaves in ``parallel.pipeline.trainable_leaves``'
  order; the counterpart of ``optimizer.init`` is what the factory
  builds.  Its ``state_dict()`` is stored as safetensors (its tensors)
  and JSON (its param groups and other values).
"""

import json
import os
import shutil
from typing import Any, Optional, Tuple

import torch

from .device import resolve_device
from .models.base import ModelConfig, StageParams
from .models.decoder import init_full_params
from .models.loader import read_safetensors, write_safetensors
from .ops.quant import QuantizedArray, QuantizedArray4

_META = "framework_meta.json"
PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.safetensors"
OPT_JSON = "opt_state.json"
FORMAT = "distributed_inference_demo_tpu_torch"
_PARTS = ("layers", "embed", "final_norm", "lm_head")


def _quantized(cfg: ModelConfig) -> bool:
    return cfg.quantization in ("int8", "int4")


def _abstract_params(cfg: ModelConfig) -> StageParams:
    """Shape/dtype skeleton of a full parameter tree on the ``meta``
    device, no materialization; an ``-int8`` / ``-int4`` config gets
    its quantized leaves (as ``models.loader.load_or_init`` inits
    them)."""
    return init_full_params(torch.Generator().manual_seed(0), cfg, "meta",
                            quantize=_quantized(cfg))


def _flatten(params: StageParams) -> Tuple[dict, dict]:
    """A tree's tensors by name, and the int4 group sizes by name."""
    tensors, groups = {}, {}
    for part in _PARTS:
        for key, v in (getattr(params, part) or {}).items():
            name = f"{part}/{key}"
            if torch.is_tensor(v):
                tensors[name] = v
                continue
            tensors[name + "/q"] = v.q
            tensors[name + "/scale"] = v.scale
            if isinstance(v, QuantizedArray4):
                groups[name + "/group"] = str(v.group)
    return tensors, groups


def _restore_tree(path: str, template: StageParams, device) -> StageParams:
    """The tree of ``template``'s structure from the safetensors file at
    ``path``, each tensor checked against the template's shape and dtype
    (and an int4 leaf's group size), on ``device``."""
    raw, meta = read_safetensors(path, with_metadata=True)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a parameter file of this port "
                         f"(format {meta.get('format')!r})")

    def take(name, like):
        if name not in raw:
            raise ValueError(f"{path} has no tensor {name}")
        t = raw[name]
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(
                f"{path}: {name} is {t.dtype}{list(t.shape)}, the config's "
                f"tree holds {like.dtype}{list(like.shape)}")
        return t.to(device)

    def leaf(name, v):
        if torch.is_tensor(v):
            return take(name, v)
        q, scale = take(name + "/q", v.q), take(name + "/scale", v.scale)
        if isinstance(v, QuantizedArray4):
            group = int(meta.get(name + "/group", -1))
            if group != v.group:
                raise ValueError(f"{path}: {name} has int4 group {group}, "
                                 f"the config's tree {v.group}")
            return QuantizedArray4(q=q, scale=scale, group=group)
        return QuantizedArray(q=q, scale=scale)

    return StageParams(**{
        part: (None if getattr(template, part) is None else
               {k: leaf(f"{part}/{k}", v)
                for k, v in getattr(template, part).items()})
        for part in _PARTS})


def _write_tree(path: str, params: StageParams) -> None:
    tensors, groups = _flatten(params)
    write_safetensors(path, tensors, {"format": FORMAT, **groups})


def save_params(path: str, params: StageParams, cfg: ModelConfig,
                model_name: str, metadata: Optional[dict] = None) -> None:
    """Write a parameter checkpoint + metadata sidecar at ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write_tree(os.path.join(path, PARAMS_FILE), params)
    meta = {
        "model": model_name,
        "quantization": cfg.quantization,
        "num_layers": cfg.num_layers,
        "hidden_size": cfg.hidden_size,
        "vocab_size": cfg.vocab_size,
        "metadata": metadata or {},
    }
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(path, _META))


def load_params(path: str, cfg: ModelConfig,
                model_name: Optional[str] = None, device=None
                ) -> Tuple[StageParams, dict]:
    """Restore a parameter checkpoint on ``device`` (CUDA unless the CPU
    is asked for); validates model identity when ``model_name`` is
    given.  Returns (params, metadata dict)."""
    device = resolve_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if model_name is not None and meta["model"] != model_name:
        raise ValueError(
            f"checkpoint at {path} is for model {meta['model']!r}, "
            f"not {model_name!r}")
    for field, want in (("num_layers", cfg.num_layers),
                        ("hidden_size", cfg.hidden_size),
                        ("vocab_size", cfg.vocab_size),
                        ("quantization", cfg.quantization)):
        if meta.get(field) != want:
            raise ValueError(
                f"checkpoint {field}={meta.get(field)!r} does not match "
                f"config {field}={want!r}")
    params = _restore_tree(os.path.join(path, PARAMS_FILE),
                           _abstract_params(cfg), device)
    return params, meta


def _encode(x):
    """A state-dict value as JSON (tuples tagged, so they come back)."""
    if isinstance(x, tuple):
        return {"tuple": [_encode(v) for v in x]}
    if isinstance(x, list):
        return [_encode(v) for v in x]
    if isinstance(x, dict):
        return {"dict": [[_encode(k), _encode(v)] for k, v in x.items()]}
    return x


def _decode(x):
    if isinstance(x, list):
        return [_decode(v) for v in x]
    if isinstance(x, dict):
        if "tuple" in x:
            return tuple(_decode(v) for v in x["tuple"])
        return {_decode(k): _decode(v) for k, v in x["dict"]}
    return x


def _optimizer_leaves(params: StageParams) -> list:
    from .parallel.pipeline import trainable_leaves
    return [v for _, _, v in trainable_leaves(params)]


class TrainCheckpointManager:
    """Step-versioned {params, opt_state} checkpoints with retention.

    Usage::

        mgr = TrainCheckpointManager(dir, cfg, optimizer, max_to_keep=3)
        step0, params, opt_state = mgr.restore_or_init(seed=0)  # resume
        ...
        mgr.save(step, params, opt_state)

    ``optimizer`` is a factory over a list of tensors; ``opt_state`` an
    optimizer (or its ``state_dict()``) over ``params``' float leaves in
    ``trainable_leaves``' order, as the factory builds it and as
    ``parallel.pipeline.make_pipeline_train_step`` returns it on a
    one-rank mesh.  Restored trees land on ``device`` (CUDA unless the
    CPU is asked for)."""

    def __init__(self, directory: str, cfg: ModelConfig, optimizer: Any,
                 max_to_keep: int = 3, device=None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.device = resolve_device(device)
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, params: StageParams, opt_state: Any) -> None:
        """Write step ``step`` (aside, then renamed into place) and drop
        the oldest steps past ``max_to_keep``; synchronous."""
        sd = (opt_state.state_dict() if hasattr(opt_state, "state_dict")
              else opt_state)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_tree(os.path.join(tmp, PARAMS_FILE), params)
        tensors, values = {}, {}
        for i, st in sd["state"].items():
            values[str(i)] = {}
            for n, x in st.items():
                if torch.is_tensor(x):
                    tensors[f"state/{i}/{n}"] = x
                else:
                    values[str(i)][n] = _encode(x)
        write_safetensors(os.path.join(tmp, OPT_FILE), tensors,
                          {"format": FORMAT})
        with open(os.path.join(tmp, OPT_JSON), "w") as f:
            json.dump({"state": values,
                       "param_groups": _encode(sd["param_groups"])}, f)
        final = os.path.join(self.directory, str(int(step)))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        steps = self.all_steps()
        if self.max_to_keep:
            for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        """The saved steps, oldest first (directories named by a step;
        a save in flight is not one)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(
                          os.path.join(self.directory, n)))

    def restore(self, step: Optional[int] = None):
        """Restore (params, opt_state) at ``step`` (default: latest):
        the tree, and the factory's optimizer over it with the saved
        state loaded."""
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, str(int(step)))
        params = _restore_tree(os.path.join(d, PARAMS_FILE),
                               _abstract_params(self.cfg), self.device)
        with open(os.path.join(d, OPT_JSON)) as f:
            js = json.load(f)
        raw = read_safetensors(os.path.join(d, OPT_FILE))
        state = {int(i): {n: _decode(x) for n, x in vals.items()}
                 for i, vals in js["state"].items()}
        for name, t in raw.items():
            _, i, n = name.split("/", 2)
            state[int(i)][n] = t
        opt = self.optimizer(_optimizer_leaves(params))
        opt.load_state_dict({"state": state,
                             "param_groups": _decode(js["param_groups"])})
        return params, opt

    def restore_or_init(self, seed: int = 0):
        """Crash-resume entry point: (step, params, opt_state) from the
        latest checkpoint, or step 0 with a fresh init from a generator
        seeded with ``seed`` when none exists."""
        if self.latest_step is not None:
            params, opt_state = self.restore()
            return self.latest_step, params, opt_state
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_full_params(gen, self.cfg, self.device,
                                  quantize=_quantized(self.cfg))
        return 0, params, self.optimizer(_optimizer_leaves(params))

    def close(self) -> None:
        """API parity with the reference's manager, whose orbax saves run
        in the background; every save here is synchronous, so there is
        nothing to wait for or release."""
