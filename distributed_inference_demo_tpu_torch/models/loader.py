"""Weight loading from HF safetensors checkpoints into ``StageParams``.

Counterpart of ``distributed_inference_demo_tpu/models/loader.py``:
safetensors names map straight onto the stacked layer layout, cast to the
config's dtype and, for an ``-int8`` / ``-int4`` config, quantized
(``ops.quant.maybe_quantize``).  ``load_or_init`` is where a checkpoint
directory or a seed becomes parameters.

The safetensors format is read here, without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header (its
``__metadata__`` entry skipped) naming each tensor's dtype, shape and
``data_offsets`` counted from the end of the header, then the data.

``stage_params_to_bytes`` / ``stage_params_from_bytes`` are the control
plane's stage blobs, byte-equal to the JAX package's.
``load_vision_params`` reads a CLIP / LLaVA vision tower (and LLaVA's
projector) into ``models/vision.py``'s tree.  :func:`write_safetensors`
writes the format (the port's own checkpoints, ``checkpoint.py``);
``load_or_init`` reads those and refuses the JAX package's orbax
checkpoint directories.
"""

import json
import os
import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .base import ModelConfig, StageParams
from .decoder import init_full_params

ORBAX_META = "framework_meta.json"

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}

# safetensors name -> (our key, transpose?); attention/norm subset is
# shared by every rope-family mapper (llama's dense MLP adds mlp.*)
_ATTN_NORM_MAP = {
    "input_layernorm.weight": ("attn_norm_w", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm_w", False),
}

_LLAMA_LAYER_MAP = {
    **_ATTN_NORM_MAP,
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def read_safetensors(path: str, key_filter: Optional[Callable] = None,
                     with_metadata: bool = False):
    """The tensors of one ``.safetensors`` file as CPU tensors (views of
    one buffer holding the file's data); with ``with_metadata``, also
    the header's ``__metadata__`` (``{}`` if it has none)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        metadata = header.pop("__metadata__", None) or {}
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - hlen)
        f.readinto(data)
    buf = torch.frombuffer(data, dtype=torch.uint8) if data else None
    out = {}
    for name, info in header.items():
        if key_filter is not None and not key_filter(name):
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        start, end = info["data_offsets"]
        raw = (buf[start:end] if end > start
               else torch.empty(0, dtype=torch.uint8))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if start % itemsize:
            raw = raw.clone()       # a view must start on an element
        out[name] = raw.view(dtype).reshape(info["shape"])
    return (out, metadata) if with_metadata else out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; bf16 as BF16) as one safetensors
    file in :func:`read_safetensors`' layout, the header padded with
    spaces to 8 bytes, ``metadata`` (strings) as its ``__metadata__``.
    The file is written aside and renamed into place, so a crash leaves
    no half file at ``path``.  One tensor at a time passes through host
    memory."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [off, off + size]}
        off += size
    hb = json.dumps(header).encode("utf-8")
    hb += b" " * (-len(hb) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in tensors.values():
            flat = t.detach().contiguous().reshape(-1).cpu()
            f.write(memoryview(flat.view(torch.uint8).numpy()))
    os.replace(tmp, path)


def load_safetensors_dir(path: str, key_filter: Optional[Callable] = None
                         ) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file (shard) of a checkpoint directory, in
    name order; with ``key_filter`` only the matching tensors."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname),
                                        key_filter))
    return tensors


def _as_tensor(v) -> torch.Tensor:
    """A state-dict leaf (torch tensor or numpy array, bf16 numpy as its
    uint16 bit pattern) as a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _get(raw: dict, name: str,
         prefixes=("model.", "transformer.", "")) -> torch.Tensor:
    for prefix in prefixes:
        if prefix + name in raw:
            return _as_tensor(raw[prefix + name])
    raise KeyError(name)


def _cast(t: torch.Tensor, dt, device) -> torch.Tensor:
    """To ``device`` and the config's dtype (round to nearest even, as the
    reference's ``jnp.asarray(..., dt)``)."""
    return t.to(device).to(dt).contiguous()


def _stack(layers: Dict[str, list], dt, device) -> dict:
    return {k: _cast(torch.stack(v), dt, device) for k, v in layers.items()}


def llama_params_from_state_dict(raw: dict, cfg: ModelConfig,
                                 device=None) -> StageParams:
    """Map a llama-family HF state dict (``model.layers.{i}.*`` names) onto
    the stacked layout.  HF stores linears as [out, in]; ours are [in, out]
    einsum operands, hence the transposes.  Also serves qwen2 (identical
    names + ``self_attn.{q,k,v}_proj.bias`` under ``attn_qkv_bias``)."""
    device = resolve_device(device)
    dt = cfg.dtype
    layer_map = dict(_LLAMA_LAYER_MAP)
    if cfg.attn_qkv_bias:
        layer_map.update({
            "self_attn.q_proj.bias": ("bq", False),
            "self_attn.k_proj.bias": ("bk", False),
            "self_attn.v_proj.bias": ("bv", False)})
    layers: Dict[str, list] = {}
    for i in range(cfg.num_layers):
        for hf_name, (ours, transpose) in layer_map.items():
            w = _get(raw, f"layers.{i}.{hf_name}")
            layers.setdefault(ours, []).append(w.T if transpose else w)
    return _with_llama_ends(raw, cfg, _stack(layers, dt, device), device)


def _with_llama_ends(raw: dict, cfg: ModelConfig, layers: dict,
                     device) -> StageParams:
    """``layers`` with the llama-named embedding, final norm and (untied)
    LM head, shared by the llama-family and mixtral mappers."""
    dt = cfg.dtype
    embed = {"tokens": _cast(_get(raw, "embed_tokens.weight"), dt, device)}
    final_norm = {"w": _cast(_get(raw, "norm.weight"), dt, device)}
    if cfg.tie_embeddings:
        lm_head = {}
    else:
        lm_head = {"w": _cast(_get(raw, "lm_head.weight", ("",)).T, dt,
                              device)}
    return StageParams(layers=layers, embed=embed, final_norm=final_norm,
                       lm_head=lm_head)


def bloom_params_from_state_dict(raw: dict, cfg: ModelConfig,
                                 device=None) -> StageParams:
    """Map a BloomForCausalLM state dict onto the stacked layout.

    The fused ``query_key_value`` weight is per-head interleaved:
    [nh, 3, hd, H] after reshape (q/k/v planes alternate within each
    head), not three contiguous blocks."""
    device = resolve_device(device)
    dt = cfg.dtype
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    layers: Dict[str, list] = {}

    def push(key, val):
        layers.setdefault(key, []).append(val)

    for i in range(cfg.num_layers):
        p = f"h.{i}."
        push("attn_norm_w", _get(raw, p + "input_layernorm.weight"))
        push("attn_norm_b", _get(raw, p + "input_layernorm.bias"))
        qkv_w = _get(raw, p + "self_attention.query_key_value.weight")
        qkv_b = _get(raw, p + "self_attention.query_key_value.bias")
        w = qkv_w.reshape(nh, 3, hd, H)
        b = qkv_b.reshape(nh, 3, hd)
        # [H, nh*hd] per projection (transpose of HF's [out, in])
        push("wq", w[:, 0].reshape(nh * hd, H).T)
        push("wk", w[:, 1].reshape(nh * hd, H).T)
        push("wv", w[:, 2].reshape(nh * hd, H).T)
        push("bq", b[:, 0].reshape(nh * hd))
        push("bk", b[:, 1].reshape(nh * hd))
        push("bv", b[:, 2].reshape(nh * hd))
        push("wo", _get(raw, p + "self_attention.dense.weight").T)
        push("bo", _get(raw, p + "self_attention.dense.bias"))
        push("mlp_norm_w", _get(raw, p + "post_attention_layernorm.weight"))
        push("mlp_norm_b", _get(raw, p + "post_attention_layernorm.bias"))
        push("w_up", _get(raw, p + "mlp.dense_h_to_4h.weight").T)
        push("b_up", _get(raw, p + "mlp.dense_h_to_4h.bias"))
        push("w_down", _get(raw, p + "mlp.dense_4h_to_h.weight").T)
        push("b_down", _get(raw, p + "mlp.dense_4h_to_h.bias"))
    stacked = _stack(layers, dt, device)

    embed = {
        "tokens": _cast(_get(raw, "word_embeddings.weight"), dt, device),
        "norm_w": _cast(_get(raw, "word_embeddings_layernorm.weight"), dt,
                        device),
        "norm_b": _cast(_get(raw, "word_embeddings_layernorm.bias"), dt,
                        device),
    }
    final_norm = {"w": _cast(_get(raw, "ln_f.weight"), dt, device),
                  "b": _cast(_get(raw, "ln_f.bias"), dt, device)}
    return StageParams(layers=stacked, embed=embed, final_norm=final_norm,
                       lm_head={})  # bloom ties the head to the embedding


# mixtral's per-expert linears -> our [L, E, in, out] expert stacks
_MIXTRAL_EXPERT_MAP = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


def mixtral_params_from_state_dict(raw: dict, cfg: ModelConfig,
                                   device=None) -> StageParams:
    """Map a MixtralForCausalLM state dict onto the stacked layout: the
    llama attention and norm names, ``block_sparse_moe.gate`` -> router
    [H, E], and the per-expert linears
    (``block_sparse_moe.experts.{e}.w1/w3/w2``) stacked over e into
    w_gate, w_up and w_down, then over layers."""
    device = resolve_device(device)
    layers: Dict[str, list] = {}

    def push(key, val):
        layers.setdefault(key, []).append(val)

    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        for hf_name, (ours, transpose) in _ATTN_NORM_MAP.items():
            w = _get(raw, p + hf_name)
            push(ours, w.T if transpose else w)
        moe = p + "block_sparse_moe."
        push("router", _get(raw, moe + "gate.weight").T)
        for hf_name, ours in _MIXTRAL_EXPERT_MAP.items():
            push(ours, torch.stack([
                _get(raw, f"{moe}experts.{e}.{hf_name}.weight").T
                for e in range(cfg.num_experts)]))
    return _with_llama_ends(raw, cfg, _stack(layers, cfg.dtype, device),
                            device)


def gemma_params_from_state_dict(raw: dict, cfg: ModelConfig,
                                 device=None) -> StageParams:
    """Gemma: llama names end to end, but every RMSNorm applies
    ``(1 + w)``: the +1 is folded into the stored weights here, in f32,
    and the folded vectors stay f32 (a bf16 re-round of the sum would
    lose mantissa bits HF keeps)."""
    p = llama_params_from_state_dict(raw, cfg, device)
    layers = dict(p.layers)
    for key in ("attn_norm_w", "mlp_norm_w"):
        layers[key] = layers[key].float() + 1.0
    final_norm = dict(p.final_norm)
    final_norm["w"] = final_norm["w"].float() + 1.0
    return StageParams(layers=layers, embed=p.embed,
                       final_norm=final_norm, lm_head=p.lm_head)


_SD_MAPPERS = {
    "llama": llama_params_from_state_dict,
    "qwen2": llama_params_from_state_dict,   # same names + qkv biases
    "gemma": gemma_params_from_state_dict,
    "bloom": bloom_params_from_state_dict,
    "mixtral": mixtral_params_from_state_dict,
}


def params_from_state_dict(raw: dict, cfg: ModelConfig,
                           device=None) -> StageParams:
    """Family dispatch for HF-layout state dicts (torch or numpy leaves),
    to float ``StageParams`` on ``device`` (CUDA unless the CPU is asked
    for)."""
    if cfg.family not in _SD_MAPPERS:
        raise NotImplementedError(f"no state-dict mapper for {cfg.family!r}")
    return _SD_MAPPERS[cfg.family](raw, cfg, device)


def stage_params_to_bytes(params: StageParams) -> bytes:
    """Serialize a StageParams tree for the control plane's artifact
    channel.  Layout, as the JAX package's:
    ``<u32 manifest_len><manifest JSON><wire tensor message>``, the names
    sorted, a bf16 leaf under wire dtype code 3.  Quantized leaves are
    refused: the consumer quantizes its own slice."""
    from ..comm import wire
    from ..ops.quant import QuantizedArray, QuantizedArray4
    from ..runtime.disagg import _to_wire

    flat = {}
    for section in ("layers", "embed", "final_norm", "lm_head"):
        d = getattr(params, section)
        if d is None:
            continue
        for k, v in d.items():
            if isinstance(v, (QuantizedArray, QuantizedArray4)):
                # ship weights pre-quantization; the receiving stage applies
                # its own config's quantization (ops/quant.maybe_quantize)
                raise TypeError(
                    f"{section}/{k} is quantized; serialize the float "
                    "params and quantize at the consumer")
            flat[f"{section}/{k}"] = _to_wire(v)
    names = sorted(flat)
    manifest = json.dumps({"names": names,
                           "present": {
                               s: getattr(params, s) is not None
                               for s in ("embed", "final_norm", "lm_head")}
                           }).encode("utf-8")
    # one copy of the weights' bytes: the message's parts, joined once
    return b"".join([struct.pack("<I", len(manifest)), manifest,
                     *wire.serialize_tensor_parts([flat[n] for n in names])])


def stage_params_from_bytes(data: bytes, device=None) -> StageParams:
    """Inverse of :func:`stage_params_to_bytes`: the tree on ``device``
    (CUDA unless the CPU is asked for)."""
    from ..comm import wire
    from ..runtime.disagg import _from_wire

    device = resolve_device(device)
    (mlen,) = struct.unpack_from("<I", data, 0)
    manifest = json.loads(bytes(data[4:4 + mlen]).decode("utf-8"))
    tensors = wire.deserialize_tensors(
        memoryview(data)[4 + mlen:]).tensors
    sections: Dict[str, dict] = {"layers": {}, "embed": {},
                                 "final_norm": {}, "lm_head": {}}
    for name, arr in zip(manifest["names"], tensors):
        sec, _, key = name.partition("/")
        # the decoder's arrays own their memory: no second copy
        sections[sec][key] = _from_wire(arr).to(device)
    present = manifest["present"]
    return StageParams(
        layers=sections["layers"],
        embed=sections["embed"] if present["embed"] else None,
        final_norm=sections["final_norm"] if present["final_norm"] else None,
        lm_head=sections["lm_head"] if present["lm_head"] else None)


def load_or_init(model_name: str, cfg: ModelConfig,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 quantize: bool = True, device=None) -> StageParams:
    """Load from a local checkpoint directory if one is given and exists,
    else random-init from ``seed`` (as the reference does).

    A checkpoint is mapped to the float tree and then quantized for an
    ``-int8`` / ``-int4`` config; the random path quantizes during init,
    one layer at a time, so peak memory stays near the quantized
    footprint.  ``quantize=False`` returns the float tree for any config.
    The port's own checkpoints (``checkpoint.save_params``: a
    ``framework_meta.json`` sidecar beside ``params.safetensors``) load
    as saved, already quantized, their identity checked against
    ``model_name`` and ``cfg``.  The JAX package's orbax directories (the
    sidecar without the port's file) are refused: that format is JAX's."""
    from ..checkpoint import PARAMS_FILE, load_params
    from ..ops.quant import maybe_quantize

    device = resolve_device(device)
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        if os.path.exists(os.path.join(checkpoint_dir, ORBAX_META)):
            if os.path.exists(os.path.join(checkpoint_dir, PARAMS_FILE)):
                params, _ = load_params(checkpoint_dir, cfg,
                                        model_name=model_name, device=device)
                return params
            raise ValueError(
                f"{checkpoint_dir} holds {ORBAX_META}: an orbax checkpoint "
                "of the JAX package, which this port does not read; point "
                "--checkpoint at an HF safetensors directory or at a "
                "checkpoint this port saved")
        params = params_from_state_dict(load_safetensors_dir(checkpoint_dir),
                                        cfg, device)
        return maybe_quantize(params, cfg) if quantize else params
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_full_params(
        gen, cfg, device,
        quantize=quantize and cfg.quantization in ("int8", "int4"))


# ---------------------------------------------------------------------------
# vision tower (CLIP-ViT / LLaVA checkpoints)

_CLIP_LAYER_MAP = {
    "layer_norm1.weight": ("norm1_w", False),
    "layer_norm1.bias": ("norm1_b", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.out_proj.weight": ("wo", True),
    "self_attn.out_proj.bias": ("bo", False),
    "layer_norm2.weight": ("norm2_w", False),
    "layer_norm2.bias": ("norm2_b", False),
    "mlp.fc1.weight": ("w_up", True),
    "mlp.fc1.bias": ("b_up", False),
    "mlp.fc2.weight": ("w_down", True),
    "mlp.fc2.bias": ("b_down", False),
}

_PROJECTOR_MAP = (("multi_modal_projector.linear_1.weight", "proj_w1", True),
                  ("multi_modal_projector.linear_1.bias", "proj_b1", False),
                  ("multi_modal_projector.linear_2.weight", "proj_w2", True),
                  ("multi_modal_projector.linear_2.bias", "proj_b2", False))


def vision_params_from_clip_state_dict(raw: dict, vcfg, decoder_hidden: int,
                                       seed: int = 0, device=None) -> dict:
    """Map an HF CLIP vision tower (``vision_model.*`` names: standalone
    ``CLIPVisionModel`` exports and LLaVA bundles alike) onto the stacked
    ``models/vision.py`` layout on ``device``.  Requires
    ``vcfg.clip_arch``.  LLaVA's ``multi_modal_projector`` weights are
    mapped when present; otherwise the projector stays initialized from
    ``seed`` (a plain CLIP export has no projector into the decoder's
    space).

    HF stores linears as [out, in]; ours are [in, out] operands, hence
    the transposes.  The patch "conv" [H, C, p, p] flattens to the
    patchify order (row in patch, column in patch, channel)."""
    from .vision import init_vision_params

    if not vcfg.clip_arch:
        raise ValueError(
            "CLIP checkpoints need VisionConfig(clip_arch=True) — the "
            "plain tower has no class token / pre-layernorm to load into")
    device = resolve_device(device)
    dt = vcfg.dtype

    def get(name):
        return _get(raw, name, prefixes=(
            "vision_model.",                         # CLIPVisionModel
            "vision_tower.vision_model.",            # LLaVA bundles
            "model.vision_tower.vision_model.", ""))

    layers: Dict[str, list] = {}
    for i in range(vcfg.num_layers):
        for hf_name, (ours, transpose) in _CLIP_LAYER_MAP.items():
            w = get(f"encoder.layers.{i}.{hf_name}")
            layers.setdefault(ours, []).append(w.T if transpose else w)
    p_ = vcfg.patch_size
    patch = get("embeddings.patch_embedding.weight")     # [H, C, p, p]
    patch = patch.permute(2, 3, 1, 0).reshape(p_ * p_ * vcfg.channels,
                                              vcfg.hidden_size)
    # the projector from the seed, as the fallback; checkpoint weights
    # overwrite it
    out = init_vision_params(torch.Generator(device=device).manual_seed(seed),
                             vcfg, decoder_hidden, device)
    out.update({
        "patch_embed": _cast(patch, dt, device),
        "pos_embed": _cast(get("embeddings.position_embedding.weight"), dt,
                           device),
        "cls_embed": _cast(get("embeddings.class_embedding").reshape(-1),
                           dt, device),
        "pre_norm_w": _cast(get("pre_layrnorm.weight"), dt, device),
        "pre_norm_b": _cast(get("pre_layrnorm.bias"), dt, device),
        "post_norm_w": _cast(get("post_layernorm.weight"), dt, device),
        "post_norm_b": _cast(get("post_layernorm.bias"), dt, device),
        "layers": _stack(layers, dt, device),
    })
    for hf_name, ours, transpose in _PROJECTOR_MAP:
        for prefix in ("", "model."):
            if prefix + hf_name in raw:
                w = _as_tensor(raw[prefix + hf_name])
                out[ours] = _cast(w.T if transpose else w, dt, device)
                break
    if out["pos_embed"].shape[0] != vcfg.num_positions:
        raise ValueError(
            f"checkpoint position table has {out['pos_embed'].shape[0]} "
            f"rows; VisionConfig expects {vcfg.num_positions} "
            f"(image {vcfg.image_size} / patch {vcfg.patch_size} + cls)")
    # a projector sized for another decoder fails here, with the shapes
    # spelled out, not as a matmul error on the first request
    want1 = (vcfg.hidden_size, decoder_hidden)
    want2 = (decoder_hidden, decoder_hidden)
    got1, got2 = tuple(out["proj_w1"].shape), tuple(out["proj_w2"].shape)
    if got1 != want1 or got2 != want2:
        raise ValueError(
            f"checkpoint projector maps {got1} -> {got2}; this "
            f"tower/decoder pairing needs {want1} -> {want2} (decoder "
            f"hidden {decoder_hidden})")
    return out


_VISION_KEY_PREFIXES = ("vision_model.", "vision_tower.",
                        "model.vision_tower.", "multi_modal_projector.",
                        "model.multi_modal_projector.")


def load_vision_params(path: str, vcfg, decoder_hidden: int, seed: int = 0,
                       device=None) -> dict:
    """CLIP / LLaVA vision weights from a safetensors checkpoint
    directory.  Only the tower's and projector's tensors are read out of
    the files, so a full LLaVA bundle's language model is never copied
    to extract the tower."""
    tensors = load_safetensors_dir(
        path, key_filter=lambda k: k.startswith(_VISION_KEY_PREFIXES))
    return vision_params_from_clip_state_dict(tensors, vcfg, decoder_hidden,
                                              seed=seed, device=device)
