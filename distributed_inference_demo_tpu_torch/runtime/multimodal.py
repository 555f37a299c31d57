"""LLaVA-style multimodal inference: a vision prefix, then text decode.

Counterpart of ``distributed_inference_demo_tpu/runtime/multimodal.py``
(BASELINE config #5: a vision encoder on an edge client, the decoder
shard on the accelerator).  Three pieces:

- :class:`MultimodalEngine`: the ViT + projector (``models/vision.py``)
  encodes the image, the projected patches are prepended to the token
  embeddings, and the wrapped ``InferenceEngine`` prefills the whole
  prefix in one forward through its own attention (the flash kernel on
  the card) into its static decode state, then decodes with its own
  decode loop (the captured CUDA graph on the card);
- :class:`VisionWorker`: the edge client, a transport node that answers
  ``img:{rid}`` (images) with ``imgh:{rid}`` (projected patch hidden
  states); it holds no decoder weights;
- :class:`MultimodalHeader`: a ``PipelineHeader`` whose stage-0 prefill
  input is the pre-embedded prefix (the vision worker's patches and the
  local token embeddings); the stages after it see ``[b, s, H]`` hidden
  rows as always, so the ring is unchanged.

:class:`MultimodalBackend` puts the engine behind ``InferenceHTTPServer``
(``serve --vision``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..comm import wire
from ..comm.transport import BaseTransport, TransportTimeout
from ..models.base import ModelConfig, StageParams
from ..models.decoder import embed_tokens
from ..models.vision import VisionConfig, vision_forward
from ..ops.sampling import SamplingParams
from .disagg import _from_wire, _to_wire
from .distributed import DEFAULT_STEP_TIMEOUT, PipelineHeader, _Request
from .engine import GenerationResult, InferenceEngine

log = logging.getLogger(__name__)


def make_multimodal_encode(cfg: ModelConfig, vcfg: VisionConfig):
    """``(vparams, dec_params, images, text_ids) -> [b, n_img + s, H]``:
    the LLaVA input recipe, projected patches prepended to the text's
    embeddings, in the decoder's dtype on the weights' device."""

    def encode(vparams, dec_params, images, text_ids):
        img_h = vision_forward(vparams, vcfg, images).to(cfg.dtype)
        ids = text_ids.to(img_h.device, torch.int64)
        tok = embed_tokens(dec_params, cfg, ids)
        return torch.cat([img_h, tok], dim=1)

    return encode


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


class MultimodalEngine:
    """Single-process image + text generation (the parity reference of the
    distributed composition below).  ``device`` and ``cuda_graph`` are the
    wrapped ``InferenceEngine``'s; ``vparams`` live on the same device."""

    def __init__(self, cfg: ModelConfig, params: StageParams,
                 vcfg: VisionConfig, vparams: dict,
                 max_seq: Optional[int] = None,
                 sampling: SamplingParams = SamplingParams(),
                 eos_id: Optional[int] = None,
                 attn_backend: str = "auto",
                 kv_layout: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 device=None, cuda_graph: bool = True):
        self.engine = InferenceEngine(cfg, params, max_seq, sampling,
                                      eos_id, attn_backend,
                                      kv_layout=kv_layout,
                                      kv_dtype=kv_dtype, device=device,
                                      cuda_graph=cuda_graph)
        v_dev = vparams["patch_embed"].device
        if v_dev.type != self.engine.device.type:
            raise ValueError(f"vision params live on {v_dev}, the engine "
                             f"on {self.engine.device}")
        self.cfg = cfg
        self.vcfg = vcfg
        self.vparams = vparams
        self._encode = make_multimodal_encode(cfg, vcfg)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def encode(self, images, text_ids) -> torch.Tensor:
        """``images`` [b, H, W, C], ``text_ids`` [b, s] -> the prefix
        embeddings [b, n_img + s, H] on the engine's device."""
        dev = self.engine.device
        with torch.no_grad():
            return self._encode(self.vparams, self.engine.params,
                                _as_tensor(images, dev, torch.float32),
                                _as_tensor(text_ids, dev, torch.int64))

    def prefill_logits(self, images, text_ids) -> np.ndarray:
        """Last-position logits [b, vocab] (f32) of the multimodal
        prefix."""
        return self.engine.prefill_embeds_logits(
            self.encode(images, text_ids))

    def generate(self, images, text_ids, max_new_tokens: int,
                 seed: int = 0) -> GenerationResult:
        """``images``: [b, H, W, C]; ``text_ids``: [b, s] int32.
        ``seconds`` covers the tower, the prefill and the decode."""
        t0 = time.perf_counter()
        with torch.no_grad():
            res = self.engine.generate_embeds(
                self.encode(images, text_ids), max_new_tokens, seed=seed)
        res.seconds = time.perf_counter() - t0
        return res


class MultimodalBackend:
    """``serve --vision``: :class:`MultimodalEngine` behind
    ``InferenceHTTPServer``.

    ``POST /generate`` takes an optional ``image`` field, nested JSON
    floats shaped [H][W][C] (one image for a prompt batch of 1) or
    [b][H][W][C], prepended to the prompt as projected patches.
    Requests without an image run the wrapped text engine unchanged, so
    one server serves both.  Shape and batch mismatches are ValueErrors
    (HTTP 400, the tower's geometry spelled out)."""

    def __init__(self, engine: MultimodalEngine):
        self.mm = engine
        self._counts_lock = threading.Lock()
        self._served = {"text": 0, "image": 0}

    @property
    def max_seq(self) -> int:
        return self.mm.engine.max_seq

    @property
    def device(self) -> torch.device:
        return self.mm.device

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 seed: int = 0, image=None,
                 logprobs: bool = False) -> GenerationResult:
        ids = np.asarray(prompt_ids, np.int32)
        if image is None:
            # text-only requests run the wrapped engine's whole surface
            # (logprobs included) unchanged
            with self._counts_lock:
                self._served["text"] += 1
            return self.mm.engine.generate(ids, max_new_tokens, seed=seed,
                                           logprobs=logprobs)
        if logprobs:
            raise ValueError(
                "logprobs is not supported with image input")
        images = np.asarray(image, np.float32)
        if images.ndim == 3:
            images = images[None]
        vcfg = self.mm.vcfg
        want = (vcfg.image_size, vcfg.image_size, vcfg.channels)
        if images.ndim != 4 or images.shape[1:] != want:
            raise ValueError(
                f"image must be [H][W][C] or [b][H][W][C] with shape "
                f"{want} for this tower, got {images.shape}")
        if images.shape[0] != ids.shape[0]:
            raise ValueError(
                f"image batch {images.shape[0]} != prompt batch "
                f"{ids.shape[0]}")
        with self._counts_lock:
            self._served["image"] += 1
        return self.mm.generate(images, ids, max_new_tokens, seed=seed)

    def generate_stream(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        seed: int = 0, logprobs: bool = False):
        """Text-only streaming delegates to the wrapped engine (image +
        stream is refused at the HTTP layer)."""
        with self._counts_lock:
            self._served["text"] += 1
        return self.mm.engine.generate_stream(
            np.asarray(prompt_ids, np.int32), max_new_tokens, seed=seed,
            logprobs=logprobs)

    def classify(self, prompt_ids: np.ndarray, label_token_ids):
        return self.mm.engine.classify(np.asarray(prompt_ids, np.int32),
                                       label_token_ids)

    def stats(self) -> dict:
        vcfg = self.mm.vcfg
        with self._counts_lock:
            served = dict(self._served)
        return {
            "mode": "multimodal",
            "image_size": vcfg.image_size,
            "patches_per_image": vcfg.num_patches,
            "vit_layers": vcfg.num_layers,
            "requests_text": served["text"],
            "requests_image": served["image"],
        }

    def reset_stats(self) -> None:
        with self._counts_lock:
            self._served = {"text": 0, "image": 0}


class VisionWorker:
    """The edge-client vision stage: holds only the ViT + projector
    weights (on their device) and answers ``img:{rid}`` with
    ``imgh:{rid}`` over the transport.  ``images`` counts the images
    encoded."""

    def __init__(self, vparams: dict, vcfg: VisionConfig,
                 transport: BaseTransport, header_id: str,
                 step_timeout: float = DEFAULT_STEP_TIMEOUT):
        self.vparams = vparams
        self.vcfg = vcfg
        self.transport = transport
        self.header_id = header_id
        self.step_timeout = step_timeout
        self.device = vparams["patch_embed"].device
        self.images = 0

    def encode(self, images) -> np.ndarray:
        """[b, H, W, C] images -> the projected patches as the wire's
        array (bf16 as its marked bits)."""
        with torch.no_grad():
            hidden = vision_forward(
                self.vparams, self.vcfg,
                _as_tensor(images, self.device, torch.float32))
        self.images += hidden.shape[0]
        return _to_wire(hidden)

    def serve_forever(self, idle_timeout: Optional[float] = None) -> None:
        while True:
            try:
                tag, payload = self.transport.recv_any(
                    timeout=idle_timeout or self.step_timeout)
            except TransportTimeout:
                log.info("vision worker %s: idle timeout, exiting",
                         self.transport.device_id)
                return
            kind, _, rest = tag.partition(":")
            if kind == "stop":
                return
            if kind != "img":
                log.warning("vision worker: unexpected tag %r", tag)
                continue
            [images] = wire.deserialize_tensors(payload).tensors
            self.transport.send(self.header_id, f"imgh:{rest}",
                                wire.serialize_tensors([self.encode(
                                    images)]))


class MultimodalHeader(PipelineHeader):
    """A ``PipelineHeader`` whose requests may carry an image: the prefill
    chunk becomes (the vision worker's patches ++ the local token
    embeddings); everything after stage 0 (ring hops, tail sampling, the
    stages' page pools) is untouched."""

    def __init__(self, runtime, transport: BaseTransport, next_id: str,
                 vision_id: str, eos_id: Optional[int] = None,
                 step_timeout: float = DEFAULT_STEP_TIMEOUT):
        super().__init__(runtime, transport, next_id, eos_id, step_timeout)
        self.vision_id = vision_id
        self._mm_prefix: Dict[int, torch.Tensor] = {}

    def _prefill_array(self, req: _Request):
        prefix = self._mm_prefix.pop(req.rid, None)
        if prefix is None:
            return req.prompt.astype(np.int32)
        return prefix

    def _encode_image(self, images: np.ndarray) -> np.ndarray:
        """Round trip to the vision node (the edge client)."""
        self.transport.send(self.vision_id, "img:0",
                            wire.serialize_tensors(
                                [np.asarray(images, np.float32)]))
        deadline = time.monotonic() + self.step_timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TransportTimeout("vision worker did not answer")
            tag, payload = self.transport.recv_any(timeout=left)
            if tag.startswith("imgh:"):
                [hidden] = wire.deserialize_tensors(payload).tensors
                return hidden
            log.warning("header: unexpected tag %r awaiting vision", tag)

    def generate_mm(self, images: np.ndarray, text_ids: np.ndarray,
                    max_new_tokens: int, on_token=None) -> np.ndarray:
        """Image + text generation over the pipeline; returns [b, new].
        ``on_token`` streams steps as ``generate_many``'s does."""
        rt = self.rt
        img_h = _from_wire(self._encode_image(images))
        with torch.no_grad():
            tok = embed_tokens(rt.params, rt.cfg, _as_tensor(
                text_ids, rt.device, torch.int64))
            prefix = torch.cat([img_h.to(rt.device, tok.dtype), tok], dim=1)
        # the capacity check sees the combined length through placeholder
        # ids; the stage-0 prefill input is the stashed float prefix
        placeholder = np.zeros(tuple(prefix.shape[:2]), np.int32)
        rid = self._next_rid
        self._mm_prefix[rid] = prefix
        try:
            return self.generate_many([placeholder], max_new_tokens,
                                      on_token=on_token)[0]
        finally:
            # if validation raised before _launch took the stash, a later
            # request would inherit this rid and prefill with the wrong
            # content: always drop it
            self._mm_prefix.pop(rid, None)
