"""Ulysses-style all-to-all sequence parallelism over the ``sp`` axis.

Counterpart of ``distributed_inference_demo_tpu/parallel/ulysses.py``.
Activations and the QKV/MLP projections stay sequence-sharded, and
attention runs head-sharded over the full sequence after one all-to-all
each way per layer (DeepSpeed-Ulysses):

- prefill: q/k/v ``[b, s/n, heads, hd]`` -> all-to-all (split heads,
  concatenate the sequence) -> ``[b, s, heads/n, hd]``; causal attention
  per head block through the port's flash entry point
  (``ops.flash_attention``: the CUDA kernel on the card, its plain
  version on the CPU; plain attention over a float8 cache); the reverse
  all-to-all on the output;
- the cache shards by head (``[L, b, nkv/n, max_seq, hd]``);
- decode: the replicated token needs no sequence all-to-all; each rank
  attends its head block over its cache shard and the head outputs are
  all-gathered, one collective per layer a step.

Needs ``num_heads % sp == 0`` and ``num_kv_heads % sp == 0``.  The
programs run on every rank of the mesh (``parallel/sequence.py``).
"""

from typing import Optional

import torch

from ..models.base import KVCache, ModelConfig, StageSpec
from ..models.decoder import stage_forward
from ..ops.attention import attention, update_kv_cache
from ..ops.flash_attention import flash_attention
from ..ops.sampling import SamplingParams, sample_logits
from .sequence import (StreamFns, _make_generate_fn, _sample_first_token)


def _check_heads(cfg: ModelConfig, sp: int) -> None:
    if cfg.num_heads % sp or cfg.num_kv_heads % sp:
        raise ValueError(
            f"ulysses needs num_heads ({cfg.num_heads}) and num_kv_heads "
            f"({cfg.num_kv_heads}) divisible by sp={sp}")


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[b, chunk, h, hd] sequence-sharded -> [b, n*chunk, h/n, hd]
    head-sharded (rank order is sequence order)."""
    n = group.size
    b, c, h, hd = x.shape
    blocks = x.reshape(b, c, n, h // n, hd).permute(2, 0, 1, 3, 4)
    got = group.all_to_all(blocks.contiguous())      # [n, b, c, h/n, hd]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * c, h // n, hd)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`: [b, n*chunk, h/n, hd] ->
    [b, chunk, h, hd]."""
    n = group.size
    b, S, hl, hd = x.shape
    c = S // n
    blocks = x.reshape(b, n, c, hl, hd).permute(1, 0, 2, 3, 4)
    got = group.all_to_all(blocks.contiguous())      # [n, b, c, h/n, hd]
    return got.permute(1, 2, 0, 3, 4).reshape(b, c, n * hl, hd)


class UlyssesCore:
    """The Ulysses math on one rank (the reference's
    ``_make_ulysses_cores``), with :class:`~.sequence.RingCore`'s
    interface."""

    def __init__(self, cfg: ModelConfig, max_seq: int, sp: int,
                 sampling: SamplingParams, kv_dtype):
        _check_heads(cfg, sp)
        self.cfg, self.max_seq, self.sampling = cfg, max_seq, sampling
        self.kv_dtype = kv_dtype
        self.nh_loc = cfg.num_heads // sp
        self.nkv_loc = cfg.num_kv_heads // sp
        self.spec = StageSpec(0, 1, 0, cfg.num_layers)

    def _slopes(self, slopes, idx):
        if slopes is None:
            return None
        return slopes[idx * self.nh_loc:(idx + 1) * self.nh_loc]

    def prefill(self, mesh, params, ids, gen) -> dict:
        cfg = self.cfg
        group = mesh.group("sp")
        n, idx = group.size, group.rank
        b, S = ids.shape
        chunk = S // n
        dev = mesh.device
        plain = self.kv_dtype is not None   # the kernel reads no float8

        def prefill_attn(q, k, v, kc, vc, pos, cache_start, slopes):
            qf = _seq_to_heads(q, group)
            kf = _seq_to_heads(k, group)
            vf = _seq_to_heads(v, group)
            update_kv_cache(kc, vc, kf, vf, cache_start)
            sl = self._slopes(slopes, idx)
            if plain:
                qpos = (int(cache_start)
                        + torch.arange(S, device=dev)).expand(b, S)
                out = attention(qf, kc, vc, qpos, int(cache_start) + S, sl)
            else:
                out = flash_attention(qf.contiguous(), kc, vc,
                                      int(cache_start),
                                      int(cache_start) + S, sl)
            return _heads_to_seq(out, group), kc, vc

        shape = (cfg.num_layers, b, self.nkv_loc, self.max_seq,
                 cfg.head_dim)
        cache_dtype = self.kv_dtype or cfg.dtype
        keys = torch.zeros(shape, dtype=cache_dtype, device=dev)
        values = torch.zeros(shape, dtype=cache_dtype, device=dev)
        positions = (idx * chunk
                     + torch.arange(chunk, device=dev)).expand(b, chunk)
        body_spec = StageSpec(0, 2, 0, cfg.num_layers)
        hidden, _ = stage_forward(params, cfg, body_spec,
                                  ids[:, idx * chunk:(idx + 1) * chunk],
                                  KVCache(keys, values, 0), positions,
                                  attn_impl=prefill_attn)
        tok = _sample_first_token(params, cfg, hidden, group, gen,
                                  self.sampling)
        return {"keys": keys, "values": values, "length": S, "tok": tok,
                "gen": gen}

    def step(self, mesh, params, st: dict) -> torch.Tensor:
        group = mesh.group("sp")
        idx = group.rank
        length, tok = st["length"], st["tok"]
        b = tok.shape[0]
        nh, nkv = self.nh_loc, self.nkv_loc

        def dec_attn(q, k, v, kc, vc, pos_, cache_start, slopes):
            q_loc = q[:, :, idx * nh:(idx + 1) * nh]
            k_loc = k[:, :, idx * nkv:(idx + 1) * nkv]
            v_loc = v[:, :, idx * nkv:(idx + 1) * nkv]
            update_kv_cache(kc, vc, k_loc, v_loc, cache_start)
            out = attention(q_loc, kc, vc, pos_, int(cache_start) + 1,
                            self._slopes(slopes, idx))
            return group.all_gather(out.contiguous(), dim=2), kc, vc

        pos = torch.full((b, 1), length, dtype=torch.int64,
                         device=tok.device)
        logits, _ = stage_forward(params, self.cfg, self.spec, tok[:, None],
                                  KVCache(st["keys"], st["values"], length),
                                  pos, attn_impl=dec_attn)
        nxt = sample_logits(logits[:, -1, :], st["gen"], self.sampling)
        st["length"], st["tok"] = length + 1, nxt
        return nxt


def make_ulysses_generate_fn(cfg: ModelConfig, mesh, *, max_seq: int,
                             num_new_tokens: int,
                             sampling: Optional[SamplingParams] = None,
                             kv_cache_dtype=None):
    """``fn(params, prompt_ids, seed) -> tokens`` [b, num_new_tokens]:
    Ulysses prefill + head-sharded-cache decode over ``mesh``'s sp axis.
    Requires ``prompt_len % sp == 0``, ``num_heads % sp == 0``,
    ``num_kv_heads % sp == 0`` and ``prompt_len + num_new_tokens <=
    max_seq``; greedy when ``sampling`` is None.  ``kv_cache_dtype``:
    the head-sharded cache's storage; attention reads what it stores."""
    _check_heads(cfg, mesh.shape["sp"])
    return _make_generate_fn("ulysses", cfg, mesh, max_seq, num_new_tokens,
                             sampling, kv_cache_dtype)


def make_ulysses_stream_fns(cfg: ModelConfig, mesh, *, max_seq: int,
                            block: int,
                            sampling: Optional[SamplingParams] = None,
                            kv_cache_dtype=None) -> StreamFns:
    """The step-split Ulysses programs, with
    :func:`~.sequence.make_sp_stream_fns`' contract."""
    _check_heads(cfg, mesh.shape["sp"])
    return StreamFns("ulysses", cfg, mesh, max_seq, block, sampling,
                     kv_cache_dtype)
