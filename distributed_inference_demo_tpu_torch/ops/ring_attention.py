"""Ring attention: sequence/context parallelism over a mesh axis.

Counterpart of ``distributed_inference_demo_tpu/ops/ring_attention.py``.
The sequence is sharded over the ``sp`` axis, each rank holds one
contiguous chunk, and causal self-attention is computed blockwise with an
online-softmax accumulator while K/V blocks travel around the ring
(``AxisGroup.rotate``, the reference's ``lax.ppermute``).  Decode
attends a sequence-sharded cache: every rank attends its shard and the
partial softmax statistics merge exactly with a log-sum-exp reduction
(all-reduces with MAX and SUM, the reference's ``pmax`` / ``psum``).

Both take a ``parallel.mesh.AxisGroup`` where the reference takes an
axis name, and run on every rank of the mesh.  The reference's rings are
XLA code with no Pallas kernel; these are plain PyTorch.  GQA and ALiBi
as in ``ops.attention``.
"""

from typing import Optional, Tuple

import torch

_NEG = -1e30


def _split_heads(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """[b, l, nh, hd] -> [b, l, nkv, groups, hd] for GQA broadcast."""
    b, l, nh, hd = q.shape
    return q.reshape(b, l, nkv, nh // nkv, hd)


def _bias_and_mask(scores: torch.Tensor, q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, slopes: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal mask (+ ALiBi) on a [b, nkv, g, lq, lk] score block; global
    positions ``q_pos`` [lq] and ``kv_pos`` [lk]."""
    b, nkv, g, lq, lk = scores.shape
    valid = (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
    if slopes is not None:
        dist = (q_pos[:, None] - kv_pos[None, :]).float()
        scores = scores - slopes.reshape(1, nkv, g, 1, 1) * dist
    return torch.where(valid, scores, torch.full_like(scores, _NEG)), valid


def _online_update(o, m, l, scores, valid, vf):
    """One flash-attention accumulator step (f32): ``o`` [b,nkv,g,lq,hd]
    unnormalized, ``m`` the running max, ``l`` the running denominator."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a fully masked row keeps m_new at _NEG: zero its probabilities
    p = torch.where(valid, torch.exp(scores - m_new[..., None]),
                    torch.zeros((), device=scores.device))
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vf)
    return o_new, m_new, l_new


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group, chunk_offset: Optional[int] = None,
                        slopes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Causal self-attention with the sequence sharded over ``group``.

    Rank ``i`` owns tokens ``[i*lq, (i+1)*lq)`` unless ``chunk_offset``
    gives the global start.  q [b, lq, nh, hd], k/v [b, lk, nkv, hd]
    local chunks; K/V blocks rotate around the ring, the local block
    first, then n - 1 rotate-and-attend steps.  Returns [b, lq, nh, hd]
    in q's dtype."""
    n, idx = group.size, group.rank
    b, lq, nh, hd = q.shape
    nkv, lk = k.shape[2], k.shape[1]
    g = nh // nkv
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    qf = _split_heads(q.float() * scale.to(dev), nkv)
    q_off = idx * lq if chunk_offset is None else int(chunk_offset)
    q_pos = q_off + torch.arange(lq, device=dev)

    o = torch.zeros((b, nkv, g, lq, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, nkv, g, lq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, g, lq), dtype=torch.float32, device=dev)

    def attend(o, m, l, kb, vb, kv_off):
        kv_pos = kv_off + torch.arange(lk, device=dev)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qf, kb.float())
        scores, valid = _bias_and_mask(scores, q_pos, kv_pos, slopes)
        return _online_update(o, m, l, scores, valid, vb.float())

    kv_off = idx * lk if chunk_offset is None else int(chunk_offset)
    o, m, l = attend(o, m, l, k, v, kv_off)
    # blocks travel in their own dtype, the offsets beside them
    kb, vb = k.contiguous(), v.contiguous()
    off = torch.tensor([kv_off], dtype=torch.int64, device=dev)
    for _ in range(n - 1):
        kb, vb, off = group.rotate(kb), group.rotate(vb), group.rotate(off)
        o, m, l = attend(o, m, l, kb, vb, int(off[0]))
    out = o / l.clamp_min(1e-30)[..., None]            # [b, nkv, g, lq, hd]
    out = out.permute(0, 3, 1, 2, 4)                   # [b, lq, nkv, g, hd]
    return out.reshape(b, lq, nh, hd).to(q.dtype)


def sp_decode_attention(q: torch.Tensor, k_shard: torch.Tensor,
                        v_shard: torch.Tensor, kv_pos: torch.Tensor,
                        q_positions: torch.Tensor, group,
                        slopes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decode attention against a sequence-sharded cache.

    q [b, lq, nh, hd] (the same on every rank), the local cache shard
    [b, nkv, s_loc, hd], ``kv_pos`` [s_loc] global positions (-1 =
    empty), ``q_positions`` [b, lq].  Every rank attends its shard; the
    partial statistics merge exactly: ``m* = max(m)``, ``l* =
    sum(l e^{m-m*})``, ``o* = sum(o e^{m-m*}) / l*``."""
    b, lq, nh, hd = q.shape
    nkv = k_shard.shape[1]
    g = nh // nkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    qf = _split_heads(q.float() * scale.to(q.device), nkv)
    scores = torch.einsum("bqkgh,bksh->bkgqs", qf, k_shard.float())
    causal = kv_pos[None, None, :] <= q_positions[:, :, None]  # [b, lq, s]
    valid = (causal & (kv_pos >= 0)[None, None, :])[:, None, None]
    if slopes is not None:
        dist = (q_positions[:, :, None] - kv_pos[None, None, :]).float()
        scores = scores - slopes.reshape(1, nkv, g, 1, 1) * dist[:, None,
                                                                  None]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m_loc = scores.amax(dim=-1)                               # [b,nkv,g,lq]
    p = torch.where(valid, torch.exp(scores - m_loc[..., None]),
                    torch.zeros((), device=q.device))
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgqs,bksh->bkgqh", p, v_shard.float())

    m_glob = group.all_reduce(m_loc.clone(), op="max")
    alpha = torch.exp(m_loc - m_glob)
    l_glob = group.all_reduce((l_loc * alpha).contiguous())
    o_glob = group.all_reduce((o_loc * alpha[..., None]).contiguous())
    out = o_glob / l_glob.clamp_min(1e-30)[..., None]         # [b,nkv,g,lq,hd]
    out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(b, lq, nh, hd).to(q.dtype)
