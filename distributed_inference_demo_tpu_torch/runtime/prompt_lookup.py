"""Prompt-lookup (n-gram) speculative decoding: draft-free speculation.

Counterpart of ``distributed_inference_demo_tpu/runtime/prompt_lookup.py``.
The proposer is the text itself: find where the current bigram (else
unigram) last occurred in the row's history and propose the K tokens
that followed it.  The history (prompt + emitted) is a ``[b, cap]``
device buffer seeded from the ids and the first token and updated
inside the round, so proposing costs no host round trip.
Verification, the lockstep advance and the rollback are the draft-model
engine's (``runtime/speculative.py``), with the proposer a one-hot
distribution (``q_logits=None``); greedy mode gives the target's own
greedy tokens.  One round is a step over static buffers, a CUDA graph on
the card, as ``SpeculativeEngine``'s.
"""

from typing import Optional

import numpy as np
import torch

from ..models.base import KVCache, ModelConfig, StageParams, pad_cache_capacity
from ..ops.sampling import SamplingParams
from .engine import prefill_programs
from .kvcache import make_kv_backend
from .speculative import RoundState, _RoundEngine


def ngram_propose(history: torch.Tensor, hist_len: torch.Tensor,
                  num_draft: int) -> torch.Tensor:
    """[b, K] proposals from the latest bigram/unigram match over a
    [b, cap] token-history buffer with per-row valid lengths [b] (>= 1).

    For each row: score position j by 2*(bigram match ending at j) +
    (history[j] == last token), require j < hist_len - 1 (the match needs
    a following token inside the valid region), take the highest-scoring
    latest j, and propose the K tokens after it, clamped to the last
    valid one.  Score 0 everywhere degenerates to j = cap-1, which
    proposes the last token repeated.  Shared by PromptLookupEngine and
    the batching engine's prompt-lookup proposer."""
    cap, K = history.shape[1], num_draft
    pos = torch.arange(cap, device=history.device)[None, :]
    last = torch.gather(history, 1, (hist_len - 1)[:, None])
    prev = torch.gather(history, 1,
                        torch.clamp_min(hist_len - 2, 0)[:, None])
    uni = history == last
    bi = uni & (torch.roll(history, 1, dims=1) == prev) & (pos > 0)
    valid = pos < (hist_len - 1)[:, None]
    score = (2 * bi.long() + uni.long()) * valid.long()
    # lexicographic (score, position) argmax via score*cap + pos
    j = torch.argmax(score * cap + pos, dim=1)
    idx = j[:, None] + 1 + torch.arange(K, device=history.device)[None, :]
    idx = torch.minimum(idx, hist_len[:, None] - 1)
    return torch.gather(history, 1, idx)


class PromptLookupEngine(_RoundEngine):
    """Draft-free speculative generation over a single-stage model."""

    def __init__(self, cfg: ModelConfig, params: StageParams,
                 max_seq: Optional[int] = None,
                 sampling: SamplingParams = SamplingParams(),
                 num_draft: int = 4,
                 attn_backend: str = "auto",
                 mesh=None,
                 eos_id: Optional[int] = None,
                 kv_cache_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 kv_cache_blocks: Optional[int] = None,
                 kv_block_tokens: Optional[int] = None,
                 kv_layout: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 device=None, cuda_graph: bool = True):
        """Arguments as ``SpeculativeEngine``'s, without a draft: the
        prefix pool seeds the cache only, and the history always seeds
        from the full ids.  Over a tp ``mesh`` the history and the
        round's state stay on rank 0."""
        self._setup(cfg, params, max_seq, sampling, num_draft, eos_id,
                    prefill_chunk, mesh, kv_layout, device, cuda_graph)
        attn_impl = self._attn(kv_cache_dtype, attn_backend, (cfg.head_dim,))
        self._fwd_t = self._make_fwd(cfg, self.params, self.spec, attn_impl)
        self._t_progs = prefill_programs(self._fwd_t, self.device)
        # history/cache slack per round, padded to 8 as the reference's
        self._cap = pad_cache_capacity(self.max_seq + num_draft + 2)
        self.kv_cache = make_kv_backend(
            cfg, kv_cache_blocks, kv_block_tokens, layout=self.kv_layout,
            dtype=self.kv_cache_dtype, kv_dtype=kv_dtype, default_blocks=0,
            device=self.device, device_ops=self._pool_ops())

    def _new_state(self, batch: int) -> RoundState:
        st = RoundState(batch, self.num_draft, self.device)
        st.tcache = self._cache(self.cfg, batch, self._cap)
        st.history = torch.zeros((batch, self._cap), dtype=torch.int64,
                                 device=self.device)
        return st

    def _prefill(self, prompt, ids, st: RoundState):
        """The prompt prefill through the prefix pool, then the history
        seeded with the ids (the first token follows in ``_begin``)."""
        tc = st.tcache
        _, logits = self._prefill_target(prompt, ids,
                                         KVCache(tc.keys, tc.values, 0))
        st.history[:, :ids.shape[1]] = ids
        return logits

    def _begin(self, prompt: np.ndarray, ids, seed: int) -> RoundState:
        st = super()._begin(prompt, ids, seed)
        st.history[:, ids.shape[1]] = st.last
        return st

    def _round(self, st: RoundState) -> None:
        """One prompt-lookup round on ``st``, in place: propose from the
        history (its valid length is the cache's plus the last token),
        verify, advance, and append the emitted block to the history at
        ``n + 1``; entries past ``m`` are overwritten next round and
        never read before."""
        b, K = st.last.shape[0], self.num_draft
        n = self._round_start(st)
        drafts = ngram_propose(st.history, (n + 1).expand(b), K)
        emitted = self._verify(st, n, drafts, None,
                               KVCache(st.tcache.keys, st.tcache.values, n))
        idx = n + 1 + torch.arange(K + 1, device=self.device)
        st.history.index_copy_(1, idx, emitted)
