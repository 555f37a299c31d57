"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``distributed_inference_demo_tpu/runtime/speculative.py``:
the shared accept/resample rule (:func:`accept_and_extra`,
:func:`verify_emit`, :func:`verify_emit_per_row`), the host-side helpers
every speculative engine's generate loop shares, ``SpeculativeEngine``
and its HTTP backend.

One round is: the draft's K+1 autoregressive 1-token steps (the extra
step inserts d_K's K/V, so an all-accept round leaves the draft cache
fully populated), ONE target verify forward over ``[b, K+1]`` tokens,
the standard rejection rule, and a lockstep advance of every row by
``m = min_b(a_b) + 1``.  A rollback is only a length reset: rejected
tokens' K/V stays above the valid length, where the causal mask keeps
it unseen until the next round overwrites it.  Greedy mode verifies by
argmax equality and gives the target's own greedy tokens.

The noise seam.  The reference draws the accept test's uniforms with
``jax.random.uniform`` and the follow-up token with
``jax.random.categorical``, which is ``argmax(logits + gumbel)``.  Here
the rule takes the uniforms ``u`` [b, K] and the Gumbel noise ``g``
[b, V] as tensors; the engines draw both from their ``torch.Generator``
(``ops/sampling.gumbel_noise``), and a test can hand the port the
reference's own numbers.

The reference fuses R rounds in one ``lax.scan``.  Here one round is a
step over static buffers (the caches, their device length, the last
token, the round's ``[b, K+1]`` block and ``m``): on the card a CUDA
graph captured once per batch size (``runtime/cuda_graph.py``) and
replayed R times, each replay's block and ``m`` copied into slot r of
a ``[R, ...]`` device buffer, with one host sync per R rounds; on the
CPU, or with ``cuda_graph=False``, the same round runs eagerly.  The
prompt prefill runs eagerly at host lengths, so on the card chunks of 16
tokens or more take the flash kernel, while the round's 1-token draft
steps and its (K+1)-token verify take ``ops.attention.attention_at`` at
the device length (the reference's routing, ``ops/flash_attention.py``).
"""

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import KVCache, ModelConfig, StageParams, StageSpec
from ..models.decoder import stage_forward
from ..ops.flash_attention import make_flash_attn_impl
from ..ops.sampling import (SamplingParams, filtered_logits, gumbel_noise,
                            sample_logits)
from .cuda_graph import StepGraphs
from .engine import (GenerationResult, _new_cache, check_capacity,
                     engine_params_for_mesh, prefill_programs,
                     resolve_attn_backend, resolve_cache_dtype_backend,
                     run_seeded_prefill, validate_prefill_chunk)
from .kvcache import make_kv_backend, resolve_kv_layout


@dataclass
class SpecStats:
    """Acceptance diagnostics for one generate() call."""
    rounds: int = 0
    drafted: int = 0            # num_draft * rounds
    accepted: int = 0           # draft tokens accepted (excl. bonus/resample)
    emitted: int = 0            # tokens actually kept (after min + trim)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else float("nan")

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / self.rounds if self.rounds else float("nan")


def accept_and_extra(t_logits, drafts, q_logits, samp: SamplingParams,
                     u=None, g=None, k_cap=None):
    """The speculative accept/resample rule, shared by every proposer
    (draft model, prompt lookup) and every advance policy (lockstep,
    per-row), as the reference's.

    t_logits: [b, K+1, V] target logits over [last_tok, d_1..d_K];
    drafts:   [b, K] proposals;
    q_logits: [b, K, V] proposer's filtered logits, or None for a
              deterministic proposer (one-hot q: accept d with prob p(d),
              resample from p with d masked out);
    u, g:     [b, K] uniforms in [0, 1) and [b, V] Gumbel noise (unused,
              and may be None, in greedy mode);
    k_cap:    [b] per-row draft-length cap in [1, K], or None: proposals
              at positions >= k_cap[i] are never accepted, and a
              truncation there samples the follow-up from the target's
              own distribution, not the residual.

    Returns (a [b] accepted-draft counts in [0, K], extra [b]: the
    rejection-point resample, or the bonus token after K accepts)."""
    b, K = drafts.shape
    cols = torch.arange(K, device=drafts.device)[None, :]
    if samp.greedy:
        t_arg = torch.argmax(t_logits, dim=-1)
        accept = drafts == t_arg[:, :K]
        if k_cap is not None:
            accept = accept & (cols < k_cap[:, None])
        a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
        # rejected at a: the target's own argmax; all accepted: the bonus
        # argmax after d_K; a k_cap truncation: the token greedy decode
        # would emit there.  All three are t_arg[:, a]
        return a, torch.gather(t_arg, 1, a[:, None])[:, 0]
    p_logits = filtered_logits(t_logits, samp)               # [b, K+1, V]
    p = torch.softmax(p_logits[:, :K], dim=-1)
    p_d = torch.gather(p, -1, drafts[..., None])[..., 0]      # [b, K]
    if q_logits is None:
        accept = u < p_d
    else:
        q = torch.softmax(q_logits, dim=-1)
        q_d = torch.gather(q, -1, drafts[..., None])[..., 0]
        accept = u * torch.clamp_min(q_d, 1e-20) < p_d
    if k_cap is not None:
        accept = accept & (cols < k_cap[:, None])
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    # resample distribution at the rejection point: norm(max(p - q, 0));
    # for a one-hot q that is p with the draft token masked out
    a_idx = torch.clamp_max(a, K - 1)
    rows = torch.arange(b, device=drafts.device)
    p_a = p[rows, a_idx]                                      # [b, V]
    if q_logits is None:
        d_a = torch.gather(drafts, 1, a_idx[:, None])
        resid_a = p_a.scatter(1, d_a, 0.0)
    else:
        resid = torch.clamp_min(p - torch.softmax(q_logits, dim=-1), 0.0)
        resid_a = resid[rows, a_idx]
    # an all-zero residual (p == q, a point mass on d) falls back to p_a
    resid_sum = resid_a.sum(dim=-1, keepdim=True)
    resid_a = torch.where(resid_sum > 0, resid_a, p_a)
    if k_cap is not None:
        # truncated at k_cap < K with every eligible proposal accepted:
        # the position-a proposal was never offered, so the follow-up is
        # a plain sample from p there
        trunc = (a == k_cap) & (k_cap < K)
        resid_a = torch.where(trunc[:, None], p_a, resid_a)
    bonus = torch.softmax(p_logits[:, K], dim=-1)
    extra_probs = torch.where((a == K)[:, None], bonus, resid_a)
    extra = torch.argmax(g + torch.log(extra_probs + 1e-30), dim=-1)
    return a, extra


def assemble_emitted(drafts, a, extra):
    """[b, K+1] emitted block from per-row accept counts: row i is
    [d_1..d_{a_i}, extra_i, 0...]."""
    K = drafts.shape[1]
    idx = torch.arange(K + 1, device=drafts.device)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    zero = torch.zeros((), dtype=drafts.dtype, device=drafts.device)
    return torch.where(idx < a[:, None], drafts_pad,
                       torch.where(idx == a[:, None], extra[:, None], zero))


def verify_emit(t_logits, drafts, q_logits, samp: SamplingParams,
                u=None, g=None):
    """Accept/resample and the emitted block with LOCKSTEP advance: all
    rows move by ``m = min_b(a_b) + 1``.  Returns (emitted [b, K+1], m a
    0-d device tensor in [1, K+1], new_last [b]); nothing here syncs."""
    b = drafts.shape[0]
    a, extra = accept_and_extra(t_logits, drafts, q_logits, samp, u, g)
    emitted = assemble_emitted(drafts, a, extra)
    m = a.min() + 1
    new_last = torch.gather(emitted, 1, (m - 1).expand(b, 1))[:, 0]
    return emitted, m, new_last


def verify_emit_per_row(t_logits, drafts, q_logits, samp: SamplingParams,
                        u=None, g=None, k_cap=None):
    """Accept/resample and the emitted block with PER-ROW advance: row i
    moves by ``n_i = a_i + 1`` (the slot cache's policy); the follow-up
    token is always the row's ``extra``.  Returns (emitted [b, K+1], n
    [b] in [1, K+1], new_last [b])."""
    a, extra = accept_and_extra(t_logits, drafts, q_logits, samp, u, g,
                                k_cap=k_cap)
    return assemble_emitted(drafts, a, extra), a + 1, extra


def draw_noise(b: int, K: int, V: int, generator, device):
    """The rule's noise for one verify, drawn in the reference's order:
    the uniforms [b, K], then the Gumbel noise [b, V]."""
    u = torch.rand((b, K), generator=generator, device=device,
                   dtype=torch.float32)
    return u, gumbel_noise((b, V), generator, device)


def propose_token(logits, samp: SamplingParams, generator):
    """One draft step's proposal from its [b, V] logits -> (d [b], q):
    the argmax in greedy mode (q None), else a draw from the filtered
    logits q, ``argmax(q + gumbel)`` as the reference's categorical."""
    if samp.greedy:
        return torch.argmax(logits, dim=-1), None
    q = filtered_logits(logits, samp)
    g = gumbel_noise(q.shape, generator, q.device)
    return torch.argmax(g + q, dim=-1), q


def mask_after_eos(toks: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    """Rows keep emitting ``eos_id`` after their first eos (the decode
    loop's row padding), applied host-side to an assembled [b, T]
    block."""
    if eos_id is None:
        return toks
    hit = toks == eos_id
    after = (np.cumsum(hit, axis=1) - hit) > 0
    toks = toks.copy()
    toks[after] = eos_id
    return toks


def init_done(first: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    """[b] done mask seeded from the prefill-sampled first token."""
    return (first == eos_id if eos_id is not None
            else np.zeros(first.shape, bool))


def pad_to_width(toks: np.ndarray, max_new: int,
                 eos_id: Optional[int]) -> np.ndarray:
    """Pad an early-eos-stopped [b, T] block out to [b, max_new]; only
    reachable when every row already emitted eos, so the pad is
    all-eos."""
    b, t = toks.shape
    if t < max_new:
        toks = np.concatenate(
            [toks, np.full((b, max_new - t), eos_id, toks.dtype)], axis=1)
    return toks


def emit_stream_block(block, m, done, total, max_new, eos_id,
                      stats: SpecStats):
    """Mask and hand out one round's [b, m] token block for the streaming
    surface: finished rows keep emitting eos, ``done`` updates in place,
    ``stats.emitted`` advances per token.  Yields ``(tok, all_done)``."""
    for j in range(min(m, max_new - total)):
        tok = block[:, j].copy()
        if eos_id is not None:
            tok[done] = eos_id
        stats.emitted = total + j + 1
        all_done = False
        if eos_id is not None:
            np.logical_or(done, tok == eos_id, out=done)
            all_done = bool(done.all())
        yield tok, all_done


def drain_round_blocks(em, ms, out, stats: SpecStats, num_draft: int,
                       total: int, max_new: int, eos_id: Optional[int] = None,
                       done: Optional[np.ndarray] = None) -> int:
    """Collect one dispatch's round blocks into ``out``/``stats``; returns
    the updated emitted-token total.  With ``eos_id``/``done`` given, ORs
    each block's eos hits into ``done`` row-wise."""
    for r in range(em.shape[0]):
        m = int(ms[r])
        block = em[r][:, :m]
        out.append(block)
        if eos_id is not None and done is not None:
            np.logical_or(done, (block == eos_id).any(axis=1), out=done)
        stats.rounds += 1
        stats.drafted += num_draft
        stats.accepted += m - 1   # lockstep: min_b(accepted) used
        total += m
        if total >= max_new:
            break
    return total


def stats_json(stats: Optional[SpecStats], num_draft: int) -> Optional[dict]:
    """SpecStats -> JSON-safe dict (0 rounds yields NaN rates, which JSON
    has no name for: None).  Shared by the CLI and the HTTP backend."""
    if stats is None:
        return None

    def finite(x, nd):
        return round(x, nd) if x == x else None

    return {"num_draft": num_draft,
            "rounds": stats.rounds,
            "acceptance_rate": finite(stats.acceptance_rate, 4),
            "tokens_per_round": finite(stats.tokens_per_round, 3)}


class RoundState:
    """The static buffers of one batch size that a round reads and writes
    in place: the target cache (and the draft's, or the prompt-lookup
    history), their shared device length (a 0-d int64 tensor), the last
    token, the round's emitted block and advance ``m``.  ``step`` runs
    one round on it (a replayed graph on the card)."""

    def __init__(self, batch: int, K: int, device):
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)
        self.length = zeros()
        self.last = zeros(batch)
        self.block = zeros(batch, K + 1)
        self.m = zeros()
        self.step = None


class _RoundEngine:
    """What the two single-request speculative engines share: the
    generator, the per-batch-size round states and their graphs, the
    target's prefill programs and prefix pool, and the generate loops
    (the reference's are the same code twice)."""

    def _setup(self, cfg, params, max_seq, sampling, num_draft, eos_id,
               prefill_chunk, mesh, kv_layout, device, cuda_graph):
        from ..parallel.tensor import check_graph_under_mesh, validate_tp
        if num_draft < 1:
            raise ValueError("num_draft must be >= 1")
        self.kv_layout = resolve_kv_layout(kv_layout)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._tp = validate_tp(cfg, mesh)
        check_graph_under_mesh(mesh, cuda_graph, self.device)
        if self._tp > 1 and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the engine "
                             f"on {self.device}")
        params = engine_params_for_mesh(params, cfg, mesh)
        p_dev = params.embed["tokens"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, the engine on "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq or cfg.max_seq_len
        self.sampling = sampling
        self.num_draft = num_draft
        self.eos_id = eos_id
        self.spec = StageSpec(0, 1, 0, cfg.num_layers)
        self.prefill_chunk = validate_prefill_chunk(prefill_chunk,
                                                    self.max_seq)
        self.cuda_graph = bool(cuda_graph)
        self._gen = torch.Generator(device=self.device)
        self._graphs = StepGraphs(self.device, self._gen, self.cuda_graph)
        self._states = {}
        self._lock = threading.Lock()

    def _attn(self, kv_cache_dtype, attn_backend, head_dims):
        """The resolved cache dtype and attention hook, both models'
        head dims checked against the kernel's."""
        from ..parallel.tensor import resolve_tp_attn_backend
        attn_backend = resolve_tp_attn_backend(self._tp, attn_backend)
        self.kv_cache_dtype, attn_backend = resolve_cache_dtype_backend(
            kv_cache_dtype, attn_backend)
        for hd in head_dims:
            self.attn_backend = resolve_attn_backend(
                attn_backend, self.device.type, hd)
        return (make_flash_attn_impl() if self.attn_backend == "flash"
                else None)

    def _make_fwd(self, cfg, params, spec, attn_impl):
        """``fwd(ids, cache, pos, last_logits_only)`` of one model: its
        ``stage_forward``, or over a tp mesh the tp seam (every rank
        builds its own hook for its heads; the logits come back
        replicated to rank 0, which keeps the round's state)."""
        if self._tp > 1:
            from ..parallel.tensor import make_forward_seam
            seam, _ = make_forward_seam(cfg, spec, self.mesh, params,
                                        attn_backend=self.attn_backend)

            def fwd(ids, cache, pos, last_logits_only):
                return seam(params, ids, cache, pos, last_logits_only)
            fwd.handle = seam.handle
            return fwd

        def fwd(ids, cache, pos, last_logits_only):
            return stage_forward(params, cfg, spec, ids, cache, pos,
                                 attn_impl=attn_impl,
                                 last_logits_only=last_logits_only)
        return fwd

    @property
    def graph_replays(self) -> int:
        """Rounds replayed from a captured graph, over all states."""
        return self._graphs.replays

    def free_tp(self) -> None:
        """Over a tp mesh: drop, on every rank, the planes of the round
        states' caches and of the prefix pool, the models' forward hooks
        and their weight shards; the engine is unusable after it.  A
        no-op off a mesh or once the mesh is closed."""
        if self._tp <= 1 or self.mesh.closed:
            return
        from ..parallel.tensor import free_tp
        objs = [self.params, self._fwd_t]
        if getattr(self, "draft_params", None) is not None:
            objs += [self.draft_params, self._fwd_d]
        for st in self._states.values():
            for cache in (st.tcache, getattr(st, "dcache", None)):
                if cache is not None:
                    objs += [cache.keys, cache.values]
        if self.kv_cache is not None:
            objs += [self.kv_cache._pk, self.kv_cache._pv]
        free_tp(self.mesh, *objs)
        self._states.clear()

    def _round_start(self, st: RoundState) -> torch.Tensor:
        """The round's start position: the device length, clamped at
        ``max_seq`` so the round's K+1 writes stay inside the caches'
        ``max_seq + K + 1`` columns (the reference's
        ``dynamic_update_slice`` clamps such a write instead).  A round
        starting past ``max_seq`` only runs after ``max_new_tokens`` were
        emitted, so its block is never drained."""
        return torch.clamp_max(st.length, self.max_seq)

    def _verify(self, st: RoundState, n, drafts, q_logits, tcache: KVCache):
        """The target verify of one round over ``[last, d_1..d_K]`` at
        positions ``n + arange(K+1)``, the lockstep accept rule, and the
        round's outputs into ``st`` (the length advances by ``m``)."""
        b, K = drafts.shape
        verify_in = torch.cat([st.last[:, None], drafts], dim=1)
        pos = n + torch.arange(K + 1, device=self.device).expand(b, K + 1)
        t_logits, _ = self._fwd_t(verify_in, tcache, pos, False)
        u = g = None
        if not self.sampling.greedy:
            u, g = draw_noise(b, K, t_logits.shape[-1], self._gen,
                              self.device)
        emitted, m, new_last = verify_emit(t_logits, drafts, q_logits,
                                           self.sampling, u, g)
        st.block.copy_(emitted)
        st.m.copy_(m)
        st.last.copy_(new_last)
        st.length.add_(m)
        return emitted

    def _state(self, batch: int) -> RoundState:
        """The round state of ``batch`` rows, made at first use with its
        round captured; the warm-up round writes the fresh state, before
        any prefill fills it."""
        st = self._states.get(batch)
        if st is None:
            st = self._new_state(batch)
            st.step = self._graphs.capture(lambda: self._round(st))
            self._states[batch] = st
        return st

    def _cache(self, cfg, batch: int, cap: int) -> KVCache:
        """A dense cache of ``cap`` columns (padded to 8): on the device,
        or every rank's kv-head plane over a tp mesh."""
        return _new_cache(cfg, batch, cap, self.kv_cache_dtype, self.device,
                          self.mesh)

    def _pool_ops(self):
        """The prefix pool's device ops: every rank's plane over a tp
        mesh (``parallel.tensor.TPPoolOps``), else None."""
        from ..parallel.tensor import TPPoolOps
        return TPPoolOps(self.mesh) if self._tp > 1 else None

    def _ids(self, prompt_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64)
        if ids.ndim != 2:
            raise ValueError("prompt_ids must be [batch, prompt_len]")
        return ids.to(self.device)

    def _prefill_target(self, prompt: np.ndarray, ids, tcache: KVCache):
        """The target's prompt prefill through its prefix pool: a hit
        (batch 1) seeds the leading columns and prefills the suffix; the
        full blocks are stored afterwards.  Returns (start, last logits)."""
        start = 0
        if self.kv_cache is not None:
            start, tcache = self.kv_cache.seed(prompt, tcache)
        logits, tcache = run_seeded_prefill(
            ids, tcache, self.prefill_chunk, self.max_seq, self._t_progs,
            start=start)
        if self.kv_cache is not None:
            self.kv_cache.store(prompt, tcache)
        return start, logits

    def _begin(self, prompt: np.ndarray, ids, seed: int) -> RoundState:
        """Seed the generator, prefill, sample the first token from the
        target's logits into the state; the length is the prompt's."""
        st = self._state(ids.shape[0])
        self._gen.manual_seed(int(seed))
        logits = self._prefill(prompt, ids, st)
        st.last.copy_(sample_logits(logits, self._gen, self.sampling))
        st.length.fill_(ids.shape[1])
        return st

    def _dispatch(self, st: RoundState, rounds: int):
        """``rounds`` rounds, each one's block and ``m`` copied into slot
        r of the dispatch's buffers, then one readback."""
        b, w = st.block.shape
        em = torch.empty((rounds, b, w), dtype=torch.int64,
                         device=self.device)
        ms = torch.empty((rounds,), dtype=torch.int64, device=self.device)
        for r in range(rounds):
            st.step()
            em[r].copy_(st.block)
            ms[r].copy_(st.m)
        return em.cpu().numpy(), ms.cpu().numpy()

    def generate(self, prompt_ids, max_new_tokens: int, seed: int = 0,
                 rounds_per_dispatch: Optional[int] = None
                 ) -> "tuple[GenerationResult, SpecStats]":
        """Generate with draft/verify rounds; returns (result, stats).
        ``rounds_per_dispatch`` (default ``min(8, max_new_tokens)``):
        rounds per host sync; overshoot is trimmed."""
        ids = self._ids(prompt_ids)
        b, plen = ids.shape
        check_capacity(self.max_seq, plen, max_new_tokens)
        R = rounds_per_dispatch or min(8, max(1, max_new_tokens))
        with self._lock:
            self._state(b)       # a new batch size captures here, untimed
            t0 = time.perf_counter()
            st = self._begin(np.asarray(prompt_ids), ids, seed)
            stats = SpecStats()
            # a copy: on the CPU .numpy() views the static buffer
            first = st.last.cpu().numpy().copy()
            out = [first[:, None]]
            done = init_done(first, self.eos_id)
            total = 1
            while total < max_new_tokens and not done.all():
                em, ms = self._dispatch(st, R)
                total = drain_round_blocks(em, ms, out, stats,
                                           self.num_draft, total,
                                           max_new_tokens, self.eos_id, done)
        toks = np.concatenate(out, axis=1)[:, :max_new_tokens]
        toks = mask_after_eos(pad_to_width(toks, max_new_tokens,
                                           self.eos_id), self.eos_id)
        dt = time.perf_counter() - t0
        # the emitted count, not the eos-padded width
        stats.emitted = min(total, max_new_tokens)
        return (GenerationResult(tokens=toks.astype(np.int32),
                                 prompt_len=plen,
                                 num_new=toks.shape[1], seconds=dt),
                stats)

    def generate_stream(self, prompt_ids, max_new_tokens: int,
                        seed: int = 0,
                        stats_out: Optional[SpecStats] = None):
        """Yield [batch] token arrays per emitted token; they arrive in
        bursts of up to K+1, one round per host sync.  ``stats_out``, if
        given, is updated in place per round."""
        if max_new_tokens <= 0:
            return
        ids = self._ids(prompt_ids)
        b, plen = ids.shape
        check_capacity(self.max_seq, plen, max_new_tokens)
        stats = stats_out if stats_out is not None else SpecStats()
        with self._lock:
            st = self._begin(np.asarray(prompt_ids), ids, seed)
            first = st.last.cpu().numpy().copy()
            yield first.astype(np.int32)
            done = init_done(first, self.eos_id)
            total = stats.emitted = 1
            while total < max_new_tokens and not done.all():
                em, ms = self._dispatch(st, 1)
                m, block = int(ms[0]), em[0]
                stats.rounds += 1
                stats.drafted += self.num_draft
                stats.accepted += m - 1
                for tok, all_done in emit_stream_block(
                        block, m, done, total, max_new_tokens, self.eos_id,
                        stats):
                    yield tok.astype(np.int32)
                    if all_done:
                        return
                total += m
                stats.emitted = min(total, max_new_tokens)


class SpeculativeEngine(_RoundEngine):
    """Draft/verify generation over two full single-stage models."""

    def __init__(self, cfg: ModelConfig, params: StageParams,
                 draft_cfg: ModelConfig, draft_params: StageParams,
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
        """Arguments as in the reference.  ``kv_cache_dtype`` stores both
        caches as float8 (plain attention, as the reference's rule);
        ``prefill_chunk`` runs both models' prefill in C-token chunks;
        ``kv_cache_blocks`` / ``kv_block_tokens`` / ``kv_dtype``: the
        target-side prefix pool (batch 1): a hit seeds the target's
        cache and prefills its suffix, while the draft always prefills
        the full prompt.  ``attn_backend`` "auto", "flash" or "plain"
        (``runtime/engine.resolve_attn_backend``).

        ``mesh``: a tp mesh; both models run on its seam (the draft's
        kv heads must divide by tp too), their caches are every rank's
        kv-head planes, and rank 0 keeps the round's state and samples
        from replicated logits.  A multi-rank round runs eagerly
        (``parallel.tensor.check_graph_under_mesh``).

        Port-only: ``device`` (CUDA unless "cpu" is asked for; both
        models' params must live there) and ``cuda_graph`` (False runs
        the round eagerly on the card: the comparison for the graph)."""
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab_size}) != target vocab "
                f"({cfg.vocab_size}); speculative decoding needs a shared "
                "token space")
        self._setup(cfg, params, max_seq, sampling, num_draft, eos_id,
                    prefill_chunk, mesh, kv_layout, device, cuda_graph)
        if draft_params.embed["tokens"].device.type != self.device.type:
            raise ValueError("the draft's params live on "
                             f"{draft_params.embed['tokens'].device}, the "
                             f"engine on {self.device}")
        from ..parallel.tensor import validate_tp
        validate_tp(draft_cfg, mesh)
        draft_params = engine_params_for_mesh(draft_params, draft_cfg, mesh)
        self.draft_cfg, self.draft_params = draft_cfg, draft_params
        self.draft_spec = StageSpec(0, 1, 0, draft_cfg.num_layers)
        attn_impl = self._attn(kv_cache_dtype, attn_backend,
                               (cfg.head_dim, draft_cfg.head_dim))
        self._fwd_t = self._make_fwd(cfg, self.params, self.spec, attn_impl)
        self._fwd_d = self._make_fwd(draft_cfg, draft_params,
                                     self.draft_spec, attn_impl)
        self._t_progs = prefill_programs(self._fwd_t, self.device)
        self._d_progs = prefill_programs(self._fwd_d, self.device)
        self.kv_cache = make_kv_backend(
            cfg, kv_cache_blocks, kv_block_tokens, layout=self.kv_layout,
            dtype=self.kv_cache_dtype, kv_dtype=kv_dtype, default_blocks=0,
            device=self.device, device_ops=self._pool_ops())

    def new_caches(self, batch: int):
        """(target, draft) caches of ``max_seq + num_draft + 1`` columns:
        a round writes K+1 positions past the valid length before the
        rollback trims it (``KVCache.create`` pads to 8 on top)."""
        cap = self.max_seq + self.num_draft + 1
        return (self._cache(self.cfg, batch, cap),
                self._cache(self.draft_cfg, batch, cap))

    def _new_state(self, batch: int) -> RoundState:
        st = RoundState(batch, self.num_draft, self.device)
        st.tcache, st.dcache = self.new_caches(batch)
        return st

    def _prefill(self, prompt, ids, st: RoundState):
        """Both models' prompt prefill: the target's through its prefix
        pool, the draft's always over the full prompt (whole, or in its
        own chunks; its last logits are not needed)."""
        tc, dc = st.tcache, st.dcache
        _, logits = self._prefill_target(prompt, ids,
                                         KVCache(tc.keys, tc.values, 0))
        run_seeded_prefill(ids, KVCache(dc.keys, dc.values, 0),
                           self.prefill_chunk, self.max_seq, self._d_progs,
                           logits=False)
        return logits

    def _round(self, st: RoundState) -> None:
        """One draft/verify round on ``st``, in place: K+1 draft steps at
        the device length (the extra one inserts d_K's K/V), one target
        verify, the lockstep advance."""
        b, K = st.last.shape[0], self.num_draft
        n = self._round_start(st)
        tok, drafts, qs = st.last, [], []
        for j in range(K + 1):
            logits, _ = self._fwd_d(
                tok[:, None], KVCache(st.dcache.keys, st.dcache.values,
                                      n + j),
                (n + j).expand(b, 1), True)
            tok, q = propose_token(logits[:, 0], self.sampling, self._gen)
            drafts.append(tok)
            qs.append(q)
        q_logits = (None if self.sampling.greedy
                    else torch.stack(qs[:K], dim=1))
        self._verify(st, n, torch.stack(drafts[:K], dim=1), q_logits,
                     KVCache(st.tcache.keys, st.tcache.values, n))


class SpeculativeBackend:
    """Adapts a speculative engine to the HTTP backend surface
    (engine-style ``generate`` returning a result, acceptance stats on
    ``/stats``).  The device runs on a worker thread that holds the lock
    only at device pace; tokens cross to the client-paced generator over
    a queue, so a stalled client cannot wedge the server."""

    def __init__(self, engine):
        self.engine = engine
        self.max_seq = engine.max_seq
        self.device = engine.device
        self.mesh = engine.mesh          # closed with the server
        self.last_stats: Optional[SpecStats] = None
        self._lock = threading.Lock()   # one generation at a time

    def generate(self, prompt_ids, max_new_tokens: int, seed: int = 0):
        with self._lock:
            res, stats = self.engine.generate(prompt_ids, max_new_tokens,
                                              seed=seed)
            self.last_stats = stats
        return res

    def generate_stream(self, prompt_ids, max_new_tokens: int,
                        seed: int = 0):
        import queue as queue_mod

        q: "queue_mod.Queue" = queue_mod.Queue()
        SENTINEL = object()
        stats = SpecStats()

        def run():
            try:
                with self._lock:
                    for toks in self.engine.generate_stream(
                            prompt_ids, max_new_tokens, seed=seed,
                            stats_out=stats):
                        q.put(toks)
                    self.last_stats = stats
            except BaseException as e:     # surface in the consumer
                q.put(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join(timeout=10)

    def stats(self) -> dict:
        with self._lock:
            return {"speculative": stats_json(self.last_stats,
                                              self.engine.num_draft)}
