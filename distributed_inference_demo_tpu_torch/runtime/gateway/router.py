"""Prefix-aware request routing over the replica fleet.

The router answers ONE question per request — which replica most
likely already holds this prompt's prefix in its radix tree — using
only gateway-side state (docs/DESIGN.md §16):

- **routing-history index**: per replica, a bounded block-granular
  token-prefix index built from what the gateway itself routed there.
  Recording a prompt inserts one key per ``block_tokens``-sized prefix
  (the same granularity the replicas' radix trees match at, so the
  gateway's estimate and the replica's actual hit agree structurally);
  matching walks the prompt's block prefixes longest-first.  LRU
  bounded per replica — the index is a ROUTING HINT, not a mirror of
  the replica's cache: a dropped entry costs one hashed route, never a
  wrong answer.
- **decision**: route to the replica with the longest match at or
  above ``min_prefix_tokens`` (ties break toward the lighter replica);
  otherwise fall back to rendezvous (highest-random-weight) hashing of
  the first prefix block with BOUNDED LOAD — a hashed pick whose
  in-flight count exceeds ``load_factor`` x the fleet mean skips to
  the next candidate in rendezvous order, so one hot key cannot bury
  one replica while others idle.
- **reconciliation**: replica-reported ``dwt_kvcache_*`` stats (riding
  the registry's ``/stats`` probes) guard the estimate — a replica
  whose radix tree emptied (restart, eviction storm) gets its index
  flushed instead of attracting traffic for prefixes it no longer
  holds.  A readmitted replica is flushed the same way.
- **host-tier second chance** (docs/DESIGN.md §21): when no replica's
  device-tier index matches enough prefix, the router consults the
  demoted-prefix digests replicas publish in ``/stats`` (the tiered-KV
  host ring's newest chain digests, 64-bit-truncated).  A replica
  whose HOST tier holds the prefix promotes it back for one h2d adopt
  instead of re-prefilling — cheaper than the hash fallback's cold
  replica.  Unlike the routing-history index this is replica-REPORTED
  state (probe-fresh, capped), so it sits strictly between the prefix
  policy and the hash fallback, never above the device-tier estimate.

Everything is in-process state under one lock; the router never opens
a socket (the registry probes, the server proxies).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ...telemetry import catalog as _catalog
from ..overload import GatewayOverloaded


def _digest(key: bytes) -> int:
    return int.from_bytes(hashlib.sha1(key).digest()[:8], "big")


class RouteDecision:
    """Why a request went where it went (surfaced on /debugz and in
    trace span args)."""

    __slots__ = ("rid", "policy", "match_tokens", "candidates")

    def __init__(self, rid: str, policy: str, match_tokens: int,
                 candidates: List[str]):
        self.rid = rid
        self.policy = policy            # "prefix" | "host_tier" | "hash"
        self.match_tokens = match_tokens
        # alternates for retry-before-first-token, preference order
        self.candidates = candidates


class PrefixAwareRouter:
    """Cache-aware routing with consistent-hash fallback (see module
    docstring)."""

    def __init__(self, registry, *, min_prefix_tokens: int = 16,
                 block_tokens: int = 16, max_index_entries: int = 4096,
                 max_key_tokens: int = 512, load_factor: float = 2.0,
                 prefill_token_weight: int = 256,
                 spec_token_weight: int = 256):
        if min_prefix_tokens < 1:
            raise ValueError("min_prefix_tokens must be >= 1")
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        if prefill_token_weight < 0:
            raise ValueError("prefill_token_weight must be >= 0")
        if spec_token_weight < 0:
            raise ValueError("spec_token_weight must be >= 0")
        self.registry = registry
        self.min_prefix_tokens = min_prefix_tokens
        self.block_tokens = block_tokens
        self.max_index_entries = max_index_entries
        self.max_key_tokens = max_key_tokens
        self.load_factor = load_factor
        # prefill-backlog weighting: N pending prompt tokens count as
        # one queued request in the bounded-load check (0 = ignore the
        # backlog: depth-only load)
        self.prefill_token_weight = prefill_token_weight
        # speculative-backlog weighting (docs/DESIGN.md §22): the same
        # scale for the replica-reported Σ (K_row + 1) · decode_block
        # per-iteration spec spend — a replica mid-speculation has less
        # budget headroom than its queue depth shows (0 = ignore)
        self.spec_token_weight = spec_token_weight
        self._lock = threading.Lock()
        # rid -> OrderedDict[prefix-key-bytes, n_tokens] (LRU: move on
        # touch, evict oldest past the cap)
        self._index: Dict[str, "OrderedDict[bytes, int]"] = {}
        self._inflight: Dict[str, int] = {}
        self._routed: Dict[str, int] = {}
        self._prefix_hits: Dict[str, int] = {}
        # last replica-reported radix occupancy, for reconciliation
        self._replica_nodes: Dict[str, int] = {}
        # last replica-reported demoted-prefix digest (§21 host tier):
        # rid -> {"block_tokens": int, "digests": frozenset of 64-bit
        # hex strings} — replica-owned truth, replaced wholesale on
        # every /stats probe, so it never needs LRU bookkeeping here
        self._tier_index: Dict[str, dict] = {}
        registry.on_readmit = self.flush_replica
        registry.on_stats = self.reconcile

    # -- index plumbing ----------------------------------------------------

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[bytes, int]]:
        """Block-granular prefix keys for ``tokens``: one ``(digest,
        n_tokens)`` per whole leading block, longest first, capped at
        ``max_key_tokens``."""
        toks = [int(t) for t in tokens[:self.max_key_tokens]]
        bt = self.block_tokens
        out = []
        h = hashlib.sha1()
        bound = (len(toks) // bt) * bt
        # build incrementally (one pass), then reverse for longest-first
        pos = 0
        for end in range(bt, bound + 1, bt):
            for t in toks[pos:end]:
                h.update(t.to_bytes(8, "big", signed=True))
            pos = end
            out.append((h.digest(), end))
        out.reverse()
        return out

    def record(self, rid: str, tokens: Sequence[int]) -> None:
        """Learn that ``tokens`` was served by ``rid`` (called after a
        successful proxy: the replica now holds the prefix)."""
        keys = self._keys(tokens)
        if not keys:
            return
        with self._lock:
            idx = self._index.setdefault(rid, OrderedDict())
            # shortest-first so the LONGEST (most specific) keys are the
            # newest entries and survive the LRU trim below
            for key, n in reversed(keys):
                if key in idx:
                    idx.move_to_end(key)
                else:
                    idx[key] = n
            while len(idx) > self.max_index_entries:
                idx.popitem(last=False)
            n_entries = len(idx)
        _catalog.GATEWAY_INDEX_ENTRIES.set(n_entries, replica=rid)

    def match_tokens(self, rid: str, tokens: Sequence[int]) -> int:
        """Longest indexed prefix of ``tokens`` on ``rid``, in tokens."""
        with self._lock:
            idx = self._index.get(rid)
            if not idx:
                return 0
            for key, n in self._keys(tokens):
                if key in idx:
                    idx.move_to_end(key)
                    return n
        return 0

    def tier_match_tokens(self, rid: str, tokens: Sequence[int]) -> int:
        """Longest prefix of ``tokens`` whose chain digest appears in
        ``rid``'s reported demoted-prefix digest, in tokens.

        Recomputed at the REPLICA's block granularity (its pool may run
        a different ``block_tokens`` than the router default) with the
        replica's 64-bit truncation — byte-compatible with
        ``kvcache.tiered.chain_digests`` / ``TieredKVStore.digest()``.
        Deepest boundary wins; the run needn't be contiguous here (the
        replica's promote walks contiguity itself; a gap just means a
        shorter actual promote — a hint being optimistic is fine)."""
        with self._lock:
            info = self._tier_index.get(rid)
        if not info:
            return 0
        bt = info["block_tokens"]
        digests = info["digests"]
        toks = [int(t) for t in tokens[:self.max_key_tokens]]
        best = 0
        h = hashlib.sha1()
        pos = 0
        for end in range(bt, (len(toks) // bt) * bt + 1, bt):
            for t in toks[pos:end]:
                h.update(t.to_bytes(8, "big", signed=True))
            pos = end
            if h.hexdigest()[:16] in digests:
                best = end
        return best

    def flush_replica(self, rid: str) -> None:
        """Drop the routing history for ``rid`` (readmission after an
        outage: its cache state is unknown — re-learn from scratch)."""
        with self._lock:
            self._index.pop(rid, None)
            self._replica_nodes.pop(rid, None)
            self._tier_index.pop(rid, None)
        _catalog.GATEWAY_INDEX_ENTRIES.set(0, replica=rid)

    def reconcile(self, rid: str, stats: dict) -> None:
        """Guard the estimate against replica-side cache resets: if the
        replica's reported radix tree shrank to (near) nothing while
        the gateway still holds history for it, flush the history —
        routing on prefixes the replica evicted would send traffic to
        a cold cache on purpose."""
        kv = stats.get("kvcache") or {}
        tier = kv.get("tier") or {}
        digests = tier.get("digest")
        if digests is not None:
            bt = int(tier.get("block_tokens", self.block_tokens))
            with self._lock:
                if digests:
                    self._tier_index[rid] = {
                        "block_tokens": max(1, bt),
                        "digests": frozenset(str(d) for d in digests)}
                else:
                    # empty digest = nothing demoted (or tier closed):
                    # stop second-chancing onto this replica
                    self._tier_index.pop(rid, None)
        nodes = kv.get("nodes", kv.get("tree_nodes"))
        if nodes is None:
            return
        nodes = int(nodes)
        with self._lock:
            prev = self._replica_nodes.get(rid)
            self._replica_nodes[rid] = nodes
            has_history = bool(self._index.get(rid))
        if (has_history and prev is not None and nodes == 0 and prev > 0):
            self.flush_replica(rid)
            self._replica_nodes[rid] = nodes

    # -- load accounting ---------------------------------------------------

    def acquire(self, rid: str) -> None:
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1

    def release(self, rid: str) -> None:
        with self._lock:
            self._inflight[rid] = max(0, self._inflight.get(rid, 0) - 1)

    def _load(self, rid: str) -> float:
        """In-flight proxies plus the replica's last reported queue
        depth — the gateway's own concurrency signal reacts instantly,
        the probed depth covers traffic from other gateways — plus the
        reported prefill backlog scaled to request units: two replicas
        at equal depth are NOT equally loaded when one still has tens
        of thousands of prompt tokens to chew through before its queue
        moves (docs/DESIGN.md §19)."""
        load = (self._inflight.get(rid, 0)
                + self.registry.queue_depth(rid))
        if self.prefill_token_weight:
            load += (self.registry.pending_prefill_tokens(rid)
                     / float(self.prefill_token_weight))
        if self.spec_token_weight:
            # spec backlog (§22): speculating rows eat the replica's
            # per-iteration token budget the same way a prefill backlog
            # does — fold it in at its own scale
            load += (self.registry.spec_backlog_tokens(rid)
                     / float(self.spec_token_weight))
        return load

    # -- the decision ------------------------------------------------------

    def route(self, tokens: Optional[Sequence[int]]) -> RouteDecision:
        """Pick a replica for ``tokens`` (None/empty = no routing key:
        straight to the hash fallback with an empty key).  Raises
        :class:`GatewayOverloaded` when no replica is admitted."""
        ups = self.registry.routable_replicas()
        if not ups:
            raise GatewayOverloaded(
                "no replica is admitted to routing (all evicted by the "
                "health debounce or draining)", retry_after_s=2.0)
        toks = list(tokens) if tokens is not None else []

        best_rid, best_len = None, 0
        with self._lock:
            loads = {rid: self._inflight.get(rid, 0) for rid in ups}
        for rid in ups:
            n = self.match_tokens(rid, toks)
            if n > best_len or (n == best_len and n > 0 and best_rid
                                and loads[rid] < loads[best_rid]):
                best_rid, best_len = rid, n

        # rendezvous order over the first prefix block: stable under
        # membership churn (only keys owned by a removed replica move)
        key = b"".join(int(t).to_bytes(8, "big", signed=True)
                       for t in toks[:self.block_tokens])
        ranked = sorted(
            ups, key=lambda rid: _digest(key + rid.encode()), reverse=True)

        # host-tier second chance: no device-tier estimate is good
        # enough, but some replica REPORTS the prefix demoted in its
        # host ring — promotion beats the hash pick's re-prefill
        tier_rid, tier_len = None, 0
        if best_len < self.min_prefix_tokens and toks:
            for rid in ups:
                n = self.tier_match_tokens(rid, toks)
                if n > tier_len or (n == tier_len and n > 0 and tier_rid
                                    and loads[rid] < loads[tier_rid]):
                    tier_rid, tier_len = rid, n

        if best_rid is not None and best_len >= self.min_prefix_tokens:
            chosen, policy, match = best_rid, "prefix", best_len
            _catalog.GATEWAY_PREFIX_ROUTED.inc()
        elif tier_rid is not None and tier_len >= self.min_prefix_tokens:
            chosen, policy, match = tier_rid, "host_tier", tier_len
            _catalog.GATEWAY_TIER_ROUTED.inc()
        else:
            chosen, policy, match = ranked[0], "hash", 0
            # bounded load: a hashed pick may be busy while the fleet
            # idles — skip down the rendezvous order past overloaded
            # candidates (never past the last one: SOME replica serves)
            with self._lock:
                mean = (sum(self._load(r) for r in ups) / len(ups))
                bound = self.load_factor * (1.0 + mean)
                for rid in ranked:
                    if self._load(rid) <= bound:
                        chosen = rid
                        break
            _catalog.GATEWAY_HASHED.inc()

        with self._lock:
            self._routed[chosen] = self._routed.get(chosen, 0) + 1
            if policy == "prefix":
                self._prefix_hits[chosen] = (
                    self._prefix_hits.get(chosen, 0) + 1)
            routed = self._routed[chosen]
            hits = self._prefix_hits.get(chosen, 0)
        _catalog.GATEWAY_PREFIX_HIT_RATIO.set(
            hits / routed if routed else 0.0, replica=chosen)

        alternates = [r for r in ranked if r != chosen]
        return RouteDecision(chosen, policy, match, alternates)

    # -- introspection -----------------------------------------------------

    def routing_table(self) -> dict:
        """The /debugz dump: per-replica index occupancy + decision
        counters (bounded: sizes and counts, never the keys)."""
        with self._lock:
            rids = set(self._index) | set(self._routed) | set(
                self.registry.replica_ids())
            return {
                "min_prefix_tokens": self.min_prefix_tokens,
                "block_tokens": self.block_tokens,
                "load_factor": self.load_factor,
                "prefill_token_weight": self.prefill_token_weight,
                "spec_token_weight": self.spec_token_weight,
                "replicas": {
                    rid: {
                        "up": self.registry.is_up(rid),
                        "draining": self.registry.is_draining(rid),
                        "index_entries": len(self._index.get(rid, ())),
                        "routed": self._routed.get(rid, 0),
                        "prefix_routed": self._prefix_hits.get(rid, 0),
                        "inflight": self._inflight.get(rid, 0),
                        "pending_prefill_tokens":
                            self.registry.pending_prefill_tokens(rid),
                        "spec_backlog_tokens":
                            self.registry.spec_backlog_tokens(rid),
                        "replica_tree_nodes":
                            self._replica_nodes.get(rid),
                        "tier_digest_entries": len(
                            (self._tier_index.get(rid) or {})
                            .get("digests", ())),
                    } for rid in sorted(rids)},
            }
