"""Tiered KV: a host-RAM/disk capacity tier BELOW the device page pool.

The paged pool (``paged.py``) holds exactly ``num_blocks`` pages of HBM;
under pressure, LRU leaf eviction frees pages — and before this module,
an evicted prefix was simply gone: the next request sharing it paid a
full re-prefill.  CachedAttention (USENIX ATC '24, arXiv:2403.19708)
shows the fix for a fleet serving far more reusable prefix state than
HBM can hold: DEMOTE evicted KV blocks into a host-RAM ring (with an
optional mmap'd disk segment below it) and PROMOTE them back on reuse —
a prefix re-prefill becomes one h2d adopt scatter.

Design (docs/DESIGN.md §21):

- **keying**: entries are keyed per block by the CHAIN DIGEST — an
  incremental sha1 over the raw token ids (8-byte big-endian signed per
  token), read out at each ``block_tokens`` boundary.  This is exactly
  the gateway router's ``_keys`` scheme, so a replica's demoted-prefix
  digest is directly comparable gateway-side (the tier-aware
  second-chance route) with no token data leaving the replica.
- **demotion**: the manager's eviction loop hands each victim leaf's
  full key path + freed page ids to a hook; the owner (engine/backend)
  gathers the pages' bytes with :func:`~.device.export_blocks_from_pages`
  — quantized pools export their narrow int8/int4 leaves + scale
  sidecars VERBATIM, so the host copy is as cheap as §17 made the pages
  — and inserts them here.  Demotion happens before the freed ids are
  handed back out, so the d2h gather can never read recycled pages.
- **promotion**: :func:`promote_prefix` runs at admission, between the
  staged-import and the radix ``match``: peek the device-covered prefix,
  walk the chain from there, adopt the tier's continuation through the
  SAME :func:`~.device.adopt_blocks_into_pages` scatter the §15/§18
  migration paths use (no second h2d path), then ``store_shared`` hands
  the pages to the tree — the admission's own ``match`` finds them as
  an ordinary prefix hit.  Promotion is move-semantics (the entry
  leaves the tier) and best-effort: alloc pressure skips it.
- **tiers**: one LRU ring (ordered dict) spans both tiers.  The host
  ring is byte-budgeted; overflow spills the oldest host entries into
  the disk segment (fixed-size slots over one mmap'd file) when
  configured, else drops them.  Disk overflow drops oldest.  All blocks
  of a config are the same size, so disk slots never fragment.

Accounting is exact and assertable (:meth:`TieredKVStore.check`): every
entry is host-resident XOR disk-resident, byte sums match the ledger,
and the h2d bytes a promotion moves are counted honestly into the
manager's ``h2d_bytes`` (``dwt_kvcache_h2d_bytes_total`` — the paged
layout's "0 by construction" claim becomes "0 except honest tier
promotions") plus the ``dwt_kvcache_tier_*`` family.

Counterpart of ``distributed_inference_demo_tpu/runtime/kvcache/
tiered.py``.  The bookkeeping is the reference's; the payloads are torch
tensors: a demotion copies the exported leaves to the host (the copy
waits for the export gather queued before it), the host ring keeps them
as CPU tensors of their own dtype (bf16, float8 e4m3 bytes, int8 / int4
codes and their f32 scales), the disk segment stores their bytes, and a
promotion moves the stacked leaves back to the pool's device and adopts
them through the same :func:`~.device.adopt_blocks_into_pages` scatter
migration uses.  Chain digests are byte-identical to the reference's.

Config knobs (CLI flags override env, 0 disables):
``DWT_KV_HOST_TIER_BYTES`` (host ring budget), ``DWT_KV_DISK_TIER_PATH``
/ ``DWT_KV_DISK_TIER_BYTES`` (optional disk segment below the ring).
"""

from __future__ import annotations

import hashlib
import mmap
import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...telemetry._env import env_int
from ...telemetry.flightrecorder import get_flight_recorder

#: newest-first cap on the demoted-prefix digest a replica publishes in
#: /stats — the gateway's second-chance index is a HINT, not a mirror;
#: a truncated digest costs one hashed route, never a wrong answer
DIGEST_CAP = 256


def _catalog():
    """The dwt_kvcache_tier_* series, resolved lazily and never fatally
    (a metrics regression must not take down eviction or admission) —
    the disagg transport's pattern."""
    try:
        from ...telemetry import catalog
        return catalog
    except Exception:           # pragma: no cover - defensive
        return None


def resolve_tier_config(host_bytes: Optional[int] = None,
                        disk_path: Optional[str] = None,
                        disk_bytes: Optional[int] = None):
    """(host_bytes, disk_path, disk_bytes) from explicit args over the
    ``DWT_KV_HOST_TIER_BYTES`` / ``DWT_KV_DISK_TIER_PATH`` /
    ``DWT_KV_DISK_TIER_BYTES`` env knobs (None = "not specified"; 0 /
    empty disables).  The env fallback is the §17 pattern: every worker
    behind ``make_kv_backend`` inherits the tier with zero plumbing."""
    if host_bytes is None:
        host_bytes = env_int("DWT_KV_HOST_TIER_BYTES", 0)
    if disk_path is None:
        disk_path = os.environ.get("DWT_KV_DISK_TIER_PATH", "") or None
    if disk_bytes is None:
        disk_bytes = env_int("DWT_KV_DISK_TIER_BYTES", 0)
    host_bytes = max(0, int(host_bytes))
    disk_bytes = max(0, int(disk_bytes))
    if disk_path is not None and disk_bytes < 1:
        disk_path = None        # a path without a budget is no segment
    if disk_path is None:
        disk_bytes = 0
    if host_bytes < 1 and disk_path is not None:
        raise ValueError(
            "the disk tier sits BELOW the host ring (entries spill "
            "host -> disk): --kv-disk-tier-path/bytes need "
            "--kv-host-tier-bytes > 0")
    return host_bytes, disk_path, disk_bytes


def chain_digests(keys: Sequence[Tuple[int, ...]]) -> List[bytes]:
    """One cumulative sha1 digest per block boundary of ``keys`` (each
    key the block's token-id tuple) — byte-compatible with the gateway
    router's ``_keys`` so replica digests and gateway lookups agree."""
    h = hashlib.sha1()
    out: List[bytes] = []
    for key in keys:
        for t in key:
            h.update(int(t).to_bytes(8, "big", signed=True))
        out.append(h.digest())
    return out


def _leaf_lists(blocks):
    """Flatten one side's (possibly quantized) block payload into a flat
    list of host tensors + page-width tag — the wire convention (bf16:
    the one tensor; int8: data+scale; int4: data+scale+zero).  The copy
    to the host waits for the device work queued before it."""
    from ...ops.quant import QuantizedKVPages
    if isinstance(blocks, QuantizedKVPages):
        leaves = [t.detach().cpu() for t in blocks.leaves()]
        return leaves, ("int4" if blocks.bits == 4 else "int8")
    return [blocks.detach().cpu()], "bf16"


def _from_leaves(leaves, kv_dtype: str):
    """Rebuild one side's block payload from its leaf list (inverse of
    :func:`_leaf_lists`)."""
    if kv_dtype == "bf16":
        return leaves[0]
    from ...ops.quant import QuantizedKVPages
    bits = 4 if kv_dtype == "int4" else 8
    zero = leaves[2] if bits == 4 else None
    return QuantizedKVPages(leaves[0], leaves[1], zero, bits)


def _raw(t: torch.Tensor) -> bytes:
    """A host tensor's bytes, whatever its dtype (float8 and bf16 have no
    numpy dtype)."""
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


class _TierEntry:
    """One demoted block: host leaf arrays, or a disk slot index."""

    __slots__ = ("tier", "k_leaves", "v_leaves", "slot", "nbytes")

    def __init__(self, k_leaves, v_leaves, nbytes: int):
        self.tier = "host"
        self.k_leaves = k_leaves
        self.v_leaves = v_leaves
        self.slot: Optional[int] = None
        self.nbytes = nbytes


class _DiskSegment:
    """Fixed-slot block store over one mmap'd file.

    Every entry of a given pool config is the same byte size (same
    shapes, same dtypes), so the segment is a trivial slot allocator:
    slot size and leaf layout are fixed by the FIRST write, capacity is
    ``budget // slot_bytes``, and a free list recycles slots.  Reads
    copy out (the mmap pages may be evicted by the OS at any time; the
    promoted arrays must own their bytes)."""

    def __init__(self, path: str, budget_bytes: int):
        self.path = path
        self.budget_bytes = int(budget_bytes)
        self._fh = open(path, "w+b")
        self._mm: Optional[mmap.mmap] = None
        self._layout = None      # [(shape, dtype_str, nbytes), ...] k++v
        self._n_k = 0            # how many leaves belong to K
        self.slot_bytes = 0
        self.capacity_slots = 0
        self._free: List[int] = []
        self._next = 0

    def _configure(self, k_leaves, v_leaves) -> None:
        layout = [(tuple(lv.shape), lv.dtype, lv.nbytes)
                  for lv in list(k_leaves) + list(v_leaves)]
        self._layout = layout
        self._n_k = len(k_leaves)
        self.slot_bytes = sum(n for _, _, n in layout)
        self.capacity_slots = (self.budget_bytes // self.slot_bytes
                               if self.slot_bytes else 0)
        if self.capacity_slots < 1:
            return
        self._fh.truncate(self.slot_bytes * self.capacity_slots)
        self._fh.flush()
        self._mm = mmap.mmap(self._fh.fileno(),
                             self.slot_bytes * self.capacity_slots)

    def write(self, k_leaves, v_leaves) -> Optional[int]:
        """Store one entry; returns its slot index, or None when the
        segment is full (or the budget fits no slot at all)."""
        if self._layout is None:
            self._configure(k_leaves, v_leaves)
        if self.capacity_slots < 1:
            return None
        if self._free:
            slot = self._free.pop()
        elif self._next < self.capacity_slots:
            slot = self._next
            self._next += 1
        else:
            return None
        off = slot * self.slot_bytes
        for lv in list(k_leaves) + list(v_leaves):
            raw = _raw(lv)
            self._mm[off:off + len(raw)] = raw
            off += len(raw)
        return slot

    def read(self, slot: int):
        """(k_leaves, v_leaves) copied OUT of the segment."""
        off = slot * self.slot_bytes
        leaves = []
        for shape, dtype, nbytes in self._layout:
            leaves.append(torch.frombuffer(
                bytearray(self._mm[off:off + nbytes]),
                dtype=torch.uint8).view(dtype).reshape(shape))
            off += nbytes
        return leaves[:self._n_k], leaves[self._n_k:]

    def free(self, slot: int) -> None:
        self._free.append(slot)

    @property
    def used_slots(self) -> int:
        return self._next - len(self._free)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if not self._fh.closed:
            self._fh.close()


class TieredKVStore:
    """Byte-budgeted host-RAM LRU ring + optional disk segment for
    demoted KV blocks (see module docstring).

    Thread-safety matches the managers: one lock; demote/promote run on
    the owning engine's scheduler thread, ``snapshot``/``digest`` from
    scrape threads."""

    def __init__(self, host_bytes: int, block_tokens: int, *,
                 disk_path: Optional[str] = None, disk_bytes: int = 0,
                 digest_cap: int = DIGEST_CAP):
        if host_bytes < 1:
            raise ValueError("TieredKVStore needs a host byte budget "
                             ">= 1 (0 means: no tier — pass None to "
                             "the engine instead)")
        self.host_budget_bytes = int(host_bytes)
        self.block_tokens = int(block_tokens)
        self.digest_cap = int(digest_cap)
        self.kv_dtype: Optional[str] = None
        self._disk = (_DiskSegment(disk_path, disk_bytes)
                      if disk_path else None)
        self.disk_budget_bytes = int(disk_bytes) if disk_path else 0
        # digest -> entry, LRU order (oldest first); one dict spans both
        # tiers so host->disk spill preserves recency order
        self._entries: "OrderedDict[bytes, _TierEntry]" = OrderedDict()
        self._host_bytes = 0
        self._disk_bytes = 0
        self._lock = threading.Lock()
        self._flight = get_flight_recorder()
        self.stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict:
        return {"demoted_blocks": 0, "demoted_bytes": 0,
                "promoted_blocks": 0, "promoted_bytes": 0,
                "dropped_blocks": 0, "spilled_blocks": 0,
                "host_hits": 0, "disk_hits": 0, "demote_errors": 0}

    # ------------------------------------------------------------------
    # demotion (eviction hook side)

    def demote(self, path_keys: Sequence[Tuple[int, ...]],
               k_blocks, v_blocks) -> int:
        """Insert the evicted leaf's blocks, keyed by the chain digests
        of ``path_keys`` (the victim's FULL root-to-leaf key path; the
        payloads cover its last ``n`` keys).  Device payloads sync d2h
        here, before the freed page ids can be recycled.  Returns the
        number of blocks admitted (duplicates refresh, not re-copy)."""
        t0 = time.perf_counter()
        k_leaves, kv_dtype = _leaf_lists(k_blocks)
        v_leaves, _ = _leaf_lists(v_blocks)
        n = int(k_leaves[0].shape[0])
        if n < 1 or len(path_keys) < n:
            return 0
        digests = chain_digests(path_keys)[len(path_keys) - n:]
        admitted, admitted_bytes = 0, 0
        with self._lock:
            self.kv_dtype = self.kv_dtype or kv_dtype
            for j, dg in enumerate(digests):
                if dg in self._entries:
                    self._entries.move_to_end(dg)
                    continue
                ek = [lv[j].clone() for lv in k_leaves]
                ev = [lv[j].clone() for lv in v_leaves]
                nbytes = sum(a.nbytes for a in ek + ev)
                self._entries[dg] = _TierEntry(ek, ev, nbytes)
                self._host_bytes += nbytes
                admitted += 1
                admitted_bytes += nbytes
            self._evict_over_budget_locked()
            self.stats["demoted_blocks"] += admitted
            self.stats["demoted_bytes"] += admitted_bytes
        dt = time.perf_counter() - t0
        cat = _catalog()
        if cat is not None and admitted:
            cat.KVCACHE_TIER_DEMOTE_SECONDS.observe(dt)
        if admitted:
            self._flight.record("kvcache_tier_demote", blocks=admitted,
                                seconds=round(dt, 6))
        return admitted

    def _evict_over_budget_locked(self) -> None:
        """Spill the oldest host entries to disk past the host budget
        (or drop them when no segment / segment full); drop the oldest
        disk entries past the disk budget."""
        while self._host_bytes > self.host_budget_bytes:
            dg = next((d for d, e in self._entries.items()
                       if e.tier == "host"), None)
            if dg is None:       # pragma: no cover - budget >= 1 entry
                break
            e = self._entries[dg]
            slot = None
            if self._disk is not None:
                # make room first: everything already on disk is OLDER
                # than the entry spilling (spill preserves LRU order),
                # so dropping oldest-disk to admit it is the correct
                # bottom-of-hierarchy eviction — without this, a full
                # segment would drop the NEWER host entry instead
                while self._disk_bytes + e.nbytes > self.disk_budget_bytes:
                    old = next((d for d, x in self._entries.items()
                                if x.tier == "disk"), None)
                    if old is None:
                        break
                    self._drop_locked(old)
                if (self._disk_bytes + e.nbytes
                        <= self.disk_budget_bytes):
                    slot = self._disk.write(e.k_leaves, e.v_leaves)
            if slot is not None:
                e.tier, e.slot = "disk", slot
                e.k_leaves = e.v_leaves = None
                self._disk_bytes += e.nbytes
                self.stats["spilled_blocks"] += 1
                # keep LRU position: a spilled entry is still older
                # than everything demoted after it
                self._host_bytes -= e.nbytes
            else:
                del self._entries[dg]
                self._host_bytes -= e.nbytes
                self.stats["dropped_blocks"] += 1
        while self._disk_bytes > self.disk_budget_bytes:
            dg = next((d for d, e in self._entries.items()
                       if e.tier == "disk"), None)
            if dg is None:       # pragma: no cover - accounting guard
                break
            self._drop_locked(dg)

    def _drop_locked(self, dg: bytes) -> None:
        e = self._entries.pop(dg)
        if e.tier == "disk":
            self._disk_bytes -= e.nbytes
            self._disk.free(e.slot)
        else:
            self._host_bytes -= e.nbytes
        self.stats["dropped_blocks"] += 1

    # ------------------------------------------------------------------
    # promotion (admission side)

    def match(self, prompt, start_blocks: int) -> List[bytes]:
        """The longest run of consecutive demoted blocks continuing the
        prompt from block index ``start_blocks`` (the device-covered
        prefix), capped below the prompt length like the managers'
        ``match``.  Returns the run's chain digests (pass to
        :meth:`take`); pure lookup, refreshes LRU recency."""
        prompt = np.asarray(prompt).reshape(-1)
        bt = self.block_tokens
        max_blocks = (len(prompt) - 1) // bt
        if start_blocks >= max_blocks:
            return []
        keys = [tuple(int(t) for t in prompt[i * bt:(i + 1) * bt])
                for i in range(max_blocks)]
        digests = chain_digests(keys)
        run: List[bytes] = []
        with self._lock:
            for dg in digests[start_blocks:]:
                e = self._entries.get(dg)
                if e is None:
                    break
                self._entries.move_to_end(dg)
                run.append(dg)
        return run

    def take(self, digests: Sequence[bytes]):
        """Remove ``digests``' entries (move semantics: a promoted block
        lives in the device tree afterwards, not here) and assemble
        their payloads, stopping at the first hole.

        Returns ``(k_blocks, v_blocks, nbytes, n)`` with block-leading
        ``[n, ...]`` leaves ready for ``adopt_blocks_into_pages``
        (quantized entries rebuild their QuantizedKVPages tree, adopted
        VERBATIM), or None when nothing could be taken."""
        taken: List[_TierEntry] = []
        with self._lock:
            for dg in digests:
                e = self._entries.get(dg)
                if e is None:
                    break
                if e.tier == "disk":
                    e.k_leaves, e.v_leaves = self._disk.read(e.slot)
                    self._disk.free(e.slot)
                    self._disk_bytes -= e.nbytes
                    self.stats["disk_hits"] += 1
                else:
                    self._host_bytes -= e.nbytes
                    self.stats["host_hits"] += 1
                del self._entries[dg]
                taken.append(e)
        if not taken:
            return None
        k_leaves = [torch.stack([e.k_leaves[i] for e in taken])
                    for i in range(len(taken[0].k_leaves))]
        v_leaves = [torch.stack([e.v_leaves[i] for e in taken])
                    for i in range(len(taken[0].v_leaves))]
        nbytes = sum(e.nbytes for e in taken)
        kv_dtype = self.kv_dtype or "bf16"
        return (_from_leaves(k_leaves, kv_dtype),
                _from_leaves(v_leaves, kv_dtype), nbytes, len(taken))

    def note_promoted(self, blocks: int, nbytes: int,
                      seconds: float) -> None:
        """Account one completed promotion (called by the owner after
        the adopt scatter dispatched — the h2d actually happened)."""
        with self._lock:
            self.stats["promoted_blocks"] += blocks
            self.stats["promoted_bytes"] += nbytes
        cat = _catalog()
        if cat is not None:
            cat.KVCACHE_TIER_PROMOTE_SECONDS.observe(seconds)
        self._flight.record("kvcache_tier_promote", blocks=blocks,
                            bytes=nbytes, seconds=round(seconds, 6))

    # ------------------------------------------------------------------
    # introspection

    @property
    def host_resident_bytes(self) -> int:
        return self._host_bytes

    def snapshot(self) -> dict:
        with self._lock:
            host_blocks = sum(1 for e in self._entries.values()
                              if e.tier == "host")
            return dict(self.stats,
                        block_tokens=self.block_tokens,
                        host_resident_bytes=self._host_bytes,
                        host_capacity_bytes=self.host_budget_bytes,
                        host_blocks=host_blocks,
                        disk_resident_bytes=self._disk_bytes,
                        disk_capacity_bytes=self.disk_budget_bytes,
                        disk_blocks=len(self._entries) - host_blocks)

    def digest(self) -> dict:
        """The compact demoted-prefix digest a replica publishes in
        ``/stats`` for the gateway's second-chance lookup: the NEWEST
        ``digest_cap`` entries' chain digests (truncated to 64-bit hex —
        a routing hint tolerates collisions; 10x smaller probes don't),
        plus the block granularity the gateway must recompute at."""
        with self._lock:
            newest = list(self._entries.keys())[-self.digest_cap:]
        return {"block_tokens": self.block_tokens,
                "digests": [d.hex()[:16] for d in newest]}

    def reset_stats(self) -> None:
        with self._lock:
            self.stats = self._zero_stats()

    def check(self) -> None:
        """Accounting invariants (test hook): every entry host XOR disk,
        ledger byte sums exact, disk free list consistent."""
        with self._lock:
            host = [e for e in self._entries.values() if e.tier == "host"]
            disk = [e for e in self._entries.values() if e.tier == "disk"]
            assert all(e.k_leaves is not None for e in host)
            assert all(e.slot is not None and e.k_leaves is None
                       for e in disk)
            assert self._host_bytes == sum(e.nbytes for e in host), \
                (self._host_bytes, sum(e.nbytes for e in host))
            assert self._disk_bytes == sum(e.nbytes for e in disk), \
                (self._disk_bytes, sum(e.nbytes for e in disk))
            if self._disk is not None:
                assert self._disk.used_slots == len(disk), \
                    (self._disk.used_slots, len(disk))

    def close(self) -> None:
        with self._lock:
            self._entries.clear()
            self._host_bytes = self._disk_bytes = 0
            if self._disk is not None:
                self._disk.close()


# ---------------------------------------------------------------------------
# the promotion seam, shared by the batching engine and PagedKVBackend


def make_demote_hook(tier: TieredKVStore, get_pools, ops=None):
    """The eviction-side hook a pool owner installs on its
    :class:`~.paged.PagedKVCacheManager`: gather the victim leaf's
    pages (one device gather, quantized leaves verbatim — the export
    seam) and demote them.  ``get_pools()`` returns the owner's current
    ``(pk, pv)``; over a tp mesh they are rank 0's planes, ``ops`` is
    the pool's ``parallel.tensor.TPPoolOps``, and the export gathers
    every rank's heads (``device.export_blocks_from_pages``), so an
    entry holds the tp=1 layout.  Never raises into ``alloc``: a
    demotion failure costs cache capacity, not admission."""
    def hook(path_keys, block_ids) -> None:
        try:
            from .device import export_blocks_from_pages
            pk, pv = get_pools()
            kb, vb = export_blocks_from_pages(
                pk, pv, np.asarray(block_ids, np.int64), ops=ops)
            tier.demote(path_keys, kb, vb)
        except Exception:
            with tier._lock:
                tier.stats["demote_errors"] += 1
            tier._flight.record("kvcache_tier_demote_error",
                                blocks=len(block_ids))
    return hook


def promote_prefix(mgr, tier: TieredKVStore, pk, pv, prompt,
                   profiler=None, ops=None):
    """Promote the tier's continuation of ``prompt``'s device-covered
    prefix back into the page pool — the admission-side seam, run
    BEFORE the manager's ``match`` so the promoted blocks land as an
    ordinary prefix hit.

    Mirrors the staged-import dance exactly (alloc -> adopt scatter
    -> ``store_shared`` with None placeholders for the device-covered
    head -> free declined -> release lease); the adopt h2d bytes are
    counted into the manager's ``h2d_bytes`` and the tier's promoted
    counters.  Best-effort by design: pool pressure (alloc infeasible)
    or a racing eviction just skips — the suffix prefills.  The pools
    are written in place; over a tp mesh (``ops``, the pool's
    ``parallel.tensor.TPPoolOps``) each rank adopts its own kv heads of
    the entry (``device.adopt_blocks_into_pages``).

    Returns ``(pk, pv, promoted_tokens)``."""
    from .device import adopt_blocks_into_pages, payload_to, staging_device
    run = tier.match(prompt, mgr.peek(prompt) // mgr.block_tokens)
    if not run:
        return pk, pv, 0
    ids = mgr.alloc(len(run))
    if ids is None:
        return pk, pv, 0
    t0 = time.perf_counter()
    # the alloc above may itself have evicted (and demoted) tree leaves
    # — never the run's entries (they are host-side), but the device
    # coverage may have SHRUNK: re-peek so the placeholder head matches
    # the tree's current state; a stale, larger head would make
    # store_shared stop early, which is correct but wastes the adopt
    start = mgr.peek(prompt) // mgr.block_tokens
    payload = tier.take(run)
    if payload is None:
        mgr.free(ids)
        return pk, pv, 0
    k_blocks, v_blocks, nbytes, n = payload
    if n < len(ids):
        mgr.free(ids[n:])
        ids = ids[:n]
    bt = mgr.block_tokens
    device = staging_device(pk, ops)
    sig = None
    if profiler is not None:
        from ...telemetry import profiling as _profiling
        sig = _profiling.dispatch_signature(
            "tier_promote", batch=n, chunk=bt, kv_dtype=mgr.kv_dtype)
        _pt0 = profiler.begin(sig)
    adopt_blocks_into_pages(pk, pv, payload_to(k_blocks, device),
                            payload_to(v_blocks, device),
                            np.asarray(ids, np.int64), ops=ops)
    if sig is not None:
        profiler.end(sig, _pt0, out=(pk, pv), hbm_bytes=nbytes)
    adopted, lease = mgr.store_shared(
        np.asarray(prompt).reshape(-1)[:(start + n) * bt],
        [None] * start + list(ids))
    adopted_set = set(adopted)
    leftovers = [b for b in ids if b not in adopted_set]
    if leftovers:
        mgr.free(leftovers)
    if lease is not None:
        lease.release()
    mgr.note_promote_h2d(nbytes)
    tier.note_promoted(len(adopted), nbytes, time.perf_counter() - t0)
    return pk, pv, len(adopted) * bt
