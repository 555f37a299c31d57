"""Radix tree over token BLOCKS: longest-partial-prefix match for KV reuse.

The tree the manager walks (SGLang's RadixAttention structure, block-
granular like vLLM's prefix hash): every edge is labeled with a run of
block keys — each key the tuple of ``block_tokens`` token ids that block
covers — and carries the pool block ids holding that run's K/V.  A
lookup therefore returns the longest run of WHOLE cached blocks agreeing
with a new prompt's head, which is exactly the set of positions whose KV
can be reused verbatim (causal attention: a prefix's KV depends only on
the prefix).  Unlike the full-prompt LRU this replaces, a hit can land
mid-prompt — shorter than any stored prompt, shorter than the new one.

Concurrency/lifetime rules (the "copy-on-write lease" contract):

- Stored blocks are IMMUTABLE: the store path only ever writes freshly
  allocated blocks, readers copy block data out into their own cache
  rows.  Writers never touch a visible block, so sharing needs no
  versioning — only a guarantee that eviction cannot free a block while
  a reader is copying it.
- That guarantee is the refcount: ``acquire`` pins a node (and,
  transitively, its ancestors — eviction only removes CHILDLESS nodes,
  and a pinned node keeps the chain above it non-childless).  ``release``
  unpins.  Eviction skips any node with ``refs > 0``.
- Eviction is LRU over evictable leaves (childless, unpinned), whole
  nodes at a time; node splits during insert keep block identity, so an
  interior split never copies or frees K/V.

Pure host-side bookkeeping — the tree never touches numpy data; it maps
block keys to pool block ids and owns their lifetime.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

BlockKey = Tuple[int, ...]          # the block's token ids, len block_tokens


class RadixNode:
    __slots__ = ("keys", "blocks", "children", "parent", "refs",
                 "last_use")

    def __init__(self, keys: List[BlockKey], blocks: List[int],
                 parent: Optional["RadixNode"]):
        self.keys = keys            # per-block token tuples along this edge
        self.blocks = blocks        # pool block ids, len == len(keys)
        self.children: Dict[BlockKey, RadixNode] = {}
        self.parent = parent
        self.refs = 0               # live leases pinning this node
        self.last_use = 0           # LRU clock tick

    def is_root(self) -> bool:
        return self.parent is None


class RadixTree:
    """Block-keyed radix tree with refcounted nodes and LRU leaf eviction."""

    def __init__(self):
        self.root = RadixNode([], [], None)
        self._clock = itertools.count(1)
        self.node_count = 1         # incl. root
        self.block_count = 0        # blocks referenced by the tree

    # ------------------------------------------------------------------
    # lookup

    def match(self, keys: List[BlockKey], touch: bool = True):
        """Longest whole-block prefix of ``keys`` present in the tree.

        Returns ``(block_ids, node)``: the matched pool blocks in order
        and the node holding the LAST matched block (the root for a
        0-block match).  Touches the LRU clock along the path unless
        ``touch=False`` (a pure classification peek must not perturb
        eviction order).  A match may end mid-edge — blocks within an
        edge are independent units, so no split is needed to consume
        part of one.  ONE owner of the walk: the manager's ``peek``
        rides this too.
        """
        tick = next(self._clock) if touch else None
        node, ids, i = self.root, [], 0
        if touch:
            node.last_use = tick
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            n = 0
            while (n < len(child.keys) and i + n < len(keys)
                   and child.keys[n] == keys[i + n]):
                n += 1
            ids.extend(child.blocks[:n])
            if touch:
                child.last_use = tick
            if n < len(child.keys):      # partial edge: stop inside it
                return ids, child
            node, i = child, i + n
        return ids, node

    def acquire(self, node: RadixNode) -> None:
        node.refs += 1

    def release(self, node: RadixNode) -> None:
        if node.refs <= 0:
            raise RuntimeError("release without matching acquire")
        node.refs -= 1

    # ------------------------------------------------------------------
    # insert

    def insert(self, keys: List[BlockKey], alloc) -> Tuple[int, int]:
        """Ensure ``keys`` is present, allocating missing blocks.

        ``alloc(block_index)`` is called once per MISSING block (in
        order) and must return a pool block id — after filling it with
        that block's K/V — or None to stop (pool exhausted and nothing
        evictable); a stored proper prefix is still a valid cache entry.

        Returns ``(n_existing, n_added)`` in blocks.
        """
        tick = next(self._clock)
        node, i = self.root, 0
        node.last_use = tick
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            n = 0
            while (n < len(child.keys) and i + n < len(keys)
                   and child.keys[n] == keys[i + n]):
                n += 1
            child.last_use = tick
            if n < len(child.keys):
                if i + n == len(keys):
                    # new sequence ends inside the edge: nothing to add
                    # (the edge's tail blocks simply extend past it)
                    return len(keys), 0
                # diverges mid-edge: split so the new tail can branch
                child = self._split(child, n)
                child.last_use = tick
                node, i = child, i + n
                break
            node, i = child, i + n
        n_existing, added = i, []
        # pin the attach node: ``alloc`` may evict under pool pressure,
        # and the LRU victim (or a post-evict chain merge) must never be
        # the node we are about to hang the new edge off
        node.refs += 1
        try:
            for j in range(i, len(keys)):
                bid = alloc(j)
                if bid is None:
                    break
                added.append((keys[j], bid))
        finally:
            node.refs -= 1
        if added:
            new = RadixNode([k for k, _ in added], [b for _, b in added],
                            node)
            new.last_use = tick
            node.children[added[0][0]] = new
            self.node_count += 1
            self.block_count += len(added)
        return n_existing, len(added)

    def _split(self, node: RadixNode, n: int) -> RadixNode:
        """Split ``node``'s edge after its first ``n`` blocks; returns the
        new upper node.  Pure relabeling: block ids move, K/V doesn't."""
        upper = RadixNode(node.keys[:n], node.blocks[:n], node.parent)
        upper.last_use = node.last_use
        node.parent.children[upper.keys[0]] = upper
        node.keys, node.blocks = node.keys[n:], node.blocks[n:]
        node.parent = upper
        upper.children[node.keys[0]] = node
        # a lease pinned to the lower node keeps protecting every block
        # it matched: its ancestors (upper included) now have children
        self.node_count += 1
        return upper

    # ------------------------------------------------------------------
    # eviction

    def evictable_leaves(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (not node.is_root() and not node.children
                    and node.refs == 0):
                out.append(node)
        return out

    def evict_lru_leaf(self) -> List[int]:
        """Remove the least-recently-used evictable leaf; returns its
        pool block ids (for the caller to free), or [] when nothing is
        evictable (every leaf is leased)."""
        return self.evict_lru_leaf_entry()[1]

    def evict_lru_leaf_entry(self) -> Tuple[List[BlockKey], List[int]]:
        """Like :meth:`evict_lru_leaf`, but also returns the victim's
        FULL root-to-leaf key path (ancestor edge keys + its own) — the
        tier-demotion hook keys the freed blocks by their chain digest,
        which covers every preceding block, not just the leaf's edge.
        The path's last ``len(blocks)`` keys label the returned blocks.
        Returns ``([], [])`` when nothing is evictable."""
        leaves = self.evictable_leaves()
        if not leaves:
            return [], []
        victim = min(leaves, key=lambda n: n.last_use)
        parent = victim.parent
        path: List[BlockKey] = list(victim.keys)
        node = parent
        while node is not None:
            path = list(node.keys) + path
            node = node.parent
        del parent.children[victim.keys[0]]
        self.node_count -= 1
        self.block_count -= len(victim.blocks)
        # merge a now-single-child unpinned parent back into one edge so
        # repeated split/evict cycles don't accrete chain nodes
        if (not parent.is_root() and len(parent.children) == 1
                and parent.refs == 0):
            (only,) = parent.children.values()
            only.keys = parent.keys + only.keys
            only.blocks = parent.blocks + only.blocks
            only.parent = parent.parent
            parent.parent.children[only.keys[0]] = only
            only.last_use = max(only.last_use, parent.last_use)
            self.node_count -= 1
        return path, victim.blocks

    # ------------------------------------------------------------------
    # invariants (test hook)

    def check(self) -> None:
        """Structural invariants; raises AssertionError on violation."""
        seen_blocks = set()
        count, blocks = 0, 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += 1
            blocks += len(node.blocks)
            assert len(node.keys) == len(node.blocks)
            assert node.is_root() or node.keys, "empty non-root edge"
            for first, child in node.children.items():
                assert child.keys[0] == first
                assert child.parent is node
                stack.append(child)
            for bid in node.blocks:
                assert bid not in seen_blocks, "block in two nodes"
                seen_blocks.add(bid)
            assert node.refs >= 0
        assert count == self.node_count, (count, self.node_count)
        assert blocks == self.block_count, (blocks, self.block_count)
