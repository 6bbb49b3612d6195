"""Content-addressed prefix KV cache over the paged block pool.

Counterpart of ``synapseml_tpu/models/prefix_cache.py``, the same radix of
chain-hashed blocks, refcounts and metrics (host code, no device work).

Chat system prompts, RAG templates, and few-shot headers mean the token
streams hitting the paged engine share long prefixes. This module makes
filled KV pages a CONTENT-ADDRESSED asset: every full block of committed
tokens is keyed by a chain hash (``h_i = sha256(h_{i-1} || block_i
tokens)``), so a block's key commits to the whole token prefix behind it,
not just its own ``block_len`` tokens. A radix lookup is then just walking
the chain hash-by-hash until the first miss.

Sharing discipline (the allocator invariants extend to refcounts):

* the cache holds its OWN reference on every cached block
  (``BlockAllocator.ref``); a sequence that hits takes one more ref per
  shared block, so a block is physically freed only when the last holder —
  cache included — lets go;
* shared blocks are NEVER written: the engine reuses only whole blocks and
  starts its suffix prefill at the first uncached position, so the
  shared/private boundary is block-aligned. The one exception — a prompt
  whose full-block chain covers the entire context — is resolved by
  COPY-ON-WRITE: the divergence block is duplicated into a private page
  (in place, before the suffix prefill) and only the copy is written;
* eviction is LRU over LEAF entries whose block has refcount 1 (only the
  cache holds it). Interior entries are pinned by their children — evicting
  one would orphan every descendant while their refs kept the pages alive.

The engine consults :meth:`PrefixCache.evict` before preempting a live
sequence: cold cached pages are strictly cheaper to give up than recompute.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core import observability as obs

__all__ = ["PrefixCache", "chain_hash"]


_PREFIX_METRICS = obs.HandleCache(lambda reg: {
    "lookups": reg.counter(
        "synapseml_llm_prefix_lookups_total",
        "prefix-cache lookups at admit, by outcome (hit = >= 1 full block "
        "reused)", ("outcome",)),
    "reused": reg.counter(
        "synapseml_llm_prefix_tokens_reused_total",
        "prompt tokens whose prefill was skipped because their KV pages "
        "were already resident"),
    "evictions": reg.counter(
        "synapseml_llm_prefix_evictions_total",
        "cached blocks freed by LRU eviction (pool pressure)"),
    "blocks": reg.gauge(
        "synapseml_llm_prefix_blocks",
        "blocks currently pinned by the prefix cache"),
    "hit_rate": reg.gauge(
        "synapseml_llm_prefix_hit_rate",
        "cumulative fraction of admits that reused >= 1 cached block (the "
        "autoscaler's stickiness signal)"),
})


def chain_hash(parent: bytes, tokens) -> bytes:
    """``sha256(parent || int32 token bytes)`` — the per-block chain link.
    An empty ``parent`` roots the chain, so equal digests imply equal full
    token prefixes (not merely equal blocks)."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(list(tokens), np.int32).tobytes())
    return h.digest()


class _Entry:
    __slots__ = ("block", "parent", "children", "tick")

    def __init__(self, block: int, parent: bytes, tick: int):
        self.block = int(block)
        self.parent = parent
        self.children = 0
        self.tick = tick


class PrefixCache:
    """Radix of chain-hashed full blocks over a :class:`BlockAllocator`.

    Not thread-safe on its own — the owning engine serializes access under
    its scheduler lock, exactly as it does for the allocator."""

    def __init__(self, allocator, block_len: int):
        self.allocator = allocator
        self.block_len = int(block_len)
        self._by_hash: dict[bytes, _Entry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_hash)

    @property
    def blocks(self) -> int:
        return len(self._by_hash)

    def block_ids(self) -> set[int]:
        return {e.block for e in self._by_hash.values()}

    # ------------------------------------------------------------------
    def lookup(self, token_ids) -> tuple[list[int], list[bytes]]:
        """Longest cached full-block chain prefixing ``token_ids`` ->
        (block ids, chain digests), both per matched block. Touches matched
        entries (LRU) and records the hit/miss outcome; takes NO references
        — the caller refs each block it actually keeps."""
        bl = self.block_len
        self._tick += 1
        blocks: list[int] = []
        digests: list[bytes] = []
        h = b""
        for i in range(len(token_ids) // bl):
            h = chain_hash(h, token_ids[i * bl:(i + 1) * bl])
            entry = self._by_hash.get(h)
            if entry is None:
                break
            entry.tick = self._tick
            blocks.append(entry.block)
            digests.append(h)
        m = _PREFIX_METRICS.get()
        if blocks:
            self.hits += 1
            m["lookups"].inc(outcome="hit")
        else:
            self.misses += 1
            m["lookups"].inc(outcome="miss")
        self._publish()
        return blocks, digests

    def note_reused(self, n_tokens: int) -> None:
        """Record the tokens ACTUALLY reused after the engine's caps (whole
        blocks, and always leaving >= 1 token to prefill)."""
        if n_tokens > 0:
            self.tokens_reused += int(n_tokens)
            _PREFIX_METRICS.get()["reused"].inc(int(n_tokens))

    def insert(self, parent: bytes, block_tokens, block: int) -> bytes:
        """Register one FULL block of committed tokens whose chain parent
        digest is ``parent``; returns the block's chain digest. Idempotent:
        an existing entry for the same token chain is touched, not
        duplicated (the caller's block stays private — content dedup, not
        pointer swap). A new entry takes the cache's own reference on
        ``block``, so the pages outlive the sequence that filled them."""
        h = chain_hash(parent, block_tokens)
        self._tick += 1
        entry = self._by_hash.get(h)
        if entry is not None:
            entry.tick = self._tick
            return h
        self.allocator.ref(block)
        self._by_hash[h] = _Entry(block, parent, self._tick)
        pe = self._by_hash.get(parent)
        if pe is not None:
            pe.children += 1
        self._publish()
        return h

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached blocks, LRU-first, restricted to
        LEAF entries (no children) whose block only the cache holds
        (refcount 1). Cascades: a parent whose last child is evicted
        becomes a leaf and is itself eligible. Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            victim_h, victim = None, None
            for h, e in self._by_hash.items():
                if e.children:
                    continue
                if self.allocator.refcount(e.block) != 1:
                    continue  # a live sequence still shares these pages
                if victim is None or e.tick < victim.tick:
                    victim_h, victim = h, e
            if victim is None:
                break
            del self._by_hash[victim_h]
            pe = self._by_hash.get(victim.parent)
            if pe is not None:
                pe.children -= 1
            self.allocator.free([victim.block])
            self.evictions += 1
            freed += 1
        if freed:
            m = _PREFIX_METRICS.get()
            m["evictions"].inc(freed)
            self._publish()
        return freed

    def clear(self) -> int:
        """Drop every entry (releasing the cache's refs) — the hot-swap /
        release path. Returns entries dropped."""
        n = len(self._by_hash)
        for e in self._by_hash.values():
            self.allocator.free([e.block])
        self._by_hash.clear()
        self._publish()
        return n

    # ------------------------------------------------------------------
    def _publish(self) -> None:
        m = _PREFIX_METRICS.get()
        m["blocks"].labels().set(float(len(self._by_hash)))
        total = self.hits + self.misses
        m["hit_rate"].labels().set(self.hits / total if total else 0.0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._by_hash),
                "blocks": len(self._by_hash),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "tokens_reused": self.tokens_reused,
                "evictions": self.evictions}
