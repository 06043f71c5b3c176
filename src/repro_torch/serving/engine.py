"""Cloud execution engine: slot-based continuous batching (port of
``repro/serving/engine.py``, dense and paged caches).

The engine is *mechanism only*: it owns the KV cache and exposes ``feed``
(chunked partial prefill over any slots), ``prefill`` and ``decode``.
All batching *policy* lives in ``serving/scheduler.py`` (Algorithm 1 of
the paper).

Device-residency contract, as in the reference:

* Full-vocab logits never leave the device on verify/decode iterations:
  the steps carry the fused verification epilogue
  (``models/steps.fused_verify_epilogue``), so ``feed`` returns (slots,
  R) ids plus (slots, R, K) sparse rows and ``decode`` returns (slots,)
  ids plus (slots, K) rows.
* ``prefill`` additionally fetches ONE full-vocab row per slot (the last
  prompt position), which seeds the sampling verifier's pre-draft row.
* The cache is updated in place by every step; ``reset_slot`` marks a
  slot's positions invalid (paged: returns its blocks to the pool).
* ``feed_logits`` / ``decode_logits`` are the legacy/debug path that
  round-trips the full (slots, chunk, V) tensor.

Ragged per-slot chunks are padded to the iteration width; padded entries
carry position -1, which ``cache_write`` drops.  Chunk widths snap to a
fixed bucket ladder, so the set of shapes the steps see stays bounded
(``compile_stats`` reports the ones taken) -- the precondition for
capturing them as CUDA graphs later.

With ``cache_impl="paged"`` the KV cache is a shared block pool
addressed through per-slot block tables.  ``BlockAllocator`` (host-side
numpy, carried over from the reference as is) owns the tables, prefix
sharing with copy-on-write, and the cached-free LRU of the persistent
prefix cache; ``serving/swap.HostSwapManager`` adds the host swap tier.
The allocator's table mirror is pushed to the device before every step
that reads it (``_sync_tables``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.steps import (make_cloud_decode_step,
                                      make_cloud_verify_step,
                                      make_decode_step, make_verify_step)
from repro_torch.runtime import resolve_device
from repro_torch.serving.trace import NULL_TRACER

DEFAULT_FEED_BUCKETS = (8, 16, 32, 64, 128, 256)


class BlockPoolExhausted(RuntimeError):
    """Raised when a step needs more KV blocks than the pool has free.
    The scheduler's admission/preemption layer is supposed to prevent
    this from ever reaching the engine; seeing it means a policy bug or
    an unguarded caller (e.g. plain decode on an undersized pool)."""


_CHAIN_ROOT = 0x53594E45  # prefix-hash chain seed ("SYNE")


class BlockAllocator:
    """Host-side free-list allocator over the paged KV block pool.

    Mechanism only: tracks which pool blocks back which slot and keeps
    the (max_slots, max_bps) block table mirror the engine pushes to the
    device cache.  Admission/eviction *policy* lives in the scheduler.
    Blocks are recycled FIFO so reuse spreads across the pool.

    With ``share_prefix=True`` blocks are ref-counted and a prefix index
    maps chain hashes of *full* leading token blocks to the pool block
    that already holds their K/V.  A new prompt's leading blocks are
    matched against the index and mapped into its table (ref++) instead
    of allocated; a write into a block with refcount > 1 forks a private
    copy first (copy-on-write — ``prepare_writes`` does the
    bookkeeping, the engine clones pool content).  A block returns to
    the free list only when its refcount reaches zero, at which point it
    also leaves the index.

    With ``retain_prefix=True`` (implies sharing) a fully-written,
    registered prefix block whose refcount hits zero does NOT free:
    it parks on the cached-free LRU (``_cached``, insertion-ordered —
    oldest first) and stays in the index with its pool content intact,
    so a recurring prompt hits across *non-overlapping* sessions.
    Allocation prefers the truly-free list and reclaims LRU cached
    blocks only under pressure (``_take_block``: unregister + queue for
    invalidation — the engine flushes ``take_reclaimed`` before the
    next write).  ``retain_blocks`` caps the LRU (0 = unbounded).

    Index entries are exact, not trust-the-hash: each registered block
    stores ``(prev_chain_hash, its token tuple)`` and a match verifies
    both, so a chain-hash collision can only *miss* a share, never map
    wrong content.
    """

    def __init__(self, n_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, share_prefix: bool = False,
                 retain_prefix: bool = False, retain_blocks: int = 0):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_blocks_per_slot = max_blocks_per_slot
        self.share_prefix = share_prefix or retain_prefix
        self.retain_prefix = retain_prefix
        self.retain_blocks = int(retain_blocks)
        self._free: deque[int] = deque(range(n_blocks))
        self.table = np.full((max_slots, max_blocks_per_slot), -1, np.int32)
        self.n_blocks_of = np.zeros(max_slots, np.int64)
        self.peak_used = 0
        # per-block reference counts (always maintained; every count is 1
        # until adopt_prefix creates the first share)
        self.ref = np.zeros(n_blocks, np.int64)
        # prefix index: chain hash -> block id, plus the reverse map and
        # the exact (prev_hash, tokens) contents for verification
        self._index: dict[int, int] = {}
        self._rindex: dict[int, int] = {}
        self._contents: dict[int, tuple] = {}
        # canonical-chain shadows: content-duplicate blocks (e.g. the
        # unmatched last full block of an identical prompt) registered
        # under the chain hash an earlier block already owns; when the
        # primary dies, a live shadow is promoted so the share survives
        self._shadow: dict[int, list[int]] = {}
        # blocks registered whose content the imminent prompt feed will
        # write: that first write realizes the registered content and
        # must neither fork nor unregister
        self._fill: set[int] = set()
        # cached-free LRU (retain_prefix): registered blocks at ref 0
        # whose content stays valid in the pool.  Insertion-ordered dict
        # used as an ordered set — first key is the LRU victim.
        self._cached: dict[int, None] = {}
        # reclaimed cached blocks whose stale pool positions the engine
        # must invalidate before the next write (see take_reclaimed)
        self._reclaim_pending: list[int] = []
        # telemetry
        # tracing handle (serving/trace.py): installed by the scheduler
        # when tracing is on; the NULL_TRACER default keeps every
        # ``if self.tracer.enabled`` guard below allocation-free
        self.tracer = NULL_TRACER
        self.trace_replica = 0
        self.dedupe_hit_blocks = 0   # cumulative blocks adopted via index
        self.cow_copies = 0          # cumulative copy-on-write forks
        self.shadow_promotions = 0   # duplicates promoted to primary
        self.revived_blocks = 0      # cached-free blocks re-adopted live
        self.reclaimed_blocks = 0    # cached-free blocks reclaimed (LRU)
        self.tail_shared_tokens = 0  # partial-block tail rows copied

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Cached-free blocks: refcount 0 but still registered (their
        pool content is valid and adoptable until reclaimed)."""
        return len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks live in some slot's table (cached-free blocks are not
        used — they are reclaimable supply)."""
        return self.n_blocks - len(self._free) - len(self._cached)

    @property
    def shared_blocks(self) -> int:
        """Blocks currently mapped by more than one slot."""
        return int((self.ref >= 2).sum())

    @property
    def s_max(self) -> int:
        return self.block_size * self.max_blocks_per_slot

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to back a sequence of ``n_tokens`` (the caller
        caps at s_max tokens — the circular window wraps beyond it)."""
        need = -(-max(int(n_tokens), 0) // self.block_size)
        return min(need, self.max_blocks_per_slot)

    def needed(self, slot: int, seq_len: int) -> int:
        """Additional blocks ``slot`` needs to cover ``seq_len`` tokens."""
        return max(0, self.blocks_for(seq_len) - int(self.n_blocks_of[slot]))

    def allocatable_blocks(self, reserved=()) -> int:
        """Blocks an allocation can draw on: the truly-free list plus
        cached-free (LRU-reclaimable) blocks, minus any cached blocks
        the caller is about to adopt (``reserved`` — an adopted cached
        block is revived, not reclaimed, so it cannot double as
        supply)."""
        held = sum(1 for b in reserved if b in self._cached)
        return len(self._free) + len(self._cached) - held

    def _take_block(self):
        """Pop a writable block: truly-free first, else reclaim the
        LRU cached-free block (unregister + queue its stale positions
        for invalidation).  Returns None when both tiers are dry."""
        if self._free:
            return self._free.popleft()
        if self._cached:
            b = next(iter(self._cached))
            del self._cached[b]
            self._unregister(b)
            self._reclaim_pending.append(b)
            self.reclaimed_blocks += 1
            return b
        return None

    def take_reclaimed(self) -> list[int]:
        """Drain the ids of blocks reclaimed from the cached-free LRU
        since the last drain.  The engine MUST invalidate their pool
        positions before the next cache write dispatch — their content
        was valid (that is the point of retention) and would otherwise
        read as live rows through the new owner's table."""
        out, self._reclaim_pending = self._reclaim_pending, []
        return out

    def map_block(self, slot: int, bid: int) -> None:
        """Append an existing block to ``slot``'s table (ref++),
        reviving it from the cached-free LRU if parked there."""
        if bid in self._cached:
            del self._cached[bid]
            self.revived_blocks += 1
            if self.tracer.enabled:
                self.tracer.instant("prefix_revive",
                                    replica=self.trace_replica, slot=slot)
        j = int(self.n_blocks_of[slot])
        self.table[slot, j] = bid
        self.ref[bid] += 1
        self.n_blocks_of[slot] = j + 1
        self.peak_used = max(self.peak_used, self.used_blocks)

    def append_fresh(self, slot: int):
        """Allocate one writable block and append it to ``slot``'s
        table (ref=1).  Returns the block id, or None if the pool (both
        tiers) is dry."""
        b = self._take_block()
        if b is None:
            return None
        j = int(self.n_blocks_of[slot])
        self.table[slot, j] = b
        self.ref[b] = 1
        self.n_blocks_of[slot] = j + 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return b

    def extend(self, slot: int, seq_len: int) -> bool:
        """Grow ``slot`` to cover ``seq_len`` tokens.  All-or-nothing:
        returns False (no allocation) if the pool cannot supply it."""
        need = self.needed(slot, seq_len)
        if need > self.allocatable_blocks():
            return False
        for _ in range(need):
            self.append_fresh(slot)
        return True

    def release(self, slot: int) -> np.ndarray:
        """Drop ``slot``'s reference on all its blocks.  Blocks whose
        refcount hits zero return to the pool (and leave the prefix
        index) — except, under ``retain_prefix``, fully-realized
        registered blocks, which park on the cached-free LRU with index
        entry and pool content intact.  Blocks still mapped by a
        sibling stay live and MUST NOT be invalidated.  Returns the
        truly freed block ids (the engine invalidates their pool
        positions); cached blocks are deliberately NOT in that list."""
        n = int(self.n_blocks_of[slot])
        freed = []
        for j in range(n):
            b = int(self.table[slot, j])
            self.ref[b] -= 1
            if self.ref[b] == 0:
                if (self.retain_prefix and b in self._rindex
                        and b not in self._fill):
                    # cross-session retention: keep the chain entry and
                    # the pool bytes; MRU position in the LRU order
                    self._cached[b] = None
                else:
                    self._free.append(b)
                    self._unregister(b)
                    freed.append(b)
        self.table[slot, :] = -1
        self.n_blocks_of[slot] = 0
        # enforce the retention cap, oldest first
        cap = self.retain_blocks
        while cap and len(self._cached) > cap:
            b = next(iter(self._cached))
            del self._cached[b]
            self._unregister(b)
            self._free.append(b)
            freed.append(b)
        return np.asarray(freed, np.int32)

    # -- prefix sharing / copy-on-write --------------------------------
    def _chain(self, tokens, n_full: int):
        """Yield (chain_hash, prev_hash, block_tuple) for the first
        ``n_full`` full token blocks."""
        h = _CHAIN_ROOT
        bs = self.block_size
        for j in range(n_full):
            blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            prev, h = h, hash((h, blk))
            yield h, prev, blk

    def match_prefix(self, tokens) -> list[int]:
        """Read-only probe: pool block ids already holding the leading
        full blocks of ``tokens``, in chain order, stopping at the first
        divergence.  Capped at ``len(tokens) - 1`` tokens so a fully
        cached prompt still feeds its last token (the prefill's
        full-vocab seed row must be computed).  Prompts longer than
        s_max wrap over their own leading blocks and never share."""
        if not self.share_prefix or len(tokens) > self.s_max:
            return []
        n_full = min((len(tokens) - 1) // self.block_size,
                     self.max_blocks_per_slot)
        out = []
        for h, prev, blk in self._chain(tokens, n_full):
            bid = self._index.get(h)
            if bid is None or self._contents.get(bid) != (prev, blk):
                break
            out.append(bid)
        return out

    def adopt_prefix(self, slot: int, bids: list[int]) -> None:
        """Map matched prefix blocks into an empty slot's table (ref++):
        the dedupe hit — no allocation, no feed, just an indirection.
        Cached-free blocks in ``bids`` are revived (the cross-session
        hit: the prior owner is long gone, the bytes are still here)."""
        assert int(self.n_blocks_of[slot]) == 0, \
            "prefix adoption requires a freshly admitted (empty) slot"
        for b in bids:
            self.map_block(slot, b)
        self.dedupe_hit_blocks += len(bids)
        if bids and self.tracer.enabled:
            self.tracer.instant("prefix_adopt",
                                replica=self.trace_replica, slot=slot,
                                n=len(bids))

    def chain_of(self, bid: int):
        """Registration record of a block: ``(chain_hash, prev_hash,
        token_tuple)``, or None if unregistered."""
        h = self._rindex.get(bid)
        if h is None:
            return None
        prev, blk = self._contents[bid]
        return h, prev, blk

    def register_block(self, bid: int, h: int, prev: int, blk: tuple,
                       fill: bool = False) -> None:
        """Publish one block under chain hash ``h`` with exact contents
        ``(prev, blk)``.  ``fill=False`` registers it *realized* (its
        pool content already holds the promised rows — e.g. scattered
        from the host store), so a later sole-owned divergent write
        correctly unregisters instead of skipping the fork."""
        if bid in self._rindex:
            return
        self._rindex[bid] = h
        self._contents[bid] = (prev, blk)
        if fill:
            self._fill.add(bid)
        if h not in self._index:
            self._index[h] = bid
        else:
            self._shadow.setdefault(h, []).append(bid)

    def match_tail(self, tokens, n_matched: int):
        """Partial-block tail probe: after ``n_matched`` fully matched
        blocks, find a registered block whose content extends the same
        chain and shares the longest row prefix with the next (partial)
        block of ``tokens``.  Returns ``(bid, rows)`` with rows >= 1, or
        None.  Capped at ``len(tokens) - 1`` total so the prefill still
        feeds at least the last token; fill-pending candidates are
        excluded (their pool rows are not written yet, so there is
        nothing to copy)."""
        if not self.share_prefix or len(tokens) > self.s_max:
            return None
        bs = self.block_size
        lo = n_matched * bs
        cap = min(len(tokens) - 1 - lo, bs)
        if cap <= 0 or n_matched >= self.max_blocks_per_slot:
            return None
        h = _CHAIN_ROOT
        for ch, _prev, _blk in self._chain(tokens, n_matched):
            h = ch
        want = tuple(int(t) for t in tokens[lo:lo + cap])
        best = None
        for bid, (prev, blk) in self._contents.items():
            if prev != h or bid in self._fill:
                continue
            r = 0
            while r < cap and blk[r] == want[r]:
                r += 1
            if r > 0 and (best is None or r > best[1]):
                best = (bid, r)
                if r == cap:
                    break
        return best

    def register_prefix(self, slot: int, tokens) -> None:
        """Publish ``slot``'s full prompt blocks in the prefix index.
        Called at admission, *before* the prompt feed writes them: the
        blocks are marked fill-pending so the realizing write neither
        forks nor unregisters them, and streams admitted into the same
        batch can already adopt them (the batched step scatters K/V
        before any suffix row attends)."""
        if not self.share_prefix or len(tokens) > self.s_max:
            return
        n_full = min(len(tokens) // self.block_size,
                     self.max_blocks_per_slot)
        for j, (h, prev, blk) in enumerate(self._chain(tokens, n_full)):
            bid = int(self.table[slot, j])
            if bid < 0 or bid in self._rindex:
                continue                 # adopted / already registered
            # canonical-chain registration: when the chain hash already
            # has a primary (e.g. this prompt's last full block sat
            # past the len-1 match cap, so a content duplicate was
            # allocated), register_block records the duplicate under the
            # SAME canonical hash so _unregister can promote it when the
            # primary dies — without it, a content-identical prefix
            # would miss a share that still physically exists.
            self.register_block(bid, h, prev, blk, fill=True)

    def _unregister(self, bid: int) -> None:
        h = self._rindex.pop(bid, None)
        if h is not None:
            self._contents.pop(bid, None)
            shadows = self._shadow.get(h)
            if self._index.get(h) == bid:
                self._index.pop(h, None)
                if shadows:
                    # promote a live content duplicate: the share
                    # survives the primary block's death
                    self._index[h] = shadows.pop(0)
                    self.shadow_promotions += 1
            elif shadows and bid in shadows:
                shadows.remove(bid)
            if shadows is not None and not shadows:
                self._shadow.pop(h, None)
        self._fill.discard(bid)

    def cow_demand(self, slot: int, lo: int, hi: int) -> int:
        """Forks a write covering absolute positions [lo, hi) would
        need: mapped blocks with refcount > 1 (fill-pending blocks are
        about to be realized, not forked).  The scheduler reserves these
        on top of ``needed`` growth."""
        if not self.share_prefix or hi <= lo:
            return 0
        idxs = {(p % self.s_max) // self.block_size
                for p in range(int(lo), int(hi))}
        n = 0
        for i in idxs:
            bid = int(self.table[slot, i])
            if bid >= 0 and bid not in self._fill and self.ref[bid] > 1:
                n += 1
        return n

    def prepare_writes(self, slot: int, idxs) -> list[tuple[int, int]]:
        """Copy-on-write bookkeeping for an imminent write into
        ``slot``'s table entries ``idxs``.  Three cases per block:

        * fill-pending (just registered, this write realizes the
          promised content): cleared, nothing else happens;
        * refcount > 1: the writer is re-pointed at a fresh block and a
          ``(src, dst)`` fork pair is returned — the engine must clone
          pool content src -> dst *before* the write executes;
        * sole-owned but registered: the content is about to diverge
          from the published hash, so the block leaves the index.
        """
        pairs = []
        for i in idxs:
            i = int(i)
            bid = int(self.table[slot, i])
            if bid < 0:
                continue
            if bid in self._fill:
                self._fill.discard(bid)
                continue
            if self.ref[bid] > 1:
                dst = self._take_block()
                if dst is None:
                    raise BlockPoolExhausted(
                        f"slot {slot} must copy-on-write fork shared "
                        f"block {bid} but the pool is dry")
                self.ref[bid] -= 1
                self.ref[dst] = 1
                self.table[slot, i] = dst
                self.cow_copies += 1
                if self.tracer.enabled:
                    self.tracer.instant("cow_fork",
                                        replica=self.trace_replica,
                                        slot=slot)
                pairs.append((bid, dst))
            elif bid in self._rindex:
                self._unregister(bid)
        self.peak_used = max(self.peak_used, self.used_blocks)
        return pairs



def _cache_tensors(cache):
    """Every tensor of a cache tree (all stacks), in tree order."""
    for v in cache.values():
        if isinstance(v, dict):
            yield from _cache_tensors(v)
        else:
            yield v


def _reset_cache_slot(cache, slot: int):
    """Invalidate ``slot`` in every dense KV stack of the cache, in place:
    its positions -> -1 (stale K/V at an invalid position is never
    attended to)."""
    for k, v in cache.items():
        if isinstance(v, dict):
            _reset_cache_slot(v, slot)
        elif k == "pos":                      # (..., B, S)
            v[..., slot, :] = -1


def _reset_paged_blocks(cache, blocks):
    """Invalidate the pool positions of freed blocks in place.  Freed K/V
    stays stale -- a block is only ever read through a table entry, and
    a re-allocated block is re-written before its positions turn valid
    again."""
    if len(blocks) == 0:
        return cache
    for st in M.paged_stacks(cache):
        ids = torch.as_tensor(np.asarray(blocks), dtype=torch.long,
                              device=st["pos"].device)
        st["pos"][:, ids] = -1
    return cache


def _set_block_tables(cache, table: np.ndarray):
    """Copy the allocator's (max_slots, max_bps) table mirror into every
    paged stack's device ``block_tables`` (one table for all layers)."""
    src = torch.from_numpy(table)
    for st in M.paged_stacks(cache):
        st["block_tables"].copy_(src)
    return cache


@dataclass(frozen=True)
class VerifyRows:
    """Fused verification state for one feed (host-resident).

    All arrays are indexed by the caller's ``sel_idx`` selection plane
    (R = verify_rows_max): entry r of slot b describes the chunk row
    ``sel_idx[b, r]``.

    token_id: (slots, R) int32  -- argmax over the vocab
    p_draft:  (slots, R) f32    -- softmax prob of the row's target token
    topk_idx: (slots, R, K) int32
    topk_val: (slots, R, K) f32 -- top-k sampling support of the row
    """
    token_id: np.ndarray
    p_draft: np.ndarray
    topk_idx: np.ndarray
    topk_val: np.ndarray

    @property
    def nbytes(self) -> int:
        return (self.token_id.nbytes + self.p_draft.nbytes
                + self.topk_idx.nbytes + self.topk_val.nbytes)


@dataclass(frozen=True)
class DecodeRows:
    """Fused per-slot decode result: argmax id + top-k sampling support."""
    token_id: np.ndarray          # (slots,) int32
    topk_idx: np.ndarray          # (slots, K) int32
    topk_val: np.ndarray          # (slots, K) f32

    @property
    def nbytes(self) -> int:
        return (self.token_id.nbytes + self.topk_idx.nbytes
                + self.topk_val.nbytes)


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


class CloudEngine:
    """Fixed-slot serving engine for one model (dense or paged KV cache)."""

    def __init__(self, cfg, params, *, max_slots: int = 8, s_max: int = 2048,
                 window: int = 0, verify_top_k: int = 8,
                 verify_rows_max: int = 8,
                 feed_buckets: tuple = DEFAULT_FEED_BUCKETS,
                 cache_impl: str | None = None, block_size: int | None = None,
                 pool_blocks: int | None = None,
                 share_prefix: bool | None = None,
                 retain_prefix: bool | None = None,
                 retain_blocks: int | None = None,
                 host_dedupe: bool | None = None,
                 swap: bool | None = None,
                 host_swap_blocks: int | None = None,
                 paged_block_kv: int | None = None,
                 kv_splits: int | None = None, device=None):
        if cfg.family in ("ssm", "hybrid"):
            # bucket padding (token 0 at position -1) would enter the conv
            # windows and the SSM states of the Mamba2 layers, and a
            # rejected draft cannot be rewound out of a recurrent state
            # (ROADMAP queue 3, R6)
            raise ValueError(f"CloudEngine cannot serve the {cfg.family} "
                             f"family ({cfg.name}): padded feeds would "
                             f"corrupt its Mamba2 state (R6); use the "
                             f"model-level steps")
        # paged-kernel split layout knobs ride on the config, which the
        # steps read
        if paged_block_kv is not None:
            cfg = cfg.replace(paged_block_kv=paged_block_kv)
        if kv_splits is not None:
            cfg = cfg.replace(paged_kv_splits=kv_splits)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.s_max = s_max
        self.window = window
        self.vocab = cfg.vocab
        self.verify_top_k = max(1, min(verify_top_k, cfg.vocab))
        # vocab-sized epilogue reductions run on at most this many
        # selected rows per slot per iteration (>= gamma + 1)
        self.verify_rows_max = verify_rows_max
        self.feed_buckets = tuple(sorted(feed_buckets))
        # -- cache substrate: dense (slots x s_max up front) or paged
        # (shared block pool + per-slot block tables, memory-bound) ------
        self.cache_impl = cache_impl or getattr(cfg, "cache_impl", "dense")
        self.block_size = block_size or getattr(cfg, "kv_block_size", 16)
        self.allocator: BlockAllocator | None = None
        self.share_prefix = False
        self.swap_manager = None
        want_swap = bool(swap if swap is not None
                         else getattr(cfg, "kv_swap", False))
        if want_swap and self.cache_impl != "paged":
            raise ValueError("swap=True requires cache_impl='paged' "
                             "(dense caches have no block pool to swap)")
        if self.cache_impl == "paged":
            max_bps = -(-s_max // self.block_size)
            nb = (pool_blocks if pool_blocks is not None
                  else max_slots * max_bps)
            retain = bool(retain_prefix if retain_prefix is not None
                          else getattr(cfg, "retain_prefix", False))
            self.share_prefix = bool(
                share_prefix if share_prefix is not None
                else getattr(cfg, "share_prefix", False)) or retain
            self.allocator = BlockAllocator(
                nb, self.block_size, max_slots, max_bps,
                share_prefix=self.share_prefix,
                retain_prefix=retain,
                retain_blocks=(retain_blocks if retain_blocks is not None
                               else getattr(cfg, "retain_blocks", 0)))
            self.cache = M.init_cache(cfg, max_slots, s_max,
                                      cache_impl="paged",
                                      block_size=self.block_size,
                                      pool_blocks=nb, device=self.device)
            self._tables_dirty = False
            if want_swap:
                # deferred import: swap.py imports this module
                from repro_torch.serving.swap import HostSwapManager
                hb = (host_swap_blocks if host_swap_blocks is not None
                      else getattr(cfg, "host_swap_blocks", 0))
                dedupe = bool(host_dedupe if host_dedupe is not None
                              else getattr(cfg, "host_dedupe", True))
                self.swap_manager = HostSwapManager(self,
                                                    max_host_blocks=hb,
                                                    host_dedupe=dedupe)
        else:
            self.cache = M.init_cache(cfg, max_slots, s_max,
                                      cache_impl="dense", device=self.device)
        self._step = make_cloud_verify_step(cfg, window=window,
                                            top_k=self.verify_top_k)
        # greedy-only iterations skip the probability epilogue entirely
        self._step_greedy = make_cloud_verify_step(
            cfg, window=window, top_k=self.verify_top_k, with_dists=False)
        self._decode = make_cloud_decode_step(cfg, window=window,
                                              top_k=self.verify_top_k)
        # legacy/debug full-logits path (identity tests)
        self._raw_verify = make_verify_step(cfg, window=window)
        self._raw_decode = make_decode_step(cfg, window=window)
        # telemetry: host transfer + shape accounting; forwards of the
        # fused step, the slots they ran, their rows (slots x bucket) and
        # those that carried a position (>= 0), by entry point
        self.bytes_to_host = 0
        self._calls = {"feed": 0, "prefill": 0, "decode": 0,
                       "feed_logits": 0, "decode_logits": 0}
        self._forwards = {"feed": 0, "prefill": 0}
        self._slots_run = {"feed": 0, "prefill": 0}
        self._rows_run = {"feed": 0, "prefill": 0}
        self._rows_real = {"feed": 0, "prefill": 0}
        self._specializations: set = set()
        # program tracing (serving/trace.py), installed by the
        # scheduler's set_tracer(..., program=True): engine.forward /
        # engine.to_host spans name the scheduler's open sched.iteration
        # span (trace_parent) and carry its request ids (trace_rids)
        self.tracer = NULL_TRACER
        self.trace_replica = 0
        self.trace_parent = -1
        self.trace_rids = ()
        # a replica marked dead must never serve again: any further
        # compute dispatch raises
        self.dead = False

    def mark_dead(self):
        """Poison this engine: every subsequent compute dispatch raises.
        Nothing (not even slot release) may touch a dead replica's pool
        again, so a routing bug that still dispatches here fails loudly."""
        self.dead = True

    def _dev(self, arr, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=self.device)

    # -- telemetry ------------------------------------------------------
    @property
    def compile_stats(self) -> dict:
        """Which (step, bucket) shapes this engine ran, how often each
        entry point ran — the bucket ladder bounds the set of shapes —
        and, for ``feed`` and ``prefill``, the fused forwards they ran,
        the slots those forwards ran (``slots_run``: a prefill runs only
        the slots with a position in its sub-chunk) and their rows: all
        (``rows_run``, slots x bucket, padding included) and those with a
        position (``rows_real``)."""
        return dict(
            calls=dict(self._calls),
            forwards=dict(self._forwards),
            slots_run=dict(self._slots_run),
            rows_run=dict(self._rows_run),
            rows_real=dict(self._rows_real),
            buckets=sorted({b for kind, b in self._specializations
                            if kind in ("fused", "fused_greedy")}),
            specializations=sorted(self._specializations),
            n_specializations=len(self._specializations),
            bytes_to_host=self.bytes_to_host,
        )

    # -- cache management ----------------------------------------------
    def reset_slot(self, slot: int):
        """Invalidate a slot's cache: positions -> -1 (stale K/V at invalid
        positions is never attended to).  Paged: the slot's blocks return
        to the pool and their pool positions are invalidated (a freed
        block must never read as valid through a future owner's table)."""
        if self.allocator is not None:
            if (self.swap_manager is not None
                    and not self.allocator.retain_prefix):
                # content-addressed demotion: without device retention,
                # the last sharer's exit would lose a recurring prefix;
                # park its sole-owned registered blocks in the host store
                # so a future session can adopt them (H2D scatter instead
                # of re-prefill)
                self.swap_manager.demote_slot(slot)
            freed = self.allocator.release(slot)
            self._invalidate_blocks(freed)
            self._tables_dirty = True
            self._sync_tables()
            return
        _reset_cache_slot(self.cache, slot)

    # -- paged block management ----------------------------------------
    def _invalidate_blocks(self, bids):
        """Invalidate pool positions of ``bids`` (a freed or reclaimed
        block must never read as valid through a future owner's table)."""
        _reset_paged_blocks(self.cache, [int(b) for b in bids])

    def _flush_reclaims(self):
        """Invalidate positions of blocks reclaimed from the cached-free
        LRU since the last flush.  A reclaimed block's content was fully
        valid (that is what retention preserves), so its stale rows WOULD
        read as live through the new owner's table; this must run before
        any step that writes or reads the reclaimed blocks -- and before
        ``_apply_forks`` (wipe-then-copy keeps a fork destination's
        content; the reverse order would destroy it)."""
        if self.allocator is not None:
            self._invalidate_blocks(self.allocator.take_reclaimed())

    def _sync_tables(self):
        """Push the allocator's block-table mirror to the device table."""
        if self.allocator is not None and self._tables_dirty:
            _set_block_tables(self.cache, self.allocator.table)
            self._tables_dirty = False

    def _ensure_blocks(self, positions: np.ndarray):
        """Grow each active slot's allocation to cover the highest
        position this step writes (capped at s_max -- the circular window
        wraps beyond it), forking any shared block the step would write
        into (copy-on-write) so siblings keep reading the original.
        Raises :class:`BlockPoolExhausted` when the pool is dry; the
        scheduler's admission + preemption layer is responsible for never
        letting that happen."""
        if self.dead:
            raise RuntimeError(
                "CloudEngine is marked dead (replica killed); no dispatch "
                "may reach it -- sessions must be re-placed on a survivor")
        if self.allocator is None:
            return
        pos = np.asarray(positions)
        forks: list[tuple[int, int]] = []
        for slot in range(pos.shape[0]):
            valid = pos[slot][pos[slot] >= 0]
            if valid.size == 0:
                continue
            if self.allocator.share_prefix:
                # allocator.s_max (block-size padded) is the same modulus
                # cache_write_paged wraps with on the device
                idxs = np.unique((valid % self.allocator.s_max)
                                 // self.allocator.block_size)
                forks += self.allocator.prepare_writes(slot, idxs)
            L = min(int(valid.max()) + 1, self.s_max)
            if self.allocator.needed(slot, L):
                if not self.allocator.extend(slot, L):
                    raise BlockPoolExhausted(
                        f"slot {slot} needs {self.allocator.needed(slot, L)}"
                        f" more KV blocks; pool has "
                        f"{self.allocator.free_blocks} free")
                self._tables_dirty = True
        self._flush_reclaims()
        if forks:
            self._tables_dirty = True
            self._apply_forks(forks)
        self._sync_tables()

    def _apply_forks(self, pairs: list[tuple[int, int]]):
        """Clone pool content for copy-on-write forks (src -> dst across
        every layer stack), in place, all pairs in one gather-then-write."""
        M.copy_cache_blocks(self.cache, [s for s, _ in pairs],
                            [d for _, d in pairs])

    def alloc_prompt(self, slot: int, tokens, bids: list | None = None) -> int:
        """Allocate a freshly admitted slot's prompt blocks, deduping the
        leading full blocks against the prefix index.  Returns the number
        of leading prompt tokens now backed by shared blocks (0 without
        ``share_prefix``) -- the scheduler feeds only the suffix, from
        the first divergent token.  ``bids`` lets the caller pass the
        ``match_prefix`` probe it already ran for admission (valid as
        long as nothing was released in between).

        Matching, adoption, fresh allocation and registration all happen
        here, at admission, *before* the batched prompt feed: streams
        admitted into the same iteration dedupe against each other.  This
        is safe only because the scheduler aligns prefill columns with
        absolute positions, so every sub-chunk of a split feed scatters a
        position range for all slots before any later sub-chunk's rows
        attend over it."""
        a = self.allocator
        if a is None:
            raise RuntimeError("alloc_prompt requires a paged engine")
        if bids is None or any(b not in a._rindex for b in bids):
            # re-probe: a block the admission probe matched may have been
            # reclaimed from the cached-free LRU in the interim
            bids = a.match_prefix(tokens)
        if bids:
            a.adopt_prefix(slot, bids)
            self._tables_dirty = True
        # continue the chain-hash walk into the content-addressed host
        # store: blocks a finished (or swapped) stream demoted to host
        # memory are adopted by H2D scatter instead of re-prefill
        host = []
        if self.swap_manager is not None:
            host = self.swap_manager.host_match_chain(tokens, len(bids))
        L = min(len(tokens), self.s_max)
        if a.needed(slot, L):
            if not a.extend(slot, L):
                raise BlockPoolExhausted(
                    f"prompt of {len(tokens)} tokens needs "
                    f"{a.needed(slot, L)} more KV blocks for slot {slot}; "
                    f"pool has {a.free_blocks} free -- admission should "
                    f"have deferred this prefill")
            self._tables_dirty = True
        # reclaimed cached blocks must be wiped before the host scatter or
        # tail copy writes (and before the prompt feed reads them)
        self._flush_reclaims()
        if host:
            self.swap_manager.adopt_from_host(slot, len(bids), host)
        n_adopted = len(bids) + len(host)
        shared = n_adopted * a.block_size
        # partial-block tail: the longest matching row prefix of a
        # registered block is copied by value into the first divergent
        # block, so a prefix ending mid-block stops re-computing there
        tail = a.match_tail(tokens, n_adopted)
        if tail is not None:
            src_bid, rows = tail
            dst_bid = int(a.table[slot, n_adopted])
            M.copy_cache_block_rows(self.cache, [src_bid], [dst_bid], [rows])
            a.tail_shared_tokens += rows
            shared += rows
        a.register_prefix(slot, tokens)
        return shared

    def readopt_prefix(self, slot: int, tokens) -> int:
        """Re-match a restarted (preempted/rewound) stream's leading
        blocks against the prefix index and adopt them into its freshly
        emptied slot -- the restart analogue of ``alloc_prompt``'s dedupe.
        The refeed then starts at the first unmatched token.  Returns the
        number of re-adopted tokens (0 for dense engines or with sharing
        off)."""
        a = self.allocator
        if a is None or not a.share_prefix:
            return 0
        bids = a.match_prefix(tokens)
        if not bids:
            return 0
        a.adopt_prefix(slot, bids)
        self._tables_dirty = True
        self._sync_tables()
        return len(bids) * a.block_size

    def kv_cache_bytes(self) -> int:
        """Total bytes backing the KV cache, every stack (dense buffers, or
        the whole block pool plus each stack's block table)."""
        return int(sum(t.numel() * t.element_size()
                       for t in _cache_tensors(self.cache)))

    def block_bytes(self) -> int:
        """Bytes one pool block occupies across all layers/stacks."""
        if self.allocator is None:
            raise RuntimeError("block_bytes requires a paged engine")
        nb = self.allocator.n_blocks
        return sum(st[k].numel() * st[k].element_size() // nb
                   for st in M.paged_stacks(self.cache)
                   for k in ("k", "v", "pos"))

    @property
    def pool_stats(self) -> dict:
        """Block-pool telemetry (ServerStats).  A dense engine reports its
        full reservation as in use: dense memory cost is ``max_slots x
        s_max`` regardless of actual sequence lengths."""
        total = self.kv_cache_bytes()
        if self.allocator is None:
            return dict(cache_impl="dense", kv_cache_bytes=total,
                        kv_bytes_in_use=total, kv_bytes_peak=total,
                        free_blocks=0, cached_free_blocks=0, used_blocks=0,
                        peak_used_blocks=0, n_blocks=0, block_size=0,
                        share_prefix=False, retain_prefix=False,
                        shared_blocks=0, dedupe_hit_blocks=0, cow_copies=0,
                        revived_blocks=0, reclaimed_blocks=0,
                        tail_shared_tokens=0,
                        swap=False, swapped_blocks=0, swap_out_bytes=0,
                        swap_in_bytes=0, host_store_blocks=0,
                        host_lru_blocks=0, host_dedupe_hits=0,
                        host_adopted_blocks=0, adopt_in_bytes=0,
                        demoted_blocks=0)
        a = self.allocator
        bb = self.block_bytes()
        sw = self.swap_manager
        return dict(cache_impl="paged", kv_cache_bytes=total,
                    kv_bytes_in_use=a.used_blocks * bb,
                    kv_bytes_peak=a.peak_used * bb,
                    free_blocks=a.free_blocks,
                    cached_free_blocks=a.cached_blocks,
                    used_blocks=a.used_blocks,
                    peak_used_blocks=a.peak_used, n_blocks=a.n_blocks,
                    block_size=a.block_size, share_prefix=a.share_prefix,
                    retain_prefix=a.retain_prefix,
                    shared_blocks=a.shared_blocks,
                    dedupe_hit_blocks=a.dedupe_hit_blocks,
                    cow_copies=a.cow_copies,
                    revived_blocks=a.revived_blocks,
                    reclaimed_blocks=a.reclaimed_blocks,
                    tail_shared_tokens=a.tail_shared_tokens,
                    swap=sw is not None,
                    swapped_blocks=sw.swapped_blocks if sw else 0,
                    swap_out_bytes=sw.swap_out_bytes if sw else 0,
                    swap_in_bytes=sw.swap_in_bytes if sw else 0,
                    host_store_blocks=sw.host_store_blocks if sw else 0,
                    host_lru_blocks=sw.host_lru_blocks if sw else 0,
                    host_dedupe_hits=sw.host_dedupe_hits if sw else 0,
                    host_adopted_blocks=sw.host_adopted_blocks if sw else 0,
                    adopt_in_bytes=sw.adopt_in_bytes if sw else 0,
                    demoted_blocks=sw.demoted_blocks if sw else 0)

    # -- bucketing ------------------------------------------------------
    def _bucket_of(self, n: int) -> int:
        for b in self.feed_buckets:
            if n <= b:
                return b
        return self.feed_buckets[-1]

    def _chunks(self, C: int):
        """Split a width-C feed into ladder-bounded sub-chunks."""
        cap = self.feed_buckets[-1]
        off = 0
        while off < C:
            yield off, min(cap, C - off)
            off += cap

    @staticmethod
    def _pad(arr, width, fill):
        pad = width - arr.shape[1]
        if pad <= 0:
            return arr
        return np.pad(arr, ((0, 0), (0, pad)), constant_values=fill)

    def _run_fused(self, tokens, positions, targets, sel_idx, last_local,
                   with_dists=True, *, entry: str, cache=None):
        """One fused sub-chunk of ``entry`` (``feed`` / ``prefill``) over
        ``cache`` (default the engine's; a :func:`models.model.slot_view`
        of it when the batch holds some of its slots); returns device
        outputs.  Callers copy to the host only what they need."""
        tr = self.tracer
        if tr.enabled:
            t0 = tr.clock.now_ms
        B, C = tokens.shape
        Cb = self._bucket_of(C)
        real = int((positions >= 0).sum())
        self._forwards[entry] += 1
        self._slots_run[entry] += B
        self._rows_run[entry] += B * Cb
        self._rows_real[entry] += real
        self._specializations.add(
            ("fused" if with_dists else "fused_greedy", Cb))
        step = self._step if with_dists else self._step_greedy
        out, _ = step(
            self.params, self.cache if cache is None else cache,
            self._dev(self._pad(tokens, Cb, 0), torch.long),
            self._dev(self._pad(positions, Cb, -1)),
            self._dev(self._pad(targets, Cb, -1)),
            self._dev(sel_idx), self._dev(last_local))
        if tr.enabled:
            tr.span(t0, tr.clock.now_ms, "engine.forward",
                    replica=self.trace_replica, rids=self.trace_rids,
                    parent=self.trace_parent,
                    args={"entry": entry, "bucket": Cb, "slots": B,
                          "rows_run": B * Cb, "rows_real": real})
        return out

    def _to_host_span(self, t0: float, nbytes: int) -> None:
        """Record one blocking read of a sub-chunk's rows (tracing on)."""
        tr = self.tracer
        tr.span(t0, tr.clock.now_ms, "engine.to_host",
                replica=self.trace_replica, rids=self.trace_rids,
                parent=self.trace_parent, nbytes=nbytes)

    # ------------------------------------------------------------------
    def feed(self, tokens: np.ndarray, positions: np.ndarray,
             targets: np.ndarray | None = None,
             sel_idx: np.ndarray | None = None,
             need_dists: bool = True) -> VerifyRows:
        """Chunked (partial) prefill over all slots, fused epilogue.

        tokens, positions: (max_slots, C) int; positions == -1 marks
        padding/idle.  ``targets`` (max_slots, C) carries, per row, the
        token id whose probability the verifier will test (-1 = none);
        ``sel_idx`` (max_slots, R) the local indices of the rows whose
        p/top-k state the verifier will consume.  ``need_dists=False``
        selects the argmax-only step.  Only the fused rows cross to the
        host.
        """
        self._calls["feed"] += 1
        self._ensure_blocks(positions)
        B, C = tokens.shape
        R = self.verify_rows_max
        if targets is None:
            targets = np.full((B, C), -1, np.int32)
        if sel_idx is None:
            sel_idx = np.full((B, R), -1, np.int32)
        zeros = np.zeros(B, np.int32)
        tok_acc = np.zeros((B, R), np.int32)
        p_acc = np.zeros((B, R), np.float32)
        ki_acc = np.zeros((B, R, self.verify_top_k), np.int32)
        kv_acc = np.zeros((B, R, self.verify_top_k), np.float32)
        moved_bytes = 0
        for off, w in self._chunks(C):
            sl = slice(off, off + w)
            in_chunk = (sel_idx >= off) & (sel_idx < off + w)
            sub_sel = np.where(in_chunk, sel_idx - off, -1).astype(np.int32)
            res = self._run_fused(tokens[:, sl], positions[:, sl],
                                  targets[:, sl], sub_sel, zeros,
                                  with_dists=need_dists, entry="feed")
            if in_chunk.any():      # only selected rows cross to the host
                if self.tracer.enabled:
                    t0, b0 = self.tracer.clock.now_ms, moved_bytes
                tok = _host(res[0], np.int32)
                tok_acc = np.where(in_chunk, tok, tok_acc)
                moved_bytes += tok.nbytes
                if need_dists:
                    p_acc = np.where(in_chunk, _host(res[1], np.float32),
                                     p_acc)
                    ki_acc = np.where(in_chunk[..., None],
                                      _host(res[2], np.int32), ki_acc)
                    kv_acc = np.where(in_chunk[..., None],
                                      _host(res[3], np.float32), kv_acc)
                    moved_bytes += (p_acc.nbytes + ki_acc.nbytes
                                    + kv_acc.nbytes)
                if self.tracer.enabled:
                    self._to_host_span(t0, moved_bytes - b0)
        self.bytes_to_host += moved_bytes
        return VerifyRows(token_id=tok_acc, p_draft=p_acc,
                          topk_idx=ki_acc, topk_val=kv_acc)

    def prefill(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Prompt prefill over all slots.  Returns each slot's LAST valid
        row's full logits (max_slots, V) — gathered on device, one
        vocab-row per slot — and writes the cache.  Slots with no valid
        positions return zeros.

        Each sub-chunk's forward runs only the slots with a position in
        it, through a slot view of the cache (``models.model.slot_view``),
        unless the cache holds per-slot state the view cannot address:
        then, or when every slot has a position, all slots run."""
        self._calls["prefill"] += 1
        self._ensure_blocks(positions)
        B, C = tokens.shape
        valid = positions >= 0
        # last valid column per slot (-1 = idle)
        last_col = np.where(valid.any(axis=1),
                            C - 1 - np.argmax(valid[:, ::-1], axis=1), -1)
        out = np.zeros((B, self.vocab), np.float32)
        for off, w in self._chunks(C):
            sl = slice(off, off + w)
            slots = np.flatnonzero(valid[:, sl].any(axis=1))
            if slots.size == 0:
                continue
            view = None
            if slots.size < B:
                view = M.slot_view(self.cache, self._dev(slots))
            if view is None:
                slots = np.arange(B)
            n = slots.size
            local = np.clip(last_col[slots] - off, 0, w - 1).astype(np.int32)
            # only the last-row gather is consumed: the argmax-only step
            res = self._run_fused(tokens[slots, sl], positions[slots, sl],
                                  np.full((n, w), -1, np.int32),
                                  np.full((n, self.verify_rows_max), -1,
                                          np.int32),
                                  local, with_dists=False, entry="prefill",
                                  cache=view)
            sel = (last_col[slots] >= off) & (last_col[slots] < off + w)
            if sel.any():
                # gather on device only the slots whose LAST prompt row
                # lives in this sub-chunk: one vocab row per prefilled slot
                if self.tracer.enabled:
                    t0 = self.tracer.clock.now_ms
                idx = np.flatnonzero(sel)
                rows = _host(res[4][self._dev(idx, torch.long)], np.float32)
                out[slots[idx]] = rows
                self.bytes_to_host += rows.nbytes
                if self.tracer.enabled:
                    self._to_host_span(t0, rows.nbytes)
        return out

    def decode(self, tokens: np.ndarray, positions: np.ndarray) -> DecodeRows:
        """One decode step for all slots. tokens/positions: (max_slots, 1).

        Returns fused last-token rows (argmax + top-k support)."""
        self._calls["decode"] += 1
        self._ensure_blocks(positions)
        self._specializations.add(("decode", 1))
        (tok, tk_i, tk_v), self.cache = self._decode(
            self.params, self.cache, self._dev(tokens, torch.long),
            self._dev(positions))
        rows = DecodeRows(token_id=_host(tok, np.int32),
                          topk_idx=_host(tk_i, np.int32),
                          topk_val=_host(tk_v, np.float32))
        self.bytes_to_host += rows.nbytes
        return rows

    # -- legacy/debug full-logits path ---------------------------------
    def feed_logits(self, tokens: np.ndarray,
                    positions: np.ndarray) -> np.ndarray:
        """Pre-fusion semantics: round-trip the full (max_slots, C, V)
        logits as host float32."""
        self._calls["feed_logits"] += 1
        self._ensure_blocks(positions)
        parts = []
        for off, w in self._chunks(tokens.shape[1]):
            sl = slice(off, off + w)
            Cb = self._bucket_of(w)
            self._specializations.add(("raw", Cb))
            logits, self.cache = self._raw_verify(
                self.params, self.cache,
                self._dev(self._pad(tokens[:, sl], Cb, 0), torch.long),
                self._dev(self._pad(positions[:, sl], Cb, -1)))
            parts.append(_host(logits[:, :w].float(), np.float32))
        out = np.concatenate(parts, axis=1)
        self.bytes_to_host += out.nbytes
        return out

    def decode_logits(self, tokens: np.ndarray,
                      positions: np.ndarray) -> np.ndarray:
        """Pre-fusion decode: full last-token logits (max_slots, V)."""
        self._calls["decode_logits"] += 1
        self._ensure_blocks(positions)
        self._specializations.add(("raw_decode", 1))
        logits, self.cache = self._raw_decode(
            self.params, self.cache, self._dev(tokens, torch.long),
            self._dev(positions))
        out = _host(logits.float(), np.float32)
        self.bytes_to_host += out.nbytes
        return out
