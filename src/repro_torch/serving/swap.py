"""Host-memory KV swap tier + preemption policy layer (port of
``repro/serving/swap.py``).

The swap tier gives the paged pool a second relief valve besides
recompute-eviction: move a victim's pool blocks to a host-side block
store (one copying gather across every layer stack,
``models/model.peek_cache_blocks``, then a D2H copy into pinned host
tensors) and scatter them back into freshly allocated blocks when
pressure clears (``swap_in_blocks``).  Restored blocks are bit-identical,
so token streams are unchanged; only the modeled clock pays the D2H+H2D
round trip through ``CloudLatencyModel.host_link_gbps``.

**Content addressing** (``host_dedupe``, requires prefix sharing): host
blocks that are registered in the allocator's chain-hash index are keyed
by that hash in a shared store with host-side refcounts, so identical
swapped prefixes dedupe across streams and entries whose last referent
is gone park on a host LRU.  **Demotion** (:meth:`HostSwapManager.
demote_slot`) peeks an exiting stream's sole-owned registered blocks to
the host LRU before the pool frees them; **adoption**
(``host_match_chain`` + ``adopt_from_host``) restores a new prompt's
matching chain blocks by H2D scatter instead of re-prefill.

Prefix-sharing interaction: blocks mapped by a sibling (refcount > 1)
never leave the pool -- the victim only drops its reference and records
how many leading blocks it rode on, and re-adopts them from the prefix
index at swap-in (or degrades to recompute when the share expired).

* **Victim selection** (:func:`pick_victim`): ``youngest`` (the identity
  oracle), ``most-blocks`` (free the most memory per eviction),
  ``slo-aware`` (evict the stream with the most remaining TTFT/deadline
  slack; streams without an SLO are preferred victims).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import model as M
from repro_torch.serving.engine import BlockPoolExhausted, _CHAIN_ROOT
from repro_torch.serving.trace import NULL_TRACER

PREEMPT_POLICIES = ("youngest", "most-blocks", "slo-aware")


@dataclass(frozen=True)
class StreamSLO:
    """Per-stream latency budgets, relative to the stream's arrival on
    the shared clock.  ``ttft_ms`` bounds time to the first verified
    emission, ``deadline_ms`` time to stream completion; ``inf`` means
    unconstrained (the stream is a preferred eviction victim under the
    ``slo-aware`` policy)."""
    ttft_ms: float = float("inf")
    deadline_ms: float = float("inf")


def pick_victim(policy: str, cands: list[int], sched) -> int:
    """Choose the eviction victim among candidate slots (all hold pool
    blocks, none is the protected oldest holder).  Ties break toward
    the youngest stream, which keeps ``youngest`` the exact pre-policy
    behaviour."""
    age = sched.slot_age
    if policy == "youngest":
        return max(cands, key=lambda s: age[s])
    if policy == "most-blocks":
        a = sched.engine.allocator

        def freeable(s):
            # only sole-owned blocks actually return to the pool;
            # ref>1 shared-lead blocks merely drop a reference
            return sum(1 for j in range(int(a.n_blocks_of[s]))
                       if int(a.ref[int(a.table[s, j])]) == 1)

        return max(cands, key=lambda s: (freeable(s), age[s]))
    if policy == "slo-aware":
        now = sched.clock.now_ms
        return max(cands, key=lambda s: (sched.slot_slack_ms(s, now),
                                         age[s]))
    raise ValueError(
        f"unknown preemption policy {policy!r}; have {PREEMPT_POLICIES}")


def _tree_map(fn, *trees):
    """Apply ``fn`` leafwise over payload trees (nested dicts of
    tensors)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _tree_cat(parts):
    """Concatenate payload trees along the block axis (axis 1)."""
    if len(parts) == 1:
        return parts[0]
    return _tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)


@dataclass
class HostBlock:
    """One content-addressed host-store entry (keyed by its chain hash
    in the manager's ``_store``): the gathered single-block k/v/pos
    payload, the exact ``(prev_hash, tokens)`` identity for collision
    verification, and a host-side refcount of swapped streams that will
    restore through it.  At ref 0 the entry parks on the host LRU
    (adoptable by future sessions) until capacity evicts it."""
    payload: object                # host tensor tree, one block wide
    prev: int
    tokens: tuple
    ref: int = 0


@dataclass
class SwappedStream:
    """Host-side metadata for one swapped-out stream: the block-table
    shape it had (total blocks, how many leading ones were shared), the
    cloud frontier to restore, the per-block disposition (``chain``:
    a content-store hash, or None for a residual-payload block) and the
    anonymous residual payload."""
    slot: int
    frontier: int                  # cloud_len at swap-out
    n_blocks: int                  # blocks the slot held (incl. shared lead)
    shared_lead: int               # leading blocks left in-pool (ref dropped)
    n_swap: int                    # blocks resident on the host
    nbytes: int                    # modeled bytes moved D2H (net of dedupe)
    probe: tuple                   # tokens re-matching the shared lead
    chain: tuple = ()              # per host block: chain hash | None
    payload: object = None         # residual host tree (k/v/pos per stack)

    @property
    def n_resid(self) -> int:
        """Host blocks carried privately (not content-addressed)."""
        return sum(1 for h in self.chain if h is None)


class HostSwapManager:
    """Host-side block store for swapped-out streams.

    Mechanism only: the scheduler decides *who* is evicted and *whether*
    swap beats recompute; this class executes the transfers (one gather
    or scatter across all layer stacks per direction; host payloads live
    in pinned CPU tensors when the pool is on a card) and keeps the
    per-stream metadata plus the shared content-addressed store.
    ``max_host_blocks`` caps total host residency (0 = unbounded) —
    ref-0 LRU entries are evicted to make room, but a victim whose
    *live* payload does not fit falls back to recompute.
    """

    def __init__(self, engine, max_host_blocks: int = 0,
                 host_dedupe: bool = True):
        self.engine = engine
        self.max_host_blocks = int(max_host_blocks)
        self.host_dedupe = bool(host_dedupe)
        self._streams: dict[int, SwappedStream] = {}   # slot -> stream, FIFO
        # content-addressed store: chain hash -> HostBlock; _lru holds
        # the ref-0 hashes in eviction order (first = oldest)
        self._store: dict[int, HostBlock] = {}
        self._lru: dict[int, None] = {}
        # tracing handle (serving/trace.py): installed by the scheduler
        # when tracing is on; NULL_TRACER keeps the guards free
        self.tracer = NULL_TRACER
        self.trace_replica = 0
        # telemetry (cumulative; pool_stats / ServerStats)
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.expired_shares = 0
        self.host_dedupe_hits = 0      # chain blocks shared instead of moved
        self.host_adopted_blocks = 0   # store blocks adopted at admission
        self.adopt_in_bytes = 0
        self.demoted_blocks = 0        # blocks parked at stream exit
        self._uncharged = 0            # bytes moved outside swap_out/in

    # -- introspection --------------------------------------------------
    @property
    def content_addressed(self) -> bool:
        """Whether the store keys blocks by chain hash (needs both the
        ``host_dedupe`` knob and engine-level prefix sharing — without
        registration there are no hashes to key by)."""
        return self.host_dedupe and bool(
            getattr(self.engine, "share_prefix", False))

    @property
    def swapped_blocks(self) -> int:
        """Host blocks held on behalf of live swapped streams (residual
        payloads + referenced store entries).  Ref-0 LRU entries are
        opportunistic cache, not live state — see host_lru_blocks."""
        live = sum(1 for e in self._store.values() if e.ref > 0)
        return sum(st.n_resid for st in self._streams.values()) + live

    @property
    def host_store_blocks(self) -> int:
        """All content-addressed store entries (live + LRU-parked)."""
        return len(self._store)

    @property
    def host_lru_blocks(self) -> int:
        """Store entries at ref 0 (adoptable, evictable)."""
        return len(self._lru)

    @property
    def swapped_slots(self) -> list[int]:
        """Swapped-out slots in swap-out (FIFO) order."""
        return list(self._streams)

    def holds(self, slot: int) -> bool:
        return slot in self._streams

    def blocks_needed(self, slot: int) -> int:
        """Fresh pool blocks a swap-in of ``slot`` must allocate (the
        shared lead re-adopts from the index at no block cost; device-
        tier revivals under retention can only shrink the real need)."""
        return self._streams[slot].n_swap

    def take_uncharged(self) -> int:
        """Drain host-link bytes moved outside the scheduler's explicit
        swap calls (admission adoptions, exit demotions); the scheduler
        charges them to the modeled clock."""
        n, self._uncharged = self._uncharged, 0
        return n

    def _to_host(self, tree, lo: int, hi: int):
        """Blocks ``[lo, hi)`` of a gathered device payload as host
        tensors: pinned, filled by an asynchronous copy when the pool is
        on a card (call :meth:`_host_sync` before the host reads them);
        a plain copy on the CPU."""
        pin = self.engine.device.type == "cuda"

        def one(x):
            part = x[:, lo:hi]
            if not pin:
                return part.clone()
            host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
            return host.copy_(part, non_blocking=True)

        return _tree_map(one, tree)

    def _host_sync(self) -> None:
        """Wait for the asynchronous D2H copies :meth:`_to_host` queued."""
        if self.engine.device.type == "cuda":
            torch.cuda.current_stream(self.engine.device).synchronize()

    def _host_total(self) -> int:
        return (sum(st.n_resid for st in self._streams.values())
                + len(self._store))

    def _store_match(self, h: int, prev: int, blk: tuple) -> bool:
        e = self._store.get(h)
        return e is not None and (e.prev, e.tokens) == (prev, blk)

    def _store_take(self, h: int, prev: int, blk: tuple) -> bool:
        """Dedupe hit: an identical block is already host-resident —
        take a reference instead of a transfer."""
        if not self._store_match(h, prev, blk):
            return False
        e = self._store[h]
        e.ref += 1
        self._lru.pop(h, None)
        self.host_dedupe_hits += 1
        return True

    def _touch_lru(self, h: int) -> None:
        """Refresh a ref-0 entry to MRU position (a hit is evidence of
        reuse)."""
        if h in self._lru:
            del self._lru[h]
            self._lru[h] = None

    def _release_chain(self, st: SwappedStream) -> None:
        """Drop a stream's references on its content-store entries."""
        for h in st.chain:
            if h is None:
                continue
            e = self._store.get(h)
            if e is None:
                continue
            e.ref = max(0, e.ref - 1)
            if e.ref == 0:
                self._lru[h] = None

    def _enforce_host_cap(self, keep=()) -> None:
        """Evict ref-0 LRU entries (oldest first) until total host
        residency fits ``max_host_blocks``."""
        if not self.max_host_blocks:
            return
        keep = set(keep)
        for h in list(self._lru):
            if self._host_total() <= self.max_host_blocks:
                break
            if h in keep:
                continue
            del self._lru[h]
            self._store.pop(h, None)

    def _split(self, bids: list[int]) -> list:
        """Per-block disposition for a victim's host-bound blocks:
        ``(h, prev, tokens, bid)`` for registered, realized blocks
        (content-addressed) or None (anonymous residual — unregistered
        decode/tail blocks, or everything when dedupe is off)."""
        if not self.content_addressed:
            return [None] * len(bids)
        a = self.engine.allocator
        out = []
        for b in bids:
            info = a.chain_of(b)
            if info is not None and b not in a._fill:
                out.append((info[0], info[1], info[2], b))
            else:
                out.append(None)
        return out

    def plan(self, slot: int) -> tuple[int, int, int] | None:
        """Whether ``slot`` can swap out, and at what cost: returns
        ``(shared_lead, n_swap, nbytes)`` or None when swap is not
        possible — no blocks, already swapped, an interior (non-leading)
        shared block (only leading prompt blocks can re-adopt), or the
        victim's live payload cannot fit the host cap even after LRU
        eviction.  ``nbytes`` is net of content-store dedupe hits, so
        the scheduler's swap-vs-recompute disposition sees the real
        (cheaper) transfer."""
        a = self.engine.allocator
        n = int(a.n_blocks_of[slot])
        if n == 0 or slot in self._streams:
            return None
        bids = [int(a.table[slot, j]) for j in range(n)]
        shared = [j for j, b in enumerate(bids) if int(a.ref[b]) > 1]
        if shared != list(range(len(shared))):
            return None
        n_swap = n - len(shared)
        entries = self._split(bids[len(shared):])
        hits = {e[0] for e in entries
                if e is not None and self._store_match(e[0], e[1], e[2])}
        n_new = n_swap - len(hits)
        if self.max_host_blocks:
            evictable = sum(1 for h in self._lru if h not in hits)
            if self._host_total() - evictable + n_new > self.max_host_blocks:
                return None
        return len(shared), n_swap, n_new * self.engine.block_bytes()

    # -- transfers ------------------------------------------------------
    def swap_out(self, slot: int, tokens, frontier: int) -> int | None:
        """Evict ``slot`` to the host store: peek its unshared blocks
        (k/v/pos across every layer stack), file registered ones in the
        content-addressed store (dedupe hits take a reference instead of
        a transfer), keep the rest as the stream's residual payload,
        drop its reference on shared-lead blocks, and return all its
        pool blocks to the allocator (truly freed ones are invalidated;
        under retention, registered blocks park on the cached-free LRU
        instead).  ``tokens`` must cover the shared lead (the stream's
        prompt) so the lead can be re-matched at swap-in.  Returns the
        modeled bytes moved, or None when the swap is not possible (the
        caller falls back to recompute-eviction)."""
        p = self.plan(slot)
        if p is None:
            return None
        lead, n_swap, nbytes = p
        a = self.engine.allocator
        bs = a.block_size
        if lead and (tokens is None or len(tokens) < lead * bs):
            return None                    # cannot re-match the lead later
        # the +1 sentinel only defeats match_prefix's len-1 cap; matching
        # compares full-block contents, never the trailing token
        probe = (tuple(int(t) for t in tokens[:lead * bs]) + (0,)
                 if lead else ())
        bids = [int(a.table[slot, j]) for j in range(lead, lead + n_swap)]
        entries = self._split(bids)
        chain: list = []
        new_entries: list = []
        for e, b in zip(entries, bids):
            if e is None:
                chain.append(None)
                continue
            h, prev, blk, _b = e
            chain.append(h)
            if not self._store_take(h, prev, blk):
                new_entries.append(e)
        resid_bids = [b for e, b in zip(entries, bids) if e is None]
        move_bids = [e[3] for e in new_entries] + resid_bids
        payload = None
        if move_bids:
            # one copying gather (the pool is written afterwards) and one
            # D2H transfer per stored block / residual payload
            peeked = M.peek_cache_blocks(self.engine.cache, move_bids)
            for i, (h, prev, blk, _b) in enumerate(new_entries):
                one = self._to_host(peeked, i, i + 1)
                self._store[h] = HostBlock(payload=one, prev=prev,
                                           tokens=blk, ref=1)
            if resid_bids:
                payload = self._to_host(peeked, len(new_entries),
                                        len(move_bids))
            self._host_sync()
        freed = a.release(slot)
        self.engine._invalidate_blocks(int(b) for b in freed)
        self.engine._tables_dirty = True
        self.engine._sync_tables()
        self._streams[slot] = SwappedStream(
            slot=slot, frontier=int(frontier), n_blocks=lead + n_swap,
            shared_lead=lead, n_swap=n_swap, nbytes=nbytes, probe=probe,
            chain=tuple(chain), payload=payload)
        self._enforce_host_cap(keep=[h for h in chain if h is not None])
        self.swap_out_bytes += nbytes
        return nbytes

    def swap_in(self, slot: int) -> tuple[int, int] | None:
        """Restore ``slot`` from the host store: re-adopt the shared
        lead from the prefix index (ref++), then rebuild the remaining
        blocks in position order — under device retention a chain block
        still registered in the pool is *revived* in place (no
        transfer); everything else scatters from the content store /
        residual payload into freshly allocated blocks (one donated
        dispatch).  Restored chain blocks re-register, so the share
        survives the round trip.  Returns ``(frontier, nbytes_moved)``
        — the caller restores the cloud frontier and charges the actual
        H2D bytes — or None when the shared lead has expired from the
        index (the sibling died): the stream's host references are
        dropped and it must recompute from scratch."""
        st = self._streams.pop(slot)
        a = self.engine.allocator
        if st.shared_lead:
            m = a.match_prefix(list(st.probe))
            if len(m) < st.shared_lead:
                self.expired_shares += 1
                self._release_chain(st)
                return None
            a.adopt_prefix(slot, m[:st.shared_lead])
            self.engine._tables_dirty = True
        scatter_bids: list[int] = []
        parts: list = []
        ri = 0
        for h in st.chain:
            if h is not None:
                e = self._store[h]
                bid = a._index.get(h) if a.retain_prefix else None
                if (bid is not None and bid not in a._fill
                        and a._contents.get(bid) == (e.prev, e.tokens)):
                    # device tier still holds this block (cached-free or
                    # live under a sibling): revive instead of scatter
                    a.map_block(slot, bid)
                    self.engine._tables_dirty = True
                    part = None
                else:
                    part = e.payload
                e.ref = max(0, e.ref - 1)
                if e.ref == 0:
                    self._lru[h] = None
            else:
                part = _tree_map(lambda x: x[:, ri:ri + 1], st.payload)
                ri += 1
            if part is not None:
                b = a.append_fresh(slot)
                if b is None:
                    raise BlockPoolExhausted(
                        f"swap-in of slot {slot} needs a fresh block; "
                        f"pool is dry — the scheduler must gate swap-ins "
                        f"on blocks_needed()")
                if h is not None:
                    e = self._store[h]
                    a.register_block(b, h, e.prev, e.tokens)
                scatter_bids.append(b)
                parts.append(part)
        moved = 0
        if scatter_bids:
            self.engine._flush_reclaims()
            M.swap_in_blocks(self.engine.cache, scatter_bids,
                             _tree_cat(parts))
            self.engine._tables_dirty = True
            moved = len(scatter_bids) * self.engine.block_bytes()
        self.engine._sync_tables()
        self.swap_in_bytes += moved
        return st.frontier, moved

    def drop(self, slot: int) -> None:
        """Discard a swapped stream's host state (its session ended
        without needing the cache again, or it degraded to recompute):
        the residual payload dies with the stream; content-store
        references are dropped (ref-0 entries stay adoptable on the
        host LRU until capacity evicts them)."""
        st = self._streams.pop(slot, None)
        if st is not None:
            self._release_chain(st)

    # -- content-addressed admission/exit flows -------------------------
    def host_match_chain(self, tokens, start_j: int) -> list[tuple]:
        """Continue a prompt's chain-hash walk beyond the device match
        (``start_j`` full blocks already adopted) against the content-
        addressed host store.  Returns ``[(hash, entry), ...]`` in chain
        order, stopping at the first miss; the same ``len(tokens) - 1``
        cap as ``match_prefix`` applies (a fully cached prompt still
        feeds its last token)."""
        if not self.content_addressed:
            return []
        a = self.engine.allocator
        if len(tokens) > a.s_max:
            return []
        bs = a.block_size
        n_full = min((len(tokens) - 1) // bs, a.max_blocks_per_slot)
        out = []
        h = _CHAIN_ROOT
        for j in range(n_full):
            blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            prev, h = h, hash((h, blk))
            if j < start_j:
                continue
            e = self._store.get(h)
            if e is None or (e.prev, e.tokens) != (prev, blk):
                break
            out.append((h, e))
        return out

    def adopt_from_host(self, slot: int, start_j: int,
                        entries: list[tuple]) -> int:
        """H2D-adopt host-store chain blocks into ``slot``'s freshly
        allocated blocks ``[start_j, start_j + len(entries))``: scatter
        the stored k/v/pos in one dispatch and register the blocks
        *realized* (their content is already on device, so a later
        divergent write must fork/unregister, never skip).  The engine's
        ``alloc_prompt`` has already allocated the destinations and
        flushed reclaims.  Returns bytes moved (also accumulated for
        ``take_uncharged``)."""
        a = self.engine.allocator
        bids = [int(a.table[slot, start_j + i]) for i in range(len(entries))]
        M.swap_in_blocks(self.engine.cache, bids,
                         _tree_cat([e.payload for _h, e in entries]))
        self.engine._tables_dirty = True
        for (h, e), b in zip(entries, bids):
            a.register_block(b, h, e.prev, e.tokens)
            self._touch_lru(h)
        moved = len(entries) * self.engine.block_bytes()
        self.host_adopted_blocks += len(entries)
        self.adopt_in_bytes += moved
        self._uncharged += moved
        if self.tracer.enabled:
            self.tracer.instant("host_adopt", replica=self.trace_replica,
                                slot=slot, n=len(entries))
        return moved

    def demote_slot(self, slot: int) -> int:
        """Content-addressed demotion at stream exit: peek the slot's
        sole-owned (ref == 1), registered, realized blocks that the host
        store does not already hold and park them on the host LRU —
        the last live sharer of a recurring prefix leaves its KV
        adoptable by future sessions even though the device pool frees
        the blocks.  Called by ``engine.reset_slot`` *before* the
        allocator release (the pool content must still be readable).
        Returns bytes moved (accumulated for ``take_uncharged``)."""
        if not self.content_addressed or slot in self._streams:
            return 0
        a = self.engine.allocator
        cand = []
        for j in range(int(a.n_blocks_of[slot])):
            b = int(a.table[slot, j])
            if b < 0 or int(a.ref[b]) != 1 or b in a._fill:
                continue
            info = a.chain_of(b)
            if info is None:
                continue
            h, prev, blk = info
            if self._store_match(h, prev, blk):
                self._touch_lru(h)
                continue
            cand.append((h, prev, blk, b))
        if self.max_host_blocks:
            # demotion never displaces live payload: cap the candidates
            # to what fits after evicting stale ref-0 LRU entries
            room = (self.max_host_blocks - self._host_total()
                    + len(self._lru))
            cand = cand[:max(0, room)]
        if not cand:
            return 0
        peeked = M.peek_cache_blocks(self.engine.cache,
                                     [c[3] for c in cand])
        for i, (h, prev, blk, _b) in enumerate(cand):
            self._store[h] = HostBlock(payload=self._to_host(peeked, i, i + 1),
                                       prev=prev, tokens=blk)
            self._lru[h] = None
        self._host_sync()
        self.demoted_blocks += len(cand)
        moved = len(cand) * self.engine.block_bytes()
        self._uncharged += moved
        if self.tracer.enabled:
            self.tracer.instant("host_demote", replica=self.trace_replica,
                                slot=slot, n=len(cand))
        self._enforce_host_cap()
        return moved
