"""Cloud execution engine: slot-based continuous batching (port of
``repro/serving/engine.py``, dense-cache path).

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
  slot's positions invalid.
* ``feed_logits`` / ``decode_logits`` are the legacy/debug path that
  round-trips the full (slots, chunk, V) tensor.

Ragged per-slot chunks are padded to the iteration width; padded entries
carry position -1, which ``cache_write`` drops.  Chunk widths snap to a
fixed bucket ladder, so the set of shapes the steps see stays bounded
(``compile_stats`` reports the ones taken) -- the precondition for
capturing them as CUDA graphs later.

The paged cache (``BlockAllocator``, prefix sharing, swap) arrives with
the next slice of the port; ``cache_impl="paged"`` raises here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.steps import (make_cloud_decode_step,
                                      make_cloud_verify_step,
                                      make_decode_step, make_verify_step)
from repro_torch.runtime import resolve_device

DEFAULT_FEED_BUCKETS = (8, 16, 32, 64, 128, 256)


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
    """Fixed-slot serving engine for one model (dense KV cache)."""

    def __init__(self, cfg, params, *, max_slots: int = 8, s_max: int = 2048,
                 window: int = 0, verify_top_k: int = 8,
                 verify_rows_max: int = 8,
                 feed_buckets: tuple = DEFAULT_FEED_BUCKETS,
                 cache_impl: str | None = None, device=None):
        self.cache_impl = cache_impl or getattr(cfg, "cache_impl", "dense")
        if self.cache_impl != "dense":
            raise NotImplementedError(
                "cache_impl='paged' (block allocator, prefix sharing, swap) "
                "arrives with the next slice of the port")
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
        # the paged-cache hooks the scheduler probes stay inert
        self.allocator = None
        self.swap_manager = None
        self.cache = M.init_cache(cfg, max_slots, s_max, device=self.device)
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
        # telemetry: host transfer + shape accounting
        self.bytes_to_host = 0
        self._calls = {"feed": 0, "prefill": 0, "decode": 0,
                       "feed_logits": 0, "decode_logits": 0}
        self._specializations: set = set()

    def _dev(self, arr, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=self.device)

    # -- telemetry ------------------------------------------------------
    @property
    def compile_stats(self) -> dict:
        """Which (step, bucket) shapes this engine ran, and how often each
        entry point ran — the bucket ladder bounds the set of shapes."""
        return dict(
            calls=dict(self._calls),
            buckets=sorted({b for kind, b in self._specializations
                            if kind in ("fused", "fused_greedy")}),
            specializations=sorted(self._specializations),
            n_specializations=len(self._specializations),
            bytes_to_host=self.bytes_to_host,
        )

    # -- cache management ----------------------------------------------
    def reset_slot(self, slot: int):
        """Invalidate a slot's cache: positions -> -1 (stale K/V at invalid
        positions is never attended to)."""
        self.cache["layers"]["pos"][:, slot, :] = -1

    def kv_cache_bytes(self) -> int:
        """Total bytes backing the KV cache."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.cache["layers"].values()))

    @property
    def pool_stats(self) -> dict:
        """Block-pool telemetry (ServerStats).  A dense engine reports its
        full reservation as in use: dense memory cost is ``max_slots x
        s_max`` regardless of actual sequence lengths."""
        total = self.kv_cache_bytes()
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
                   with_dists=True):
        """One fused sub-chunk; returns device outputs.  Callers copy to
        the host only what they need."""
        C = tokens.shape[1]
        Cb = self._bucket_of(C)
        self._specializations.add(
            ("fused" if with_dists else "fused_greedy", Cb))
        step = self._step if with_dists else self._step_greedy
        out, self.cache = step(
            self.params, self.cache,
            self._dev(self._pad(tokens, Cb, 0), torch.long),
            self._dev(self._pad(positions, Cb, -1)),
            self._dev(self._pad(targets, Cb, -1)),
            self._dev(sel_idx), self._dev(last_local))
        return out

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
                                  with_dists=need_dists)
            if in_chunk.any():      # only selected rows cross to the host
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
        self.bytes_to_host += moved_bytes
        return VerifyRows(token_id=tok_acc, p_draft=p_acc,
                          topk_idx=ki_acc, topk_val=kv_acc)

    def prefill(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Prompt prefill over all slots.  Returns each slot's LAST valid
        row's full logits (max_slots, V) — gathered on device, one
        vocab-row per slot — and writes the cache.  Slots with no valid
        positions return zeros."""
        self._calls["prefill"] += 1
        B, C = tokens.shape
        valid = positions >= 0
        # last valid column per slot (-1 = idle)
        last_col = np.where(valid.any(axis=1),
                            C - 1 - np.argmax(valid[:, ::-1], axis=1), -1)
        targets = np.full((B, C), -1, np.int32)
        no_sel = np.full((B, self.verify_rows_max), -1, np.int32)
        out = np.zeros((B, self.vocab), np.float32)
        for off, w in self._chunks(C):
            sl = slice(off, off + w)
            if not (positions[:, sl] >= 0).any():
                continue
            local = np.clip(last_col - off, 0, w - 1).astype(np.int32)
            # only the last-row gather is consumed: the argmax-only step
            res = self._run_fused(tokens[:, sl], positions[:, sl],
                                  targets[:, sl], no_sel, local,
                                  with_dists=False)
            sel = (last_col >= off) & (last_col < off + w)
            if sel.any():
                # gather on device only the slots whose LAST prompt row
                # lives in this sub-chunk: one vocab row per prefilled slot
                idx = np.where(sel)[0]
                rows = _host(res[4][self._dev(idx, torch.long)], np.float32)
                out[idx] = rows
                self.bytes_to_host += rows.nbytes
        return out

    def decode(self, tokens: np.ndarray, positions: np.ndarray) -> DecodeRows:
        """One decode step for all slots. tokens/positions: (max_slots, 1).

        Returns fused last-token rows (argmax + top-k support)."""
        self._calls["decode"] += 1
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
        self._specializations.add(("raw_decode", 1))
        logits, self.cache = self._raw_decode(
            self.params, self.cache, self._dev(tokens, torch.long),
            self._dev(positions))
        out = _host(logits.float(), np.float32)
        self.bytes_to_host += out.nbytes
        return out
