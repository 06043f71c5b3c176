"""Preemption policy layer (port of ``repro/serving/swap.py``, policy
half).

The scheduler imports the victim-selection policies and the per-stream
SLO budgets from here.  The host-memory KV swap tier
(``HostSwapManager``) needs the paged cache and arrives with the next
slice of the port; until then ``CloudEngine.swap_manager`` is None and
the scheduler's swap branches stay inert.

* **Victim selection** (:func:`pick_victim`): ``youngest`` (the identity
  oracle), ``most-blocks`` (free the most memory per eviction),
  ``slo-aware`` (evict the stream with the most remaining TTFT/deadline
  slack; streams without an SLO are preferred victims).
"""
from __future__ import annotations

from dataclasses import dataclass

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
