"""Device<->cloud WAN link and latency/energy models (a copy of
``repro/serving/link.py``).

Wall-clock numbers for the Jetson/Pixel device and the A6000 cloud of
the paper are *modeled* with calibrated constants (paper §6: SLM TBT tens of ms on Jetson; LLM verification
~100-400 ms; bandwidths 0.1-100 Mbps).  Transfer *sizes* are computed
exactly from the real payloads (tokens + compressed distributions), which
is what the paper's bandwidth study (Fig 13) measures.

Token streams themselves are produced by the real models; only the
serving clock is simulated (the port's wall time on a GPU is measured
separately, around these calls).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class SimClock:
    """Shared discrete-event clock (absolute simulated milliseconds).

    One instance is shared by the ``SyneraServer`` event loop and the
    ``VerificationAwareScheduler`` so that device-stream arrival times
    and cloud iteration costs live on a single time axis: the scheduler
    fast-forwards to the next request arrival when idle and advances by
    iteration cost when busy, so per-stream round-trip times measured
    against this clock include real cross-stream queueing.
    """
    now_ms: float = 0.0

    def advance(self, dt_ms: float) -> float:
        self.now_ms += dt_ms
        return self.now_ms

    def advance_to(self, t_ms: float) -> float:
        """Fast-forward (never rewind) to an absolute time."""
        self.now_ms = max(self.now_ms, t_ms)
        return self.now_ms


@dataclass
class RealClock:
    """Wall-clock drop-in for :class:`SimClock` (serving/gateway).

    ``now_ms`` reads the monotonic clock, so arrival gating, queueing
    delays and completion times measured against this clock are *real*
    — the axis a network client experiences.  The modeled costs the
    scheduler charges via :meth:`advance` / :meth:`advance_to` do not
    move real time; instead they accumulate into ``modeled_ms`` with
    SimClock semantics (advance adds, advance_to fast-forwards), a
    shadow of where the simulated clock would stand on the same
    schedule.  Comparing ``now_ms`` against ``modeled_ms`` at any point
    is the modeled-vs-real cross-check: the gap is work the latency
    model does not account for (real compute, GC, socket overhead).

    ``pace=True`` additionally *sleeps* through modeled costs and idle
    fast-forwards, so cloud events land at roughly their modeled wall
    times (real >= modeled; the excess is host compute).  Long idle
    waits sleep in bounded slices and may return early — callers
    (scheduler/server loops) re-invoke until the clock catches up, so
    cancellation stays responsive.
    """
    pace: bool = False
    max_sleep_ms: float = 50.0     # per-call sleep slice (pace mode)
    modeled_ms: float = 0.0        # shadow SimClock on the same schedule
    _t0: float = field(default_factory=time.monotonic)

    @property
    def now_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    def advance(self, dt_ms: float) -> float:
        self.modeled_ms += dt_ms
        if self.pace and dt_ms > 0:
            time.sleep(dt_ms / 1e3)
        return self.now_ms

    def advance_to(self, t_ms: float) -> float:
        """Fast-forward the modeled shadow; real time cannot jump.  In
        pace mode, sleep toward ``t_ms`` (one bounded slice)."""
        self.modeled_ms = max(self.modeled_ms, t_ms)
        if self.pace:
            wait = min(t_ms - self.now_ms, self.max_sleep_ms)
            if wait > 0:
                time.sleep(wait / 1e3)
        return self.now_ms


@dataclass
class LinkModel:
    bandwidth_mbps: float = 10.0
    rtt_ms: float = 20.0

    def transfer_ms(self, nbytes: int) -> float:
        bits = nbytes * 8.0
        return self.rtt_ms / 2.0 + bits / (self.bandwidth_mbps * 1e6) * 1e3


@dataclass
class DeviceLatencyModel:
    """Per-token SLM compute on the device (Jetson AGX Orin class)."""
    ms_per_token: float = 30.0          # full-depth forward
    ms_fixed: float = 2.0               # dispatch overhead per forward
    energy_j_per_token: float = 1.86    # paper Table 5, edge-centric
    scheduling_ms_per_token: float = 0.4  # paper Table 5: <0.5ms

    def draft_ms(self, n_tokens: int, layer_frac: float = 1.0) -> float:
        """layer_frac < 1 models layer-wise early exit savings."""
        return self.ms_fixed + n_tokens * self.ms_per_token * layer_frac

    def energy_j(self, n_tokens: int, layer_frac: float = 1.0) -> float:
        return n_tokens * self.energy_j_per_token * layer_frac


@dataclass
class CloudLatencyModel:
    """Cloud engine iteration cost (A6000-class, continuous batching).

    ms_base calibrated to a 13B bf16 verifier on A6000: the decode/verify
    iteration floor is the weight stream (~26 GB / ~650 GB/s ~ 40 ms),
    amortized across the batched slots of one iteration.

    ``host_link_gbps`` models the accelerator->host interconnect the
    scheduler's verifier state crosses every iteration (PCIe-class, GB/s;
    effective D2H with sync overheads).  This term is what makes the
    engine's measured ``bytes_to_host`` show up in modeled serving time —
    a full-vocab logits round trip (e.g. 8 slots x 32 chunk x 128k vocab
    x 4B = 128 MiB/iter) costs ~21 ms here, the fused rows microseconds.
    """
    ms_base: float = 40.0               # per-iteration fixed cost
    ms_per_token: float = 0.12          # per (token x slot) in the batch
    ms_scheduler: float = 0.5           # verification-aware scheduling overhead
    prefill_ms_per_token: float = 0.25
    host_link_gbps: float = 6.0         # effective D2H bandwidth (GB/s)

    def iteration_ms(self, total_tokens: int) -> float:
        return self.ms_base + self.ms_scheduler + total_tokens * self.ms_per_token

    def prefill_ms(self, total_tokens: int) -> float:
        return self.ms_base + total_tokens * self.prefill_ms_per_token

    def host_transfer_ms(self, nbytes: int) -> float:
        return nbytes / (self.host_link_gbps * 1e9) * 1e3

    # -- swap-vs-recompute disposition (serving/swap.py) ----------------
    def swap_roundtrip_ms(self, nbytes: int) -> float:
        """Modeled cost of evicting a stream to host memory and later
        restoring it: the D2H gather plus the H2D scatter, both charged
        through ``host_link_gbps`` on the measured block bytes."""
        return 2.0 * self.host_transfer_ms(nbytes)

    def refeed_ms(self, n_tokens: int, chunk: int) -> float:
        """Modeled cost of recompute-eviction: the victim's accepted
        prefix re-feeds as from-scratch partial prefills, i.e. about
        ``ceil(n/chunk)`` extra verify iterations' fixed cost plus the
        per-token compute."""
        n_iters = -(-max(int(n_tokens), 0) // max(int(chunk), 1))
        return (n_iters * (self.ms_base + self.ms_scheduler)
                + n_tokens * self.ms_per_token)


@dataclass
class CostModel:
    """Estimated cloud serving cost (paper §6.1): c = (1/Pf) * T * W.

    Pf = packing factor (Table 3), T = average TBT, W = fraction of tokens
    that hit the cloud."""
    packing_factor: float = 13.0   # Llama-7B-class verifier

    def cost(self, avg_tbt_ms: float, cloud_token_frac: float) -> float:
        return (1.0 / self.packing_factor) * avg_tbt_ms * cloud_token_frac
