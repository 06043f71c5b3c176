"""Reduction of a ``torch.profiler`` Chrome trace of one traced stretch
to what the per-layer metrics and the result's ``device`` and
``breakdown`` read: device busy time, idle gaps by what the host was
doing, and device time by kernel name."""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
STRETCH = "bench.stretch"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)     # full name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # label -> seconds

    def kernel_seconds(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(p in n for p in patterns))

    def device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, s in self.kernel_s.items():
            by[short_name(name)] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                           key=lambda kv: -kv[1])[:n]]


def summarize(path: str) -> TraceSummary | None:
    """The stretch between the ``bench.stretch`` annotation's ends, or
    None when the trace holds no such annotation or no device work."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == STRETCH
            and e.get("cat") == "user_annotation"]
    if not span:
        return None
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    dev, host, kernel_s = [], [], defaultdict(float)
    for e in events:
        cat = e.get("cat")
        if "ts" not in e or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                dev.append((s, t))
                if cat == "kernel":
                    kernel_s[e["name"]] += (t - s) / 1e6
        elif cat in HOST_CATS and e.get("name") != STRETCH:
            if s < hi and t > lo:
                host.append((s, t, e["name"]))
    if not dev:
        return None
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) / 1e6
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, t in gaps:
        mid = (s + t) / 2
        label = "host (outside any op)"
        # the latest-starting host event that covers the gap's middle is
        # the innermost one of a nest
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 513), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += (t - s) / 1e6
    return TraceSummary(window_s=(hi - lo) / 1e6, busy_s=busy_s,
                        kernel_s=dict(kernel_s), idle_by_host=dict(idle))
