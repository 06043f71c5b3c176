"""Host time of one grouped_mm call on the card, at the decode shapes.

    PYTHONPATH=src python tools/gmm_host_time.py [--label NAME]

Times the host side of ``torch.ops.repro_torch.grouped_mm`` (bf16): runs
of BURST calls back to back from a drained stream, too few to fill the
launch queue, so a run's wall time over its calls is the host's work a
call (argument checks, the output's and the split partials' allocation,
the tensor maps, the launches) and none of the kernel's.  The least and
the median of RUNS runs are printed, one JSON line a case, beside the
card's name and power limit.  Two readings a case:
``same_x`` calls with one x, as a step that reuses an activation buffer;
``new_x`` rotates over X_BUFFERS x buffers, so a table of encoded tensor
maps kept across calls (one entry an x box, 256 entries) would miss on
every call.  Where the library's C
entry point takes the split partials (the TMA design), its call alone is
timed too, the same two ways (``c_same_x``, ``c_new_x``): the tensor
maps and the launches, without PyTorch's dispatch.  The kernel is built
from the ``src`` on PYTHONPATH, so the same script times any checkout of
the port: run it from each in one call to compare them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import DTYPE_CODES, build, stream_ptr
from repro_torch.kernels import grouped_mm as GM  # registers the op

# (label, experts, experts a token, tokens, K, N): the MoE decode steps'
# products (qwen3-moe: 4 sequences, gate/up and down; llama4-maverick:
# 4 sequences, one expert each, K split in parts)
CASES = [("qwen3-moe decode, gate/up", 128, 8, 4, 4096, 1536),
         ("qwen3-moe decode, down", 128, 8, 4, 1536, 4096),
         ("llama4 decode, gate/up", 128, 1, 4, 5120, 8192),
         ("llama4 decode, down", 128, 1, 4, 8192, 5120)]
BURST, RUNS = 50, 20  # calls a run, runs a reading
X_BUFFERS = 300


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _host_us(call, xs) -> tuple[float, float]:
    """(least, median) over RUNS runs of a run's host microseconds a call:
    BURST calls of ``call(x)`` back to back from a drained stream, x
    taken in turn from ``xs``."""
    for x in xs[:3]:          # build, first launches
        call(x)
    per_call, i = [], 0
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BURST):
            call(xs[i % len(xs)])
            i += 1
        per_call.append((time.perf_counter() - t0) / BURST * 1e6)
    torch.cuda.synchronize()
    return min(per_call), statistics.median(per_call)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gmm_host_time: needs a CUDA device")
    card = _card()
    for i, (label, E, k, T, K, N) in enumerate(CASES):
        rng = np.random.default_rng(args.seed + i)
        counts = np.zeros(E, np.int64)
        for _ in range(T):
            counts[rng.choice(E, size=k, replace=False)] += 1
        M = T * k
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int32,
                            device="cuda")
        g = torch.Generator(device="cuda").manual_seed(args.seed + i)
        w = torch.randn(E, K, N, generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(K ** -0.5)
        xs = [torch.randn(M, K, generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(X_BUFFERS)]
        op = torch.ops.repro_torch.grouped_mm

        def call(x):
            return op(x, w, ends, False)

        same, new = _host_us(call, xs[:1]), _host_us(call, xs)
        rec = dict(label=args.label, case=label, rows=M, K=K, N=N,
                   experts_with_rows=int((counts > 0).sum()),
                   same_x_host_us_least=same[0],
                   same_x_host_us_median=same[1],
                   new_x_host_us_least=new[0], new_x_host_us_median=new[1],
                   card=card)
        launch = build.library("grouped_mm").grouped_mm_launch
        if len(launch.argtypes) == 14:      # (.., y, part, M, K, N, ..)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits = GM.fwd_splits(M, K, N, E, sms)
            ctas = GM.fwd_ctas(M, N, E, splits, sms)
            y = xs[0].new_empty(M, N)
            part = torch.empty(splits, M, N, dtype=torch.float32,
                               device="cuda")

            def c_call(x):
                launch(x.data_ptr(), w.data_ptr(), ends.data_ptr(),
                       y.data_ptr(), part.data_ptr() if splits > 1 else None,
                       M, K, N, E, 0, DTYPE_CODES[torch.bfloat16], splits,
                       ctas, stream_ptr(x))

            c_same, c_new = _host_us(c_call, xs[:1]), _host_us(c_call, xs)
            rec.update(splits=splits, c_same_x_host_us_least=c_same[0],
                       c_same_x_host_us_median=c_same[1],
                       c_new_x_host_us_least=c_new[0],
                       c_new_x_host_us_median=c_new[1])
        print(json.dumps(rec), flush=True)
        del w, xs, ends
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
