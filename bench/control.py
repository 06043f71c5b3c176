"""The correctness check's two readings on the card, for setting a
cell's limit: for each seed, one short run of the cell and, over the
same sample of finished sessions, the gaps of the tokens the program
chose (the lower reading's) and of the tokens the control, the
reference computed in fp8 in the program's place, puts first (the upper
reading's).  Each side is held to the configuration's limits by the
same verdict that sets a run's ``correct``: the control has to come out
not correct.  The benchmark's own runs do not run the control.

    python3 bench/control.py --workload <name> --seeds 1 2 3 --seconds 10

Prints one JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

import numpy as np  # noqa: E402

import bench_harness as H  # noqa: E402
import bench_traffic  # noqa: E402


def stats(gaps: np.ndarray) -> dict:
    """The numbers the check can compare, and the tokens they cover."""
    return dict(H.gap_numbers(gaps), tokens=int(gaps.size))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bm = H.load_benchmark(ROOT)
    cell, entry = H.find_cell(bm, args.workload)
    cfg = H.load_config(ROOT, entry)
    spec = bench_traffic.load(ROOT / "bench", cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.monotonic()
        res = H.run_cell(cfg, spec, seed=seed, seconds=args.seconds,
                         trace=False, metrics=[], per_layer=[],
                         device="cuda", control=True)
        ctl = res["control"]
        rec = {"workload": args.workload, "seed": seed,
               "limits": cfg["check"]["limits"],
               "correct": res["correct"],
               "control_correct": ctl["correct"],
               "program": stats(ctl["program"]),
               "control": stats(ctl["control"]),
               "seconds": time.monotonic() - t0,
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
