"""Entry point of the benchmark: run one cell of BENCHMARK.json.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints one JSON object as the last
line of standard output; the numbers the check compares, each with its
limit, end standard error.  Exits non-zero, with no result, when the
cell's CUDA devices are missing, or when JAX or the JAX package was
loaded in the process.
"""
import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed places inside the checkout (the port's nvcc
# libraries go to build/kernels/ by themselves)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

import bench_harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench_harness.main(sys.argv[1:], root=ROOT, t_start=T_START))
