#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch and CUDA port once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see harness/main.py)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
