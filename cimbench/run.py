"""The benchmark's command: one run of one cell on this machine's card.

    python3 cimbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The set-up time counts from the start
of this script.  Kernel and compiler caches stay inside the checkout, at
fixed paths under ``build/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

from cimbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
