"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size, many seeds in one process:

    python3 cimbench/calibrate.py --workload NAME --first SEED --seeds N

For each seed, one JSON line: the numbers of the program's sound run
(set-up, then ``CALLS`` calls of the window's own), of the control (the
reference on TF32 products in the program's place), and of each fault of
the cell's runner kind planted under the timed path, all on the first
CUDA device.  The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from cimbench import manifest, runners  # noqa: E402

CALLS = 3          # window calls after set-up, as in a run's window


def readings(cell: dict, traffic: dict, seed: int, dev) -> dict:
    config = manifest.config(manifest.load(), cell["config"])
    kind = runners.load(traffic["runner"])

    def sound_run():
        runner = kind.Runner(config, traffic, seed, dev)
        for i in range(CALLS):
            out = runner.call(i)
            runners.sync(dev)
            runner.keep(i, out)
        return runner

    runner = sound_run()
    out = {"seed": seed, "program": runner.numbers(),
           "control": runner.control_numbers(), "faults": {}}
    del runner
    for name, planted in kind.FAULTS.items():
        with planted():
            broken = sound_run()
        out["faults"][name] = broken.numbers()
        del broken
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="cimbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.workload(manifest.load(), args.workload)
    traffic = manifest.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    for n in range(args.seeds):
        t0 = time.perf_counter()
        rec = readings(cell, traffic, args.first + 7919 * n, dev)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": cell["name"], **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
