"""Readings for the check's limits (not run by the benchmark's runs).

    python -m gpubench.control --workload <name> --seeds <n> [<n> ...] [--control <k>]

For each seed, in one process: the program's numbers, each group of the
mix scanned once (the answers a run compares), and, for the first ``k``
seeds (all by default), the control's, the reference put in the program's
place in bfloat16
(:func:`gpubench.check.control_outputs`).  One JSON line a seed and side on
standard output.  A limit lies above the program's readings over a dozen
seeds or more and below the control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from gpubench import check, harness, scans, traffic

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, seeds, device, controls=None):
    spec = harness.cell(root, harness.load_bench(root), workload)
    config, mix, rules = spec["config"], spec["traffic"], spec["rules"]
    for i, seed in enumerate(seeds):
        chroms = traffic.chromosomes(config, mix, seed, device)
        per = int(mix["per_scan"])
        groups = [chroms[j:j + per] for j in range(0, len(chroms), per)]
        sides = ("program", "control") if controls is None or i < controls else ("program",)
        for side in sides:
            t0 = time.perf_counter()
            if side == "program":
                program = scans.Program(config, mix, seed, device)
                outputs = {k: v for g in groups
                           for k, v in program.scan(g, time.perf_counter).outputs.items()}
                del program
            else:
                outputs = check.control_outputs(mix["scan"], config, rules, chroms, seed, device)
            nums = check.numbers(mix["scan"], config, rules, chroms, outputs, seed, device)
            nums["repeat_mismatch"] = 0
            correct, _ = check.verdict(nums, rules["limits"])
            yield {"workload": workload, "seed": seed, "side": side, "correct": correct,
                   "seconds": time.perf_counter() - t0, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="run the control on the first k seeds only")
    args = ap.parse_args(argv)
    import torch

    for row in readings(ROOT, args.workload, args.seeds, torch.device("cuda", 0), args.control):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
