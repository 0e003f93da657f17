"""The benchmark of ``divergence_tpu_torch`` on NVIDIA GPUs.

    python -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).  Exits non-zero, printing no result, without a CUDA device
(or fewer than the cell asks for), where JAX or the JAX package was
loaded, or where the system under test is missing.

The kernel library builds into ``divergence_tpu_torch/_build/`` inside the
checkout; other compiler caches are pointed at ``.gpubench_cache/``
there, so that only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".gpubench_cache"


def _caches() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    from gpubench import harness

    chips = harness.cell(ROOT, harness.load_bench(ROOT), args.workload)["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"gpubench: needs {chips} CUDA device(s); "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
