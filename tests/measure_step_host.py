"""The sharded step's host side on one card: whether its shares overlap on
the card, and where the host's time to enqueue a call goes
(divergence_tpu_torch/parallel/sharded.py).

On the 200 k-SNP workload's windows (chip_smoke.py's CSS_WORKLOADS[2] at
11 + 10, gathered at P = 128 and padded to a multiple of four: 20,000
windows):

* chip_smoke.step_shares: the step over 1 share, over the four shares of
  the card one after another and at once, medians of 3 warm walls, each
  share's device interval (CUDA events on its stream) and their overlap,
  every call byte-equal to 1 share and the launches equal;
* the host's time to enqueue one warm call (no synchronise inside it),
  10 calls each over 1 and 4 shares, and cProfile's functions by their
  own time over those calls.

Usage, on a machine with a CUDA GPU, from the repository root::

    python tests/measure_step_host.py
"""

import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.kernels import fet as kfet  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402
from divergence_tpu_torch.parallel import make_divergence_step, make_mesh  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

NAMES = ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits")


def main() -> int:
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    npos_, region, seed = cs.CSS_WORKLOADS[2][:3]
    pos, am, bm = make_chromosome(npos_, region, cs.ASIZE, cs.BSIZE, seed)
    lo, npos, slot = cs.windows_of(torch, pos, region)
    av, bv, Bp = cs.gather_windows(torch, SnpPair(pos, am, bm).to_device(dev), lo, npos,
                                   cs.STEP_P, cs.STEP_SHARES)
    pad = torch.zeros(Bp - lo.numel(), dtype=torch.int64)
    npos, slot = torch.cat([npos, pad]), torch.cat([slot, pad])
    key = rng.prng_key(0)
    steps = {n: make_divergence_step(make_mesh(devices=[dev] * n), cs.ASIZE, cs.BSIZE)
             for n in (1, cs.STEP_SHARES)}
    args = (av, bv, npos, slot, key)
    ref = steps[1](*args)
    cs.step_shares(torch, kfet, kcss, kperm, steps[1], steps[cs.STEP_SHARES], args, ref, NAMES,
                   card)
    for n, step in steps.items():
        step(*args)
        torch.cuda.synchronize()
        enqueue, prof = [], cProfile.Profile()
        for _ in range(10):
            t0 = time.perf_counter()
            prof.enable()
            step(*args)
            prof.disable()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        print(f"[step host] {Bp} windows over {n} share(s): host ms to enqueue a warm call "
              f"(no synchronise inside), sorted: {[round(ms, 2) for ms in sorted(enqueue)]} "
              f"on {card}", flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
