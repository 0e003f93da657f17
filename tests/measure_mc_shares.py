"""The sharded MC's shares on one card: where a design of the four-share
run loses its wall (kernels/perm.py: _over_shares, _sums_over_shares).

On the 16x worst case (chip_smoke.py's WORST_CSS at 11 + 10, 15,997
windows) over four shares of the card, medians of 5 warm calls, host
clock around a synchronise, each four-share result checked byte-equal to
the unsharded one:

* the window stream (K8): the package's run, and the same with each
  share making its own window keys in its thread (``keys in shares``:
  the ~100 small torch ops of ``rng.window_keys`` per thread), with each
  share's host time to its first launch;
* approx mode (K9, both streams): the package's run (every share's power
  sums enqueued from one thread, one fit), a thread a share that fits its
  own windows (``thread a share``), and the shares one after another,
  with the host time in the Pearson-III fit (``_pearson3_tail``) and in
  the power sums' wrapper.

Usage, on a machine with a CUDA GPU, from the repository root::

    python tests/measure_mc_shares.py
"""

import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402
from divergence_tpu_torch.parallel import make_mesh, window_slices  # noqa: E402

FIELDS = ("pvals", "nscores", "hits")
REPS = 5


def joined(parts):
    return kperm.McResult(*(np.concatenate([getattr(r, f) for r in parts]) for f in FIELDS))


def same(a, b) -> bool:
    return all(getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in FIELDS)


def medians(ways: dict, ref) -> str:
    walls = {k: [] for k in ways}
    for fn in ways.values():
        fn()                                             # warm
    for _ in range(REPS):
        for name, fn in ways.items():
            out, ms = cs.host_ms(torch, fn)
            walls[name].append(ms)
            if not same(out, ref):
                raise SystemExit(f"{name}: differs from the unsharded run")
    return "; ".join(f"{k} {statistics.median(v):.1f} ms" for k, v in walls.items())


def first_launches(fn) -> list:
    """Host ms from the call's start to each share thread's first launch."""
    orig, first, t0 = kperm.launch, {}, [0.0]

    def logged(*args):
        first.setdefault(threading.get_ident(), (time.perf_counter() - t0[0]) * 1e3)
        return orig(*args)

    kperm.launch = logged
    try:
        torch.cuda.synchronize()
        t0[0] = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    finally:
        kperm.launch = orig
    return sorted(round(v, 1) for v in first.values())


def host_split(fn) -> str:
    """Host ms in the fit and in the power sums' wrapper (all threads)."""
    tail, sums = kperm._pearson3_tail, kperm.null_power_sums
    spent = {"fit": 0.0, "sums": 0.0}

    def timed(name, f):
        def g(*args):
            t = time.perf_counter()
            try:
                return f(*args)
            finally:
                spent[name] += (time.perf_counter() - t) * 1e3
        return g

    kperm._pearson3_tail, kperm.null_power_sums = timed("fit", tail), timed("sums", sums)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kperm._pearson3_tail, kperm.null_power_sums = tail, sums
    return f"fit {spent['fit']:.1f} ms, power sums' wrapper {spent['sums']:.1f} ms"


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_mc_shares: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    dist, scores, chroms, slots = cs.mc_windows(torch, (*cs.WORST_CSS, cs.WORST_SEED),
                                                torch.device("cuda", 0))
    dev = dist.device
    mesh = make_mesh(devices=[dev] * 4)
    shares = window_slices(len(scores), mesh)
    key = rng.fold_in(rng.prng_key(0), 2)
    a, b = cs.ASIZE, cs.BSIZE

    # the window stream: the keys made before the split, or in each share
    def window(sharding=None):
        return kperm.significance(dist, scores, a, b, 10, cs.MC_RUNS, key, chunk=256,
                                  chroms=chroms, slots=slots, stream="window",
                                  sharding=sharding)

    def keys_in_shares():
        return joined(kperm._over_shares(
            mesh, dist, key.cpu(),
            lambda d, _, sl: kperm._significance(
                d, scores[sl], kperm._stream_keys(key, sl.stop - sl.start, chroms[sl],
                                                  slots[sl], "window", d.device),
                a, b, 10, cs.MC_RUNS, 256, "xla", "mix", "window")))

    ref = window()
    print("[K8 window, 4 shares] " + medians(
        {"unsharded": window, "keys in shares": keys_in_shares,
         "package": lambda: window(mesh)}, ref), flush=True)
    print(f"  first launch of each share (host ms): keys in shares "
          f"{first_launches(keys_in_shares)}, package {first_launches(lambda: window(mesh))}",
          flush=True)

    # approx mode: one fit over every share's sums, a fit a share
    for stream in ("shared", "window"):
        keys = kperm._stream_keys(key, len(scores), chroms, slots, stream, dev)
        args = (a, b, cs.APPROX_CHUNK, cs.APPROX_CHUNKS, 0.5, 3, "mix", stream)

        def approx(sharding=None):
            return kperm.approx_significance(dist, scores, a, b, key, chunk=cs.APPROX_CHUNK,
                                             chroms=chroms, slots=slots,
                                             n_chunks=cs.APPROX_CHUNKS, stream=stream,
                                             sharding=sharding)

        def thread_a_share():
            return joined(kperm._over_shares(
                mesh, dist, keys,
                lambda d, ks, sl: kperm._approx_dispatch(kperm.null_power_sums, d, scores[sl],
                                                         ks, *args)))

        def serial():
            return joined([kperm.approx_significance(
                dist[sl], scores[sl], a, b, key, chunk=cs.APPROX_CHUNK, chroms=chroms[sl],
                slots=slots[sl], n_chunks=cs.APPROX_CHUNKS, stream=stream) for sl in shares])

        ref = approx()
        print(f"[K9 approx {stream}, 4 shares] " + medians(
            {"unsharded": approx, "serial": serial, "thread a share": thread_a_share,
             "package": lambda: approx(mesh)}, ref), flush=True)
        print(f"  host time: unsharded {host_split(approx)}; thread a share "
              f"{host_split(thread_a_share)}; package {host_split(lambda: approx(mesh))}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
