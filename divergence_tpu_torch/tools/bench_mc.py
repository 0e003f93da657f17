"""Permutation-MC evaluator micro-benchmark: K7 against K8, the native
form and K11 (``divergence_tpu/tools/bench_mc.py``, the same flags,
defaults and JSON fields).

Measures permutations/second of the MC evaluators on the production
shape (stickleback panel, m = 21): random symmetric distances of
``window_batch`` windows, seed 0, window keys folded from key 1 by
(chromosome 0, slot = window index), as in the JAX tool.

- ``inloop_*``: the evaluator inside the adaptive MC loop
  (``kernels/perm.py:significance``) with the observed scores pinned at
  1e30, so no window stops early and each runs ``chunk * iters``
  permutations.  ``inloop`` is the window stream with mix draws (K8,
  ``css_mc_window``, and K7's ``css_mc_scan``), ``inloop_threefry`` the
  same with threefry draws, ``inloop_shared`` the shared stream (K7:
  ``css_mc_coeff``, ``css_mc_shared``, ``css_mc_scan``); ``native`` the
  window stream scored in float64 in the JAX host evaluator's order
  (K8's float64 form).  ``checksum`` is the sum of the p-values, as in
  the JAX tool; ``nscores`` the permutations the windows consumed.
- standalone ``xla`` / ``xla_threefry``: one fixed chunk per window per
  measurement (K11, ``permutation_chunk``), ``iters`` measurements with
  the chunk index folded into the keys.  K11 returns hit counts, not the
  scores the JAX tool's chunk sums: ``checksum`` is the permutations
  scoring at least ``STANDALONE_SCORE`` over every measurement (about
  the 92nd percentile of these windows' permuted scores, so the count
  tests the scores).
- ``xla_matmul``, ``xla_mlast``, ``inloop_matmul`` are arithmetic layouts
  of the JAX package's XLA evaluator with no counterpart here
  (``--perm-form`` is a documented no-op): each gets an ``error`` entry.

Each timed region is bracketed by device synchronisations; a warm call
precedes it.  ``device="cpu"`` runs the plain torch versions (the tests
use it); the default is the card.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

NO_COUNTERPART = ("xla_matmul", "xla_mlast", "inloop_matmul")
# in-loop variant -> (bitgen, backend, stream) of kernels/perm.py:significance
INLOOP = {
    "inloop": ("mix", "xla", "window"),
    "inloop_threefry": ("threefry", "xla", "window"),
    "inloop_shared": ("mix", "xla", "shared"),
    "native": ("mix", "native", "window"),
}
STANDALONE = {"xla": "mix", "xla_threefry": "threefry"}
STANDALONE_SCORE = 0.7


def bench_distances(window_batch: int, m: int) -> np.ndarray:
    """The JAX tool's distances: uniform [0, 1) + its transpose, a zero
    diagonal, from ``default_rng(0)``."""
    rs = np.random.default_rng(0)
    d = rs.random((window_batch, m, m))
    d = d + d.transpose(0, 2, 1)
    for i in range(window_batch):
        np.fill_diagonal(d[i], 0.0)
    return d


def run_mc_bench(
    window_batch: int = 1024,
    chunk: int = 256,
    iters: int = 4,
    asize: int = 11,
    bsize: int = 10,
    backends: tuple[str, ...] = ("inloop", "inloop_shared"),
    device: str | torch.device = "cuda",
) -> dict:
    from divergence_tpu_torch import resolve_device, rng
    from divergence_tpu_torch.kernels import perm as kperm

    dev = resolve_device(device)
    m = asize + bsize
    dist = torch.from_numpy(bench_distances(window_batch, m)).to(torch.float32).to(dev)
    run_key = rng.prng_key(1, dev)
    chroms = np.zeros(window_batch, dtype=np.int64)
    slots = np.arange(window_batch, dtype=np.int64)
    keys = rng.window_keys(run_key, chroms, slots)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_inloop(bitgen, backend, stream):
        """The adaptive MC with unreachable scores: every window runs its
        full permutation budget, the steady-state in-loop rate."""
        runs = chunk * iters
        scores = np.full(window_batch, 1e30)

        def go():
            return kperm.significance(
                dist, scores, asize, bsize, 10, runs, run_key, chunk, chroms, slots,
                backend=backend, bitgen=bitgen, stream=stream,
            )

        go()                                          # build + warm
        sync()
        t0 = time.perf_counter()
        res = go()
        sync()
        dt = time.perf_counter() - t0
        return {
            "chunk": chunk,
            "loop_chunks": iters,
            "wall_s": round(dt, 4),
            "perms_per_s": round(int(res.nscores.sum()) / dt),
            "checksum": round(float(np.sum(res.pvals)), 2),
            "nscores": int(res.nscores.sum()),
        }

    def run_standalone(bitgen):
        scores = torch.full((window_batch,), STANDALONE_SCORE, dtype=torch.float32,
                            device=dev)
        need = torch.full((window_batch,), chunk + 1, dtype=torch.int32, device=dev)

        def go(k):
            hits, _, _ = kperm.permutation_chunk(
                dist, scores, need, chunk, rng.fold_in(keys, k), asize, bsize, chunk,
                bitgen=bitgen,
            )
            return hits

        go(0)                                         # build + warm
        sync()
        t0 = time.perf_counter()
        acc = [go(i + 1) for i in range(iters)]
        sync()
        dt = time.perf_counter() - t0
        perms = window_batch * chunk * iters
        return {
            "chunk": chunk,
            "wall_s": round(dt, 4),
            "perms_per_s": round(perms / dt),
            "checksum": int(sum(int(h.sum()) for h in acc)),
        }

    results = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "window_batch": window_batch,
        "m": m,
    }
    for name in backends:
        try:
            if name in INLOOP:
                results[name] = run_inloop(*INLOOP[name])
            elif name in STANDALONE:
                results[name] = run_standalone(STANDALONE[name])
            elif name in NO_COUNTERPART:
                raise NotImplementedError(
                    f"{name} is an XLA layout of the JAX package's chunk evaluator with no "
                    "counterpart in the port (--perm-form is a documented no-op)"
                )
            else:
                raise ValueError(f"unknown backend {name!r}")
        except Exception as e:  # reported in the variant's field
            results[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
    return results


def main(args) -> None:
    report = run_mc_bench(
        window_batch=args.window_batch,
        chunk=args.chunk,
        iters=args.iters,
        backends=tuple(args.backends.split(",")),
        device=args.device,
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--window-batch", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--backends", default="inloop,inloop_shared")
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args())
