"""Scaling of the sharded divergence step over 1..N devices
(``divergence_tpu/tools/bench_scaling.py``).

Two series:

* **weak scaling** — fixed windows per device; efficiency =
  t(1) / t(N) at N-proportional work;
* **strong scaling** — fixed TOTAL windows; efficiency =
  t(1) / (N * t(N)).

The mesh sizes are 1, 2, 4, ... up to the devices available: every CUDA
device by default, or ``devices=`` (``[cpu] * N`` on the CPU checks the
harness and the sharding; a card repeated in a mesh runs its shares at
once, each on a CUDA stream of its own, but on one card's SMs, so it
measures no speedup).  Each timed call ends in one
device-to-host copy of a checksum that depends on every output, so the
time covers the whole step.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _mesh_sizes(max_devices: int) -> list[int]:
    sizes = []
    n = 1
    while n <= max_devices:
        sizes.append(n)
        n *= 2
    if sizes[-1] != max_devices:
        sizes.append(max_devices)
    return sizes


def _make_batch(rng, B, npos, asize, bsize):
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    av = rng.choice(codes, size=(B, npos, asize), p=[0.45, 0.35, 0.15, 0.05])
    bv = rng.choice(codes, size=(B, npos, bsize), p=[0.45, 0.35, 0.15, 0.05])
    nposs = np.full(B, npos, dtype=np.int64)
    return av, bv, nposs


def _time_step(step, first, av, bv, nposs, repeats):
    from divergence_tpu_torch import rng as trng

    # the codes are placed on the mesh's first device before timing, as
    # the JAX bench places its sharded inputs; each share then moves to
    # its own device inside the step
    args = (
        torch.from_numpy(av).to(first),
        torch.from_numpy(bv).to(first),
        torch.from_numpy(nposs),
        torch.arange(len(nposs)),   # window slots
        trng.prng_key(0),
    )

    def fetch(out):
        chk = (
            out["fet_scores"].sum()
            + out["fet_stddev"].sum()
            + torch.where(out["css_valid"], out["css_scores"], 0.0).sum()
            + out["mc_hits"].sum().to(torch.float64)
        )
        return float(chk.cpu())

    fetch(step(*args))                # warm
    t0 = time.perf_counter()
    for _ in range(repeats):
        fetch(step(*args))
    return (time.perf_counter() - t0) / repeats


def run_scaling_bench(
    max_devices: int | None = None,
    windows_per_device: int = 256,
    total_windows: int | None = None,
    npos: int = 64,
    asize: int = 11,
    bsize: int = 10,
    nsamples: int = 25,
    mc_chunk: int = 128,
    repeats: int = 3,
    devices=None,
) -> dict:
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh

    avail = make_mesh(devices=devices)
    max_devices = min(max_devices or len(avail), len(avail))
    sizes = _mesh_sizes(max_devices)
    if total_windows is None:
        total_windows = windows_per_device * max_devices

    rng = np.random.default_rng(0)
    weak, strong = [], []
    for nd in sizes:
        mesh = make_mesh(nd, devices=avail)
        step = make_divergence_step(
            mesh, asize, bsize, nsamples=nsamples, mc_chunk=mc_chunk
        )

        B = windows_per_device * nd
        av, bv, nposs = _make_batch(rng, B, npos, asize, bsize)
        dt = _time_step(step, mesh[0], av, bv, nposs, repeats)
        weak.append(
            {
                "devices": nd,
                "windows": B,
                "wall_s": round(dt, 4),
                "windows_per_s": round(B / dt, 1),
            }
        )

        av, bv, nposs = _make_batch(rng, total_windows, npos, asize, bsize)
        dt = _time_step(step, mesh[0], av, bv, nposs, repeats)
        strong.append(
            {
                "devices": nd,
                "windows": total_windows,
                "wall_s": round(dt, 4),
                "windows_per_s": round(total_windows / dt, 1),
            }
        )

    for r in weak:
        # weak scaling: same time at N-proportional work is perfect
        r["efficiency"] = round(weak[0]["wall_s"] / r["wall_s"], 3)
    for r in strong:
        # strong scaling: N-fold speedup at fixed work is perfect
        r["efficiency"] = round(
            strong[0]["wall_s"] / (r["devices"] * r["wall_s"]), 3
        )

    return {
        "windows_per_device": windows_per_device,
        "total_windows": total_windows,
        "mc_chunk": mc_chunk,
        "backend": avail[0].type,
        "weak_scaling": weak,
        "strong_scaling": strong,
    }


def main(args) -> None:
    from divergence_tpu_torch import resolve_device

    device = resolve_device(args.device)
    # cuda: every CUDA device; cpu: a mesh of --devices CPU shares
    devices = None if device.type == "cuda" else [device] * (args.devices or 1)
    report = run_scaling_bench(
        max_devices=args.devices,
        windows_per_device=args.windows_per_device,
        total_windows=args.total_windows,
        mc_chunk=args.mc_chunk,
        devices=devices,
    )
    print(json.dumps(report, indent=2))
