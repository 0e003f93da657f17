"""Command-line tool of the port: ``run-fet``, the windowed Fisher's
Exact Test scan (``divergence_tpu/tools/cli.py`` ``run-fet``; replaces
reference tools/FisherExactTestSNPTool.py).

Usage::

    python -m divergence_tpu_torch.tools.cli run-fet --pop-a A.gtrack \\
        --pop-b B.gtrack --out fet.track [--device cuda|cpu] ...

Flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a
CUDA device that default raises, there is no CPU fallback).  Not ported
yet: ``--shard``, ``--num-hosts``/``--host-id`` and ``--profile``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _load_pairs(args):
    """Read both population tracks, align per chromosome, return
    {seqid: (SnpPair, regend)}; regend is the chrom-sizes length or the
    last SNP position + 1."""
    from divergence_tpu_torch.engine.snp import SnpPair
    from divergence_tpu_torch.io import read_chrom_sizes, read_gtrack_points

    ta = read_gtrack_points(args.pop_a)
    tb = read_gtrack_points(args.pop_b)
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else {}
    common = sorted(set(ta) & set(tb))
    if not common:
        raise SystemExit("no chromosome appears in both tracks")
    skipped = sorted(set(ta) ^ set(tb))
    if skipped:
        print(f"skipping chromosomes present in only one track: {skipped}")
    pairs = {}
    for seqid in common:
        pair = SnpPair.from_tracks(ta[seqid], tb[seqid])
        regend = sizes.get(seqid, int(pair.positions[-1]) + 1)
        pairs[seqid] = (pair, regend)
    return pairs


def cmd_run_fet(args) -> None:
    """Per-chromosome part files (``--resume``) make a failed genome-wide
    run resumable at chromosome granularity; the remaining chromosomes run
    through :func:`run_fet_multi` (one host sync), a single one through
    :func:`run_fet`.  Per-window RNG streams are (seed, chrom, slot)-pinned,
    so resumed and fresh tracks are byte-identical."""
    from divergence_tpu_torch import resolve_device
    from divergence_tpu_torch.config import FetConfig, WindowConfig
    from divergence_tpu_torch.engine import run_fet, run_fet_multi
    from divergence_tpu_torch.io import read_score_track, write_score_track
    from divergence_tpu_torch.utils.summary import RunSummary

    cfg = FetConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        percentile=args.percentile,
        bootstrap_samples=args.bootstrap_samples,
        seed=args.seed,
        precision=args.precision,
    )
    columns = ("score", "stddev")
    device = resolve_device(args.device)
    summary = RunSummary(name=args.cmd)
    pairs = _load_pairs(args)

    parts_dir = None
    if args.resume:
        parts_dir = Path(args.out + ".parts")
        parts_dir.mkdir(exist_ok=True)

    results = {}
    t0 = time.perf_counter()
    total_windows = 0
    with summary.stage("device_init"):
        torch.zeros(1, device=device).cpu()

    remaining = pairs
    if parts_dir is not None:
        remaining = {}
        for seqid, (pair, regend) in pairs.items():
            part = parts_dir / f"{seqid}.tsv"
            if not part.exists():
                remaining[seqid] = (pair, regend)
                continue
            _, starts, c2, c3 = read_score_track(part)
            nslots = cfg.window.num_slots(regend)
            s = np.zeros(nslots)
            x = np.zeros(nslots)
            slots = starts // cfg.window.wstep
            s[slots] = c2
            x[slots] = c3
            results[seqid] = (s, x)
            print(f"{seqid}: resumed from {part}")

    def _finish_chrom(seqid):
        nonlocal total_windows
        nw = int((results[seqid][0] != 0).sum())
        total_windows += nw
        print(f"{seqid}: {nw} scored windows")
        # NaNs should be impossible in either column (scores are
        # log-space-finite); say so loudly instead of letting a poisoned
        # track flow into region calling
        n_nan = int(
            np.isnan(results[seqid][0]).sum()
            + np.isnan(results[seqid][1]).sum()
        )
        if n_nan:
            print(
                f"WARNING: {seqid}: {n_nan} NaN values in the output track",
                file=sys.stderr,
            )
        if parts_dir is not None:
            write_score_track(
                parts_dir / f"{seqid}.tsv",
                {seqid: results[seqid]},
                cfg.window.wstep,
                columns,
            )

    if len(remaining) > 1:
        with summary.stage("genome"):
            results.update(
                run_fet_multi(remaining, cfg, device=device, summary=summary)
            )
        for seqid in remaining:
            _finish_chrom(seqid)
    else:
        for seqid, (pair, regend) in remaining.items():
            with summary.stage(seqid):
                results[seqid] = run_fet(
                    pair, regend, cfg, device=device, summary=summary,
                    seqid=seqid,
                )
            _finish_chrom(seqid)
    elapsed = time.perf_counter() - t0
    summary.counters["device"] = str(device)
    summary.counters["total_s"] = round(elapsed, 3)
    summary.counters["windows_per_s"] = round(total_windows / elapsed, 1)
    # chromosome order in the track is the load order, not the (resume
    # -dependent) completion order: resumed-vs-fresh byte identity
    results = {s: results[s] for s in pairs if s in results}
    write_score_track(args.out, results, cfg.window.wstep, columns)
    print(f"wrote {args.out}")
    if args.summary:
        summary.write(args.summary)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="divergence_tpu_torch",
        description="genome-wide divergence analysis on CUDA (FET scan)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run-fet", help="windowed Fisher's Exact Test scan")
    p.add_argument("--pop-a", required=True, help="population A GTrack file")
    p.add_argument("--pop-b", required=True, help="population B GTrack file")
    p.add_argument("--out", required=True, help="output score track")
    p.add_argument("--wsize", type=int, default=2500)
    p.add_argument("--wstep", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--chrom-sizes",
        default=None,
        help="chrom.sizes file; without it regend = last SNP position + 1",
    )
    p.add_argument("--summary", default=None, help="write run-summary JSON here")
    p.add_argument(
        "--resume",
        action="store_true",
        help="keep per-chromosome part files next to --out and skip "
        "chromosomes already completed by a previous (failed) run",
    )
    p.add_argument(
        "--precision",
        choices=["exact", "fast"],
        default="fast",
        help="fast = float32 (the CLI default, as in the JAX CLI; ~1e-5 "
        "relative score accuracy); exact = float64 end to end",
    )
    p.add_argument("--percentile", type=float, default=0.95)
    p.add_argument("--bootstrap-samples", type=int, default=100)
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device: cuda (default; raises without a CUDA device) "
        "or cpu (the plain torch path)",
    )
    p.set_defaults(fn=cmd_run_fet)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
