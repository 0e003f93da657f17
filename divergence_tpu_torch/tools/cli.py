"""Command-line tool of the port: ``run-fet``, the windowed Fisher's
Exact Test scan, and ``run-css``, the windowed Cluster Separation Score
scan (``divergence_tpu/tools/cli.py``; replace reference
tools/FisherExactTestSNPTool.py and tools/ClusterSeparationScore.py).

Usage::

    python -m divergence_tpu_torch.tools.cli run-fet --pop-a A.gtrack \\
        --pop-b B.gtrack --out fet.track [--device cuda|cpu] ...
    python -m divergence_tpu_torch.tools.cli run-css --pop-a A.gtrack \\
        --pop-b B.gtrack --out css.track [--device cuda|cpu] ...

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


def _run_engine(args, engine, engine_multi, cfg, columns) -> None:
    """The part-file and resume logic shared by ``run-fet`` and ``run-css``
    (``divergence_tpu/tools/cli.py:_run_engine``).

    Per-chromosome part files (``--resume``) make a failed genome-wide
    run resumable at chromosome granularity; the remaining chromosomes run
    through ``engine_multi`` (one host sync), a single one through
    ``engine``.  The random streams are (seed, chromosome, slot)- or
    (seed, chunk)-pinned, so resumed and fresh tracks are byte-identical."""
    from divergence_tpu_torch import resolve_device
    from divergence_tpu_torch.io import read_score_track, write_score_track
    from divergence_tpu_torch.utils.summary import RunSummary

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
        # a NaN in either column would poison region calling (BH-FDR
        # ranks the p column): say so loudly
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
                engine_multi(remaining, cfg, device=device, summary=summary)
            )
        for seqid in remaining:
            _finish_chrom(seqid)
    else:
        for seqid, (pair, regend) in remaining.items():
            with summary.stage(seqid):
                results[seqid] = engine(
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


def cmd_run_fet(args) -> None:
    from divergence_tpu_torch.config import FetConfig, WindowConfig
    from divergence_tpu_torch.engine import run_fet, run_fet_multi

    cfg = FetConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        percentile=args.percentile,
        bootstrap_samples=args.bootstrap_samples,
        seed=args.seed,
        precision=args.precision,
    )
    _run_engine(args, run_fet, run_fet_multi, cfg, ("score", "stddev"))


def _mds_enum(name):
    """The --mds string -> enum map (``divergence_tpu/tools/cli.py:_mds_enum``)."""
    from divergence_tpu_torch.config import MdsAlgorithm

    return {
        "cmds": MdsAlgorithm.CMDS,
        "smacof": MdsAlgorithm.SMACOF,
        "cmds+smacof": MdsAlgorithm.CMDS_SMACOF,
    }[name]


def cmd_run_css(args) -> None:
    """The CSS scan.  The flags are the JAX CLI's and all of them run: the
    three ``--mds`` modes, ``--drosophila`` (frequency tracks), ``--p-mode
    mc|approx``, ``--mc-stream shared|window``, ``--rng mix|threefry`` and
    ``--perm-backend xla|native``.  ``--perm-form`` is accepted and
    changes nothing: both JAX forms score the same permutations and differ
    only in float32 rounding; the port has one form."""
    from divergence_tpu_torch.config import CssConfig, WindowConfig
    from divergence_tpu_torch.engine import run_css, run_css_multi

    if args.p_mode == "approx":
        # the model error the JAX CLI states (baseline/exp_approx_tail.py)
        print(
            "WARNING: --p-mode approx is ANTI-conservative in the extreme "
            "tail (p up to ~4x too small for true p <= 1e-3; docs/PARITY.md) "
            "— prefer the default --p-mode mc",
            file=sys.stderr,
        )
    cfg = CssConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        mc_threshold=args.mc_threshold,
        mc_runs=args.mc_runs,
        drosophila=args.drosophila,
        mds=_mds_enum(args.mds),
        seed=args.seed,
        mc_chunk=args.mc_chunk,
        precision=args.precision,
        p_mode=args.p_mode,
        perm_backend=args.perm_backend,
        rng=args.rng,
        perm_form=args.perm_form,
        mc_stream=args.mc_stream,
    )
    _run_engine(args, run_css, run_css_multi, cfg, ("score", "p"))


def _add_run_common(p: argparse.ArgumentParser) -> None:
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
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device: cuda (default; raises without a CUDA device) "
        "or cpu (the plain torch path)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="divergence_tpu_torch",
        description="genome-wide divergence analysis on CUDA (FET and CSS scans)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run-fet", help="windowed Fisher's Exact Test scan")
    _add_run_common(p)
    p.add_argument("--percentile", type=float, default=0.95)
    p.add_argument("--bootstrap-samples", type=int, default=100)
    p.set_defaults(fn=cmd_run_fet)

    p = sub.add_parser("run-css", help="windowed Cluster Separation Score scan")
    _add_run_common(p)
    p.add_argument(
        "--mds", choices=["cmds", "smacof", "cmds+smacof"], default="cmds",
        help="cmds = classical MDS; smacof = SMACOF from 4 random restarts; "
        "cmds+smacof = SMACOF refining the CMDS embedding",
    )
    p.add_argument("--mc-threshold", type=int, default=10)
    p.add_argument("--mc-runs", type=int, default=200_000)
    p.add_argument("--mc-chunk", type=int, default=256)
    p.add_argument(
        "--p-mode", choices=["mc", "approx"], default="mc",
        help="mc = the reference's adaptive Monte-Carlo; approx = a "
        "Pearson-III null fitted to three moments from a few permutation "
        "chunks per window: ANTI-conservative in the extreme tail (p up to "
        "~4x too small for true p <= 1e-3; docs/PARITY.md)",
    )
    p.add_argument("--drosophila", action="store_true",
                   help="frequency-track mode: one value per SNP and "
                   "population (an allele frequency), scored as two "
                   "pseudo-individuals")
    p.add_argument(
        "--perm-backend", choices=["xla", "native"], default="xla",
        help="xla = the float32 evaluator; native = the window stream scored "
        "in float64 in the JAX package's host evaluator's order (implies "
        "--mc-stream window; mix draws only)",
    )
    p.add_argument(
        "--rng", choices=["mix", "threefry"], default="mix",
        help="permutation draws: mix = counter-mixed words; threefry = "
        "float32 uniforms (the round-1 stream)",
    )
    p.add_argument(
        "--perm-form", choices=["broadcast", "matmul"], default="broadcast",
        help="accepted for the JAX CLI's sake and without effect: both forms "
        "score the same permutations",
    )
    p.add_argument(
        "--mc-stream", choices=["shared", "window"], default="shared",
        help="shared = one genome-wide label permutation per draw; window = "
        "independent streams keyed by (seed, chromosome, slot)",
    )
    p.set_defaults(fn=cmd_run_css)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
