"""Command-line tool of the port (``divergence_tpu/tools/cli.py``):
``run-fet``, the windowed Fisher's Exact Test scan, and ``run-css``, the
windowed Cluster Separation Score scan (they replace reference
tools/FisherExactTestSNPTool.py and tools/ClusterSeparationScore.py);
``filter-fet`` and ``call-css-regions``, the region callers (reference
tools/FilterFisherScores.py and tools/SignificantCSSRegions.py);
``report``, an HTML summary; ``run-all``, the whole pipeline in one
process; ``merge-tracks``, which joins the score-track shards of a
multi-host run; and ``bench-scaling``, the sharded step over 1..N devices.

Usage::

    python -m divergence_tpu_torch.tools.cli run-fet --pop-a A.gtrack \\
        --pop-b B.gtrack --out fet.track [--device cuda|cpu] ...
    python -m divergence_tpu_torch.tools.cli run-css --pop-a A.gtrack \\
        --pop-b B.gtrack --out css.track [--device cuda|cpu] ...
    python -m divergence_tpu_torch.tools.cli filter-fet --scores fet.track \\
        --out fet_regions.gtrack
    python -m divergence_tpu_torch.tools.cli call-css-regions \\
        --scores css.track --out css_regions.gtrack
    # both scans, both region callers and report.html into one directory
    python -m divergence_tpu_torch.tools.cli run-all --pop-a A.gtrack \\
        --pop-b B.gtrack --outdir out/ [--device cuda|cpu] ...
    # host k of N (k = 0 .. N-1), then join the shards anywhere
    python -m divergence_tpu_torch.tools.cli run-fet ... --num-hosts N \\
        --host-id k --out fet.hk.track
    python -m divergence_tpu_torch.tools.cli merge-tracks \\
        --inputs fet.h*.track --out fet.track

Flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a
CUDA device that default raises, there is no CPU fallback).  ``--shard``
cuts each chromosome's windows over every CUDA device (``(cpu,)`` with
``--device cpu``); ``--profile DIR`` writes a ``torch.profiler`` trace
(``DIR/trace.json``) of the scan.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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


def _host_filter(pairs, args):
    """Multi-host work partitioning (deterministic, no communication;
    ``divergence_tpu/tools/cli.py:_host_filter``).

    A chromosome whose weight exceeds the per-host average is cut into
    contiguous slot ranges, so a genome that is one large chromosome still
    spreads over hosts.  Each host's input is sliced to its owned span
    plus the wsize - wstep halo at each cut; slot-keyed streams make the
    union of the host outputs identical to the single-host run.

    Returns (pairs, slot_ranges), slot_ranges carrying entries only for
    partial-chromosome assignments."""
    if args.num_hosts <= 1:
        return pairs, None
    from divergence_tpu_torch.parallel import partition_chromosomes

    weights = {s: p.npos for s, (p, _) in pairs.items()}
    nslots = {s: r // args.wstep for s, (_, r) in pairs.items()}
    assignment = partition_chromosomes(
        weights, args.num_hosts, args.host_id, seqid_nslots=nslots
    )
    out, slot_ranges = {}, {}
    for wr in assignment.ranges:
        # partition_chromosomes gives a host at most one (merged) range per
        # chromosome; this dict cannot hold more, so refuse rather than
        # drop windows
        if wr.seqid in out:
            raise AssertionError(
                f"host {args.host_id}: multiple ranges for {wr.seqid} — "
                "partitioner invariant violated"
            )
        pair, regend = pairs[wr.seqid]
        if wr.covers(nslots[wr.seqid]):
            out[wr.seqid] = (pair, regend)
            continue
        # partial chromosome: the SNP span this range can read,
        # [slot_lo*wstep, (slot_hi-1)*wstep + wsize] inclusive
        hi_slot = min(wr.slot_hi, nslots[wr.seqid]) - 1
        span_lo = wr.slot_lo * args.wstep
        span_hi = hi_slot * args.wstep + args.wsize
        out[wr.seqid] = (pair.slice_span(span_lo, span_hi), regend)
        slot_ranges[wr.seqid] = (wr.slot_lo, wr.slot_hi)
    desc = [
        f"{r.seqid}" if r.covers(nslots[r.seqid])
        else f"{r.seqid}[{r.slot_lo}:{min(r.slot_hi, nslots[r.seqid])}]"
        for r in assignment.ranges
    ]
    print(f"host {args.host_id}/{args.num_hosts} takes {desc}")
    return out, slot_ranges or None


def _mesh_sharding(args, device):
    """``--shard``: every CUDA device, or ``(cpu,)`` with ``--device cpu``."""
    if not args.shard:
        return None
    from divergence_tpu_torch.parallel import make_mesh

    return make_mesh() if device.type == "cuda" else make_mesh(devices=[device])


@contextlib.contextmanager
def _profile(directory, devices):
    """A ``torch.profiler`` trace of the block, written to
    ``directory/trace.json`` (CUDA activity too on a CUDA mesh)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"wrote {out / 'trace.json'}")


def _run_engine(args, engine, engine_multi, cfg, columns, preloaded=None) -> None:
    """The part-file and resume logic shared by ``run-fet`` and ``run-css``
    (``divergence_tpu/tools/cli.py:_run_engine``).

    Per-chromosome part files (``--resume``) make a failed genome-wide
    run resumable at chromosome granularity; a host's partial chromosome
    (``--num-hosts``) gets its slot range in the part file's name, so a
    re-partitioned resume never reuses a stale part.  The remaining
    chromosomes run through ``engine_multi`` (one host sync), a single one
    through ``engine``.  The random streams are (seed, chromosome, slot)-
    or (seed, chunk)-pinned, so resumed, sharded and fresh tracks are
    byte-identical.  ``preloaded`` = (pairs, slot_ranges, sharding) lets
    ``run-all`` read, align and upload the genome once for both engines
    (the upload is cached on each ``SnpPair``, engine/snp.py)."""
    from divergence_tpu_torch import resolve_device
    from divergence_tpu_torch.io import read_score_track, write_score_track
    from divergence_tpu_torch.utils.summary import RunSummary

    device = resolve_device(args.device)
    summary = RunSummary(name=args.cmd)
    if preloaded is None:
        pairs, slot_ranges = _host_filter(_load_pairs(args), args)
        sharding = _mesh_sharding(args, device)
    else:
        pairs, slot_ranges, sharding = preloaded

    def _part_name(seqid):
        r = (slot_ranges or {}).get(seqid)
        return f"{seqid}.tsv" if r is None else f"{seqid}@{r[0]}-{r[1]}.tsv"

    parts_dir = None
    if args.resume:
        parts_dir = Path(args.out + ".parts")
        parts_dir.mkdir(exist_ok=True)

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        profile_ctx = _profile(args.profile, sharding or (device,))

    results = {}
    t0 = time.perf_counter()
    total_windows = 0
    with summary.stage("device_init"):
        torch.zeros(1, device=device).cpu()

    remaining = pairs
    if parts_dir is not None:
        remaining = {}
        for seqid, (pair, regend) in pairs.items():
            part = parts_dir / _part_name(seqid)
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
                parts_dir / _part_name(seqid),
                {seqid: results[seqid]},
                cfg.window.wstep,
                columns,
            )

    if len(remaining) > 1:
        with profile_ctx, summary.stage("genome"):
            results.update(
                engine_multi(
                    remaining, cfg, device=device, summary=summary,
                    sharding=sharding,
                    slot_ranges={
                        s: r for s, r in (slot_ranges or {}).items() if s in remaining
                    } or None,
                )
            )
        for seqid in remaining:
            _finish_chrom(seqid)
    else:
        with profile_ctx:
            for seqid, (pair, regend) in remaining.items():
                with summary.stage(seqid):
                    results[seqid] = engine(
                        pair, regend, cfg, device=device, summary=summary,
                        seqid=seqid, sharding=sharding,
                        slot_range=(slot_ranges or {}).get(seqid),
                    )
                _finish_chrom(seqid)
    elapsed = time.perf_counter() - t0
    summary.counters["device"] = str(device)
    if sharding is not None:
        summary.counters["mesh"] = [str(d) for d in sharding]
    summary.counters["total_s"] = round(elapsed, 3)
    summary.counters["windows_per_s"] = round(total_windows / elapsed, 1)
    # chromosome order in the track is the load order, not the (resume
    # -dependent) completion order: resumed-vs-fresh byte identity
    results = {s: results[s] for s in pairs if s in results}
    write_score_track(args.out, results, cfg.window.wstep, columns)
    print(f"wrote {args.out}")
    if args.summary:
        summary.write(args.summary)


def _fet_config(args):
    from divergence_tpu_torch.config import FetConfig, WindowConfig

    return FetConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        percentile=args.percentile,
        bootstrap_samples=args.bootstrap_samples,
        seed=args.seed,
        precision=args.precision,
    )


def cmd_run_fet(args) -> None:
    from divergence_tpu_torch.engine import run_fet, run_fet_multi

    _run_engine(args, run_fet, run_fet_multi, _fet_config(args), ("score", "stddev"))


def _mds_enum(name):
    """The --mds string -> enum map (``divergence_tpu/tools/cli.py:_mds_enum``)."""
    from divergence_tpu_torch.config import MdsAlgorithm

    return {
        "cmds": MdsAlgorithm.CMDS,
        "smacof": MdsAlgorithm.SMACOF,
        "cmds+smacof": MdsAlgorithm.CMDS_SMACOF,
    }[name]


def _css_config(args):
    """The CSS scan's configuration, shared by ``run-css`` and ``run-all``
    (one copy, so the two write the same track).  The flags are the JAX
    CLI's and all of them run: the three ``--mds`` modes,
    ``--drosophila`` (frequency tracks), ``--p-mode mc|approx``,
    ``--mc-stream shared|window``, ``--rng mix|threefry`` and
    ``--perm-backend xla|native``.  ``--perm-form`` is accepted and
    changes nothing: both JAX forms score the same permutations and differ
    only in float32 rounding; the port has one form."""
    from divergence_tpu_torch.config import CssConfig, WindowConfig

    return CssConfig(
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


def cmd_run_css(args) -> None:
    from divergence_tpu_torch.engine import run_css, run_css_multi

    if args.p_mode == "approx":
        # the model error the JAX CLI states (baseline/exp_approx_tail.py)
        print(
            "WARNING: --p-mode approx is ANTI-conservative in the extreme "
            "tail (p up to ~4x too small for true p <= 1e-3; docs/PARITY.md) "
            "— prefer the default --p-mode mc",
            file=sys.stderr,
        )
    _run_engine(args, run_css, run_css_multi, _css_config(args), ("score", "p"))


def cmd_run_all(args) -> None:
    """The whole pipeline in one process: ``run-fet``, ``run-css``, both
    region callers and the HTML report (``divergence_tpu/tools/cli.py:
    cmd_run_all``).

    The genome is read, aligned and uploaded once (the ``SnpPair`` device
    cache serves both engines), and the outputs are byte-identical to the
    staged subcommands: the random streams are (seed, chromosome, slot)-
    pinned.  The JAX CLI's backend-warm thread has no counterpart: each
    engine's ``device_init`` stage touches the device before its scan.
    Under ``--num-hosts`` a host writes its track shards only: the region
    thresholds (the Burke limit's median, BH-FDR's ranks) are genome-wide
    statistics, called once on the merged tracks."""
    from divergence_tpu_torch import resolve_device
    from divergence_tpu_torch.engine import run_css, run_css_multi, run_fet, run_fet_multi

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    pairs, slot_ranges = _host_filter(_load_pairs(args), args)
    preloaded = (pairs, slot_ranges, _mesh_sharding(args, resolve_device(args.device)))

    def stage_args(name, out):
        stage = dict(vars(args), cmd=f"run-{name}", out=str(out),
                     summary=str(outdir / f"{name}_summary.json"))
        if args.profile:
            stage["profile"] = str(Path(args.profile) / name)
        return argparse.Namespace(**stage)

    fet_track, css_track = outdir / "fet.track", outdir / "css.track"
    _run_engine(stage_args("fet", fet_track), run_fet, run_fet_multi, _fet_config(args),
                ("score", "stddev"), preloaded)
    _run_engine(stage_args("css", css_track), run_css, run_css_multi, _css_config(args),
                ("score", "p"), preloaded)

    # a user --summary gets both engines' summaries
    if args.summary:
        combined = {
            name: json.loads((outdir / f"{name}_summary.json").read_text())
            for name in ("fet", "css")
        }
        Path(args.summary).write_text(json.dumps(combined, indent=1) + "\n")
        print(f"wrote {args.summary}")

    if args.num_hosts > 1:
        print(
            f"multi-host shard {args.host_id}/{args.num_hosts}: wrote "
            "track shards only (region thresholds are genome-wide "
            "statistics).  After all hosts finish: merge-tracks the "
            "fet/css shards, then filter-fet + call-css-regions + "
            "report on the merged tracks."
        )
        return

    cmd_filter_fet(argparse.Namespace(
        scores=str(fet_track),
        out=str(outdir / "fet_regions.gtrack"),
        max_distance=args.max_distance,
        norm_quantile=args.norm_quantile,
        stddev_percentile=args.stddev_percentile,
        chrom_sizes=args.chrom_sizes,
    ))
    cmd_call_css_regions(argparse.Namespace(
        scores=str(css_track),
        out=str(outdir / "css_regions.gtrack"),
        mode=args.mode,
        fdr=args.fdr,
        num_top=args.num_top,
        window_size=args.wsize,
        chrom_sizes=args.chrom_sizes,
    ))
    cmd_report(argparse.Namespace(
        fet_track=str(fet_track),
        css_track=str(css_track),
        fet_regions=str(outdir / "fet_regions.gtrack"),
        css_regions=str(outdir / "css_regions.gtrack"),
        run_summary=str(outdir / "fet_summary.json"),
        out=str(outdir / "report.html"),
        title=args.title,
    ))


def cmd_report(args) -> None:
    from divergence_tpu_torch.tools.report import write_report

    write_report(
        args.out,
        fet_track=args.fet_track,
        css_track=args.css_track,
        fet_regions=args.fet_regions,
        css_regions=args.css_regions,
        summary_json=args.run_summary,
        title=args.title,
    )
    print(f"wrote {args.out}")


def cmd_filter_fet(args) -> None:
    """FET region calling (the Burke limit), printing the JAX CLI's JSON
    line (``divergence_tpu/tools/cli.py:cmd_filter_fet``)."""
    from divergence_tpu_torch.config import FetFilterConfig
    from divergence_tpu_torch.io import read_chrom_sizes, read_score_track, write_segments_track
    from divergence_tpu_torch.stats import filter_fet_regions

    seqids, starts, scores, stddevs = read_score_track(args.scores)
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else None
    call = filter_fet_regions(
        seqids,
        starts,
        scores,
        stddevs,
        FetFilterConfig(
            max_distance=args.max_distance,
            norm_quantile=args.norm_quantile,
            stddev_percentile=args.stddev_percentile,
        ),
        chrom_lengths=sizes,
    )
    write_segments_track(args.out, call.segments)
    print(json.dumps({
        "windows_passing": call.n_windows_passing,
        "limit": call.threshold,
        "regions": len(call.segments),
        **call.info,
    }))


def cmd_call_css_regions(args) -> None:
    """CSS region calling (BH-FDR or top-N), printing the JAX CLI's JSON
    line (``divergence_tpu/tools/cli.py:cmd_call_css_regions``)."""
    from divergence_tpu_torch.config import CssRegionConfig
    from divergence_tpu_torch.io import read_chrom_sizes, read_score_track, write_segments_track
    from divergence_tpu_torch.stats import call_css_regions

    seqids, starts, scores, pvals = read_score_track(args.scores)
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else None
    call = call_css_regions(
        seqids,
        starts,
        scores,
        pvals,
        CssRegionConfig(
            mode=args.mode,
            fdr=args.fdr,
            num_top=args.num_top,
            window_size=args.window_size,
        ),
        chrom_lengths=sizes,
    )
    write_segments_track(args.out, call.segments)
    print(json.dumps({
        "windows_passing": call.n_windows_passing,
        "threshold": call.threshold,
        "regions": len(call.segments),
        **call.info,
    }))


def cmd_merge_tracks(args) -> None:
    """Merge per-host score-track shards into one genome-wide track
    (``divergence_tpu/tools/cli.py:_cmd_merge_tracks``).

    Slot-range shards may split one chromosome across hosts, so overlap
    is detected per row: the same (seqid, start) window in two shards
    means the partitions overlap (or a shard was passed twice), and the
    merge is refused.  Rows are sorted by (seqid, start), as the
    single-host run writes them."""
    from divergence_tpu_torch.io import read_score_track

    seen_rows: dict[tuple[str, int], str] = {}
    rows: list[tuple[str, int, str]] = []
    header = None
    for path in args.inputs:
        with open(path) as fh:
            first = fh.readline().rstrip("\n")
        if first.startswith("#"):
            if header is None:
                header = first
            elif first != header:
                raise SystemExit(
                    f"{path}: column header {first!r} differs from "
                    f"{header!r} — refusing to merge mixed track types"
                )
        seqids, starts, c2, c3 = read_score_track(path)
        for s, st, a, b in zip(seqids, starts, c2, c3):
            rk = (s, int(st))
            if rk in seen_rows:
                raise SystemExit(
                    f"window {s}:{st} appears in both {seen_rows[rk]} "
                    f"and {path} — host shards overlap"
                )
            seen_rows[rk] = str(path)
            rows.append(
                (s, int(st), f"{s}\t{st}\t{float(a)!r}\t{float(b)!r}\n")
            )
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(args.out, "w") as out:
        out.write((header or "#seqid\tstart\tscore\taux") + "\n")
        for _, _, line in rows:
            out.write(line)
    print(f"merged {len(args.inputs)} shards, {len(rows)} rows -> {args.out}")


def cmd_bench_scaling(args) -> None:
    from divergence_tpu_torch.tools.bench_scaling import main as bench_main

    bench_main(args)


def _add_run_common(p: argparse.ArgumentParser, with_out: bool = True) -> None:
    p.add_argument("--pop-a", required=True, help="population A GTrack file")
    p.add_argument("--pop-b", required=True, help="population B GTrack file")
    if with_out:
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
    p.add_argument(
        "--shard", action="store_true",
        help="cut each chromosome's windows over every CUDA device "
        "((cpu,) with --device cpu)",
    )
    p.add_argument("--num-hosts", type=int, default=1,
                   help="hosts of a multi-host run (each writes a shard; "
                   "join them with merge-tracks)")
    p.add_argument("--host-id", type=int, default=0, help="this host, 0 .. N-1")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace (trace.json) to this directory")


def _add_fet_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--percentile", type=float, default=0.95)
    p.add_argument("--bootstrap-samples", type=int, default=100)


def _add_css_args(p: argparse.ArgumentParser) -> None:
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="divergence_tpu_torch",
        description="genome-wide divergence analysis on CUDA (FET and CSS "
        "scans, region calling, report)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run-fet", help="windowed Fisher's Exact Test scan")
    _add_run_common(p)
    _add_fet_args(p)
    p.set_defaults(fn=cmd_run_fet)

    p = sub.add_parser("run-css", help="windowed Cluster Separation Score scan")
    _add_run_common(p)
    _add_css_args(p)
    p.set_defaults(fn=cmd_run_css)

    p = sub.add_parser(
        "run-all",
        help="whole pipeline in one process: run-fet + run-css + both "
        "region callers + HTML report (the genome is read and uploaded "
        "once; outputs byte-identical to the staged subcommands)",
    )
    _add_run_common(p, with_out=False)
    p.add_argument(
        "--outdir", required=True,
        help="output directory: fet.track, css.track, fet_regions.gtrack, "
        "css_regions.gtrack, report.html, *_summary.json",
    )
    _add_fet_args(p)
    _add_css_args(p)
    p.add_argument("--max-distance", type=int, default=100_000)
    p.add_argument("--norm-quantile", type=float, default=0.999)
    p.add_argument("--stddev-percentile", type=float, default=75.0)
    p.add_argument("--mode", choices=["fdr", "top"], default="fdr")
    p.add_argument("--fdr", type=float, default=0.05)
    p.add_argument("--num-top", type=int, default=100)
    p.add_argument("--title", default="divergence_tpu run report")
    p.set_defaults(fn=cmd_run_all)

    p = sub.add_parser(
        "report", help="self-contained HTML summary of score tracks/regions"
    )
    p.add_argument("--fet-track", default=None)
    p.add_argument("--css-track", default=None)
    p.add_argument("--fet-regions", default=None)
    p.add_argument("--css-regions", default=None)
    p.add_argument("--run-summary", default=None, help="run-summary JSON file")
    p.add_argument("--out", required=True)
    p.add_argument("--title", default="divergence_tpu run report")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("filter-fet", help="FET region calling (Burke limit)")
    p.add_argument("--scores", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-distance", type=int, default=100_000)
    p.add_argument("--norm-quantile", type=float, default=0.999)
    p.add_argument("--stddev-percentile", type=float, default=75.0)
    p.add_argument("--chrom-sizes", default=None)
    p.set_defaults(fn=cmd_filter_fet)

    p = sub.add_parser(
        "call-css-regions", help="CSS region calling (BH-FDR / top-N)"
    )
    p.add_argument("--scores", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["fdr", "top"], default="fdr")
    p.add_argument("--fdr", type=float, default=0.05)
    p.add_argument("--num-top", type=int, default=100)
    p.add_argument("--window-size", type=int, default=2500)
    p.add_argument("--chrom-sizes", default=None)
    p.set_defaults(fn=cmd_call_css_regions)

    p = sub.add_parser(
        "merge-tracks",
        help="merge per-host score-track shards (disjoint chromosomes or "
        "slot ranges; duplicate windows are refused)",
    )
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_merge_tracks)

    p = sub.add_parser(
        "bench-scaling",
        help="weak and strong scaling of the sharded step over 1..N devices",
    )
    p.add_argument("--devices", type=int, default=None,
                   help="largest mesh (default: every CUDA device; with "
                   "--device cpu, a mesh of this many CPU shares)")
    p.add_argument("--windows-per-device", type=int, default=256)
    p.add_argument("--total-windows", type=int, default=None)
    p.add_argument("--mc-chunk", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench_scaling)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
