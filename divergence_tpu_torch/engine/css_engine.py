"""Per-chromosome CSS engine (``divergence_tpu/engine/css_engine.py``).

Window plan (host) -> phase 1: every valid window's dissimilarities and
CMDS or SMACOF score in one call per chromosome
(``kernels/css.py:css_phase1``) -> one host sync for the scores and valid
flags of every chromosome (the distance matrices stay on the device) ->
phase 2: the permutation p-values over all valid windows of a panel-size
group at once (``kernels/perm.py``: ``significance`` for the adaptive MC,
``approx_significance`` for ``p_mode="approx"``) -> dense score / p
tracks.

Every ``CssConfig`` option runs: the three MDS modes, drosophila mode
(frequency tracks, two pseudo-individuals scored and permuted as 1 + 1),
``p_mode`` "mc" or "approx", ``mc_stream`` "shared" or "window", ``rng``
"mix" or "threefry", ``perm_backend`` "xla" or "native" (the window
stream scored in float64 in ``mc_native``'s order: K8's float64 form on
the card, ``kernels/perm.py:mc_native_plain`` on the CPU).  Each valid
window carries (``chrom_hash(seqid)``, slot) into phase 2, the key of its
window stream.  Left out against the JAX engine, because Hopper does not
need them: the ``PREFIX_MAX_ELEMS`` switch between prefix and gather
programs (the dissimilarity kernel counts per window, with no prefix, at
any chromosome length), the ``lax.map`` descriptor slices, and the padded
MC rows (only valid windows enter phase 2; each stops on its own, and a
window's result depends on its own stream only).  ``mc_window_batch`` and
``perm_form`` therefore change nothing here.

``sharding=`` (a ``parallel.make_mesh`` tuple) cuts phase 1's windows of
each chromosome, and phase 2's valid windows, into contiguous shares, one
per device (``kernels/perm.py`` ``sharding=``: the MC's shares run at
once, phase 1's are enqueued one after another); ``slot_range(s)=``
restricts a chromosome to the slots a host owns (multi-host
partitioning).  Every window's result depends on its own streams and
stop, so both give the unsplit run's values.

Each step runs under a span (``utils/trace.py``), timed into the
``RunSummary`` stage of its name and, under a profiler, on the trace's
clock: ``css_dispatch`` (a chromosome's ``css_plan``, ``css_upload`` and
``css_phase1_enqueue`` inside it), ``css_phase1_sync``, ``css_collect``,
``css_mc`` (the MC's ``mc_*`` spans inside it) and ``css_assemble``.  The
summary's counters add ``mc_ranges`` and ``mc_perms_run`` (the MC's ranges
of chunks, and running windows x chunks x chunk over them) and
``h2d_bytes`` (``SnpPair.to_device``'s uploads) to the window counts.
"""

from __future__ import annotations

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.config import CssConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine.snp import SnpPair
from divergence_tpu_torch.kernels import css as kcss
from divergence_tpu_torch.kernels import perm as kperm
from divergence_tpu_torch.parallel.mesh import mesh_devices, to_host, window_slices
from divergence_tpu_torch.utils.summary import RunSummary
from divergence_tpu_torch.utils.trace import span


def _phase1_dispatch(pair: SnpPair, regend: int, cfg: CssConfig,
                     devices: tuple[torch.device, ...], key: torch.Tensor, seqid: str,
                     slot_range: tuple[int, int] | None = None,
                     summary: RunSummary | None = None):
    """Enqueue one chromosome's phase 1 (no host sync), the windows cut
    into one contiguous share per device.

    Returns (nslots, num_windows, pending) with pending = (slots [Bw]
    numpy, [(scores, dist, valid) per share, in window order]) on the
    devices, or None."""
    w = cfg.window
    with span("css_plan", summary):
        plan = plan_windows(pair.positions, regend, w.wsize, w.wstep)
        if plan.num_windows == 0 or pair.npos == 0:
            return plan.nslots, plan.num_windows, None
        valid = plan.valid_mask() & (plan.npos > 0)
        if slot_range is not None:
            valid &= (plan.slot >= slot_range[0]) & (plan.slot < slot_range[1])
        ids = np.nonzero(valid)[0]
        if len(ids) == 0:
            return plan.nslots, plan.num_windows, None
        # chromosome-pinned restart keys: the scores do not depend on which
        # other chromosomes share the run
        ckey = rng.fold_in(key, rng.chrom_hash(seqid))
    sm = cfg.smacof
    parts = []
    for dev, sl in zip(devices, window_slices(len(ids), devices)):
        if sl.start == sl.stop:
            continue
        # int16 codes: the counts only ==-compare them (engine/snp.py);
        # drosophila frequencies keep their float values (css.c:245-264)
        with span("css_upload", summary):
            vals = pair.to_device(dev, compact=not cfg.drosophila, summary=summary)
        share = ids[sl]
        with span("css_phase1_enqueue", summary):
            parts.append(kcss.css_phase1(
                vals, plan.lo[share], plan.npos[share], pair.asize, pair.bsize,
                fast=cfg.precision == "fast", mds=int(cfg.mds), key=ckey,
                slots=plan.slot[share], drosophila=cfg.drosophila,
                smacof_iters=sm.max_iters, smacof_inits=sm.n_init, smacof_eps=sm.epsilon,
            ))
    return plan.nslots, plan.num_windows, (plan.slot[ids], parts)


def _phase1_fetch(pending: list) -> np.ndarray:
    """ONE device-to-host copy per device of every chromosome's (score,
    valid) rows: [sum Bw, 2] float64.  The distance matrices stay on the
    devices."""
    rows = [
        torch.stack([s.to(torch.float64), v.to(torch.float64)], dim=1)
        for _, parts in pending for s, _, v in parts
    ]
    return np.concatenate(to_host(rows))


def run_css(
    pair: SnpPair,
    regend: int,
    cfg: CssConfig | None = None,
    *,
    device: str | torch.device | None = None,
    summary: RunSummary | None = None,
    seqid: str = "_",
    sharding=None,
    slot_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """CSS scan of one chromosome on ``device``, or over the ``sharding``
    mesh's devices (a ``parallel.make_mesh`` tuple; it takes the place of
    ``device``).
    ``device`` defaults to the card (``"cuda"``); without one the call
    raises RuntimeError, and ``device="cpu"`` runs the plain torch path.

    Returns (scores, pvals) float64, each of ``regend // wstep`` slots
    (reference statistics/CategoryClusterSeparationStat.py:70-80).
    Discarded or empty windows, and slots outside ``slot_range``, keep
    score 0 / p 0.  The result equals the same chromosome inside
    :func:`run_css_multi`: the MC streams are keyed by (seed, chunk) or
    (seed, chromosome, slot, chunk)."""
    return run_css_multi(
        {seqid: (pair, regend)}, cfg, device=device, summary=summary,
        sharding=sharding,
        slot_ranges=None if slot_range is None else {seqid: slot_range},
    )[seqid]


def run_css_multi(
    pairs: dict[str, tuple[SnpPair, int]],
    cfg: CssConfig | None = None,
    *,
    device: str | torch.device | None = None,
    summary: RunSummary | None = None,
    sharding=None,
    slot_ranges: dict[str, tuple[int, int]] | None = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Genome-wide CSS: phase 1 of every chromosome is enqueued before the
    packed host sync (one per device), and phase 2 runs over all valid
    windows of a panel-size group (asize, bsize) at once, split over the
    mesh when ``sharding`` is given.  ``slot_ranges`` maps a chromosome to
    the slot range this host owns.  ``device`` as in :func:`run_css`."""
    cfg = cfg or CssConfig()
    devices = mesh_devices(device, sharding)
    if not pairs:
        return {}
    summary = summary or RunSummary()
    key = rng.prng_key(cfg.seed)

    per_chrom = []
    planned_total = 0
    with span("css_dispatch", summary):
        for seqid, (pair, regend) in sorted(pairs.items()):
            nslots, planned, pending = _phase1_dispatch(
                pair, regend, cfg, devices, key, seqid, (slot_ranges or {}).get(seqid),
                summary,
            )
            planned_total += planned
            # drosophila scores and permutes two pseudo-individuals
            sizes = (1, 1) if cfg.drosophila else (pair.asize, pair.bsize)
            per_chrom.append((seqid, nslots, pending, *sizes))

    all_pending = [p for _, _, p, _, _ in per_chrom if p is not None]
    with span("css_phase1_sync", summary):
        fetched = _phase1_fetch(all_pending) if all_pending else None

    # per chromosome: (seqid, nslots, slots, scores, valid, dist, a, b)
    chrom_data = []
    off = 0
    n_discarded = 0
    with span("css_collect", summary):
        for seqid, nslots, pending, asz, bsz in per_chrom:
            if pending is None:
                chrom_data.append((seqid, nslots, None, None, None, None, asz, bsz))
                continue
            slots, parts = pending
            rows = fetched[off: off + len(slots)]
            off += len(slots)
            valid = rows[:, 1] != 0.0
            # every dispatched window holds SNPs: an invalid one was discarded
            n_discarded += int((~valid).sum())
            # the valid windows' distances, gathered on the first device
            dist = torch.cat([d[v].to(devices[0]) for _, d, v in parts])
            chrom_data.append(
                (seqid, nslots, slots, rows[:, 0], valid, dist, asz, bsz)
            )

    n_scored = int(sum(c[4].sum() for c in chrom_data if c[4] is not None))
    results: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    mc_perms = 0
    ranges = []     # (first chunk, chunks, running windows) of each MC range
    groups: dict[tuple[int, int], list] = {}
    for c in chrom_data:
        groups.setdefault((c[6], c[7]), []).append(c)
    mc_key = rng.fold_in(key, 2)
    mc_mesh = None if sharding is None else devices
    for (asz, bsz), group in groups.items():
        live = [c for c in group if c[4] is not None and c[4].any()]
        mc = None
        if live:
            with span("css_mc", summary):
                dist = torch.cat([c[5] for c in live])
                scores = np.concatenate([c[3][c[4]] for c in live])
                # the window streams' keys: (chromosome, slot) of each window
                chroms = np.concatenate([
                    np.full(int(c[4].sum()), rng.chrom_hash(c[0]), dtype=np.int64)
                    for c in live
                ])
                slots = np.concatenate([c[2][c[4]] for c in live])
                if cfg.p_mode == "approx":
                    mc = kperm.approx_significance(
                        dist, scores, asz, bsz, mc_key,
                        chunk=max(cfg.mc_chunk, 512), chroms=chroms, slots=slots,
                        bitgen=cfg.rng, stream=cfg.mc_stream, sharding=mc_mesh,
                    )
                else:
                    mc = kperm.significance(
                        dist, scores, asz, bsz, cfg.mc_threshold, cfg.mc_runs,
                        mc_key, chunk=cfg.mc_chunk, chroms=chroms, slots=slots,
                        backend=cfg.perm_backend, bitgen=cfg.rng,
                        stream=cfg.mc_stream, sharding=mc_mesh, ranges=ranges,
                    )
        mc_off = 0
        with span("css_assemble", summary):
            for seqid, nslots, slots, sc, valid, *_ in group:
                scores = np.zeros(nslots, dtype=np.float64)
                pvals = np.zeros(nslots, dtype=np.float64)
                if valid is not None and valid.any():
                    n = int(valid.sum())
                    scores[slots[valid]] = sc[valid]
                    pvals[slots[valid]] = mc.pvals[mc_off: mc_off + n]
                    mc_perms += int(mc.nscores[mc_off: mc_off + n].sum())
                    mc_off += n
                results[seqid] = (scores, pvals)

    c = summary.counters
    c["windows_planned"] = c.get("windows_planned", 0) + planned_total
    c["windows_scored"] = c.get("windows_scored", 0) + n_scored
    c["windows_discarded"] = c.get("windows_discarded", 0) + n_discarded
    c["mc_permutations"] = c.get("mc_permutations", 0) + mc_perms
    c["mc_ranges"] = c.get("mc_ranges", 0) + len(ranges)
    c["mc_perms_run"] = (c.get("mc_perms_run", 0)
                         + sum(nk * nact for _, nk, nact in ranges) * cfg.mc_chunk)
    return results
