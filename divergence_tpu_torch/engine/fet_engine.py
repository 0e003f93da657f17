"""Per-chromosome FET engine (``divergence_tpu/engine/fet_engine.py``).

Window plan (host) -> per-SNP scores once per chromosome (K1) -> every
window's percentile and bootstrap stddev in one launch (K2) -> dense
score / stddev tracks, with one device-to-host copy per run.

Left out against the JAX engine, because Hopper does not need them: the
``lax.map`` window slices (``Bp``), the power-of-two ``P`` buckets, the
two-stage gather bound (``slice_span_bound``) and the int32 LUT-rank
path — the K2 kernel takes every window of a chromosome at once and
sorts floats natively.  ``slot_range=`` and ``sharding=`` (multi-host /
multi-device partitioning) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from divergence_tpu_torch import resolve_device, rng
from divergence_tpu_torch.config import FetConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine.snp import SnpPair
from divergence_tpu_torch.kernels import fet as kfet
from divergence_tpu_torch.utils.summary import RunSummary


def chromosome_key(seed: int, seqid: str) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), chrom_hash(seqid))`` on the host: the
    stream every window of ``seqid`` folds its slot into."""
    return rng.fold_in(rng.prng_key(seed), rng.chrom_hash(seqid))


def _fet_dispatch(
    pair: SnpPair,
    regend: int,
    cfg: FetConfig,
    summary: RunSummary | None,
    key: torch.Tensor,
    device: torch.device,
):
    """Enqueue one chromosome's FET sweep (no host sync).

    Returns (nslots, pending) with pending = (slots, out_2xB) or None."""
    w = cfg.window
    plan = plan_windows(pair.positions, regend, w.wsize, w.wstep)
    nslots = plan.nslots
    if plan.num_windows == 0 or pair.npos == 0:
        return nslots, None
    valid = plan.valid_mask() & (plan.npos > 0)
    ids = np.nonzero(valid)[0]
    if summary is not None:
        # accumulate across chromosomes (one summary spans a whole run)
        c = summary.counters
        c["windows_planned"] = c.get("windows_planned", 0) + plan.num_windows
        c["windows_evaluated"] = c.get("windows_evaluated", 0) + len(ids)
    if len(ids) == 0:
        return nslots, None

    fast = cfg.precision == "fast"
    # int16 codes: FET only ==-compares them, so the compact upload is
    # result-identical (engine/snp.py)
    vals = pair.to_device(device, compact=True)
    snp_logs = kfet.fet_snp_logs(
        vals,
        pair.asize,
        kfet.support_size(pair.asize, pair.bsize),
        pair.asize + pair.bsize + 2,
        fast=fast,
    )
    lo, npos, slot = (
        torch.from_numpy(np.ascontiguousarray(a[ids]))
        for a in (plan.lo, plan.npos, plan.slot)
    )
    out = kfet.fet_aggregate(
        snp_logs, lo, npos, slot, key,
        perc=float(cfg.percentile),
        nsamples=cfg.bootstrap_samples,
    )
    return nslots, (plan.slot[ids], out)


def _fetch(pending: list) -> np.ndarray:
    """ONE device-to-host copy for any number of chromosomes' results."""
    outs = [out for _, out in pending]
    packed = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return packed.cpu().numpy().astype(np.float64, copy=False)


def _scatter(slots, fetched, off, nslots):
    scores = np.zeros(nslots, dtype=np.float64)
    stddev = np.zeros(nslots, dtype=np.float64)
    n = len(slots)
    scores[slots] = fetched[0, off : off + n]
    stddev[slots] = fetched[1, off : off + n]
    return scores, stddev, off + n


def run_fet(
    pair: SnpPair,
    regend: int,
    cfg: FetConfig | None = None,
    *,
    device: str | torch.device,
    summary: RunSummary | None = None,
    seqid: str = "_",
) -> tuple[np.ndarray, np.ndarray]:
    """FET scan of one chromosome on ``device``.

    Returns (scores, stddev) float64, each of ``regend // wstep`` slots —
    slot ``w.start // wstep`` like the reference adapter
    (statistics/FisherExactScoreStat.py:51-58).  ``seqid`` pins the
    bootstrap RNG stream to the chromosome identity, so the result equals
    the same chromosome inside :func:`run_fet_multi` and the JAX
    package's ``run_fet`` (exactly in law; to round-off in value)."""
    cfg = cfg or FetConfig()
    device = resolve_device(device)
    key = chromosome_key(cfg.seed, seqid)
    nslots, pending = _fet_dispatch(pair, regend, cfg, summary, key, device)
    if pending is None:
        return np.zeros(nslots), np.zeros(nslots)
    scores, stddev, _ = _scatter(pending[0], _fetch([pending]), 0, nslots)
    return scores, stddev


def run_fet_multi(
    pairs: dict[str, tuple[SnpPair, int]],
    cfg: FetConfig | None = None,
    *,
    device: str | torch.device,
    summary: RunSummary | None = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Genome-wide FET: every chromosome's kernels are enqueued before the
    single device-to-host copy (the per-chromosome result is identical
    to :func:`run_fet`)."""
    cfg = cfg or FetConfig()
    device = resolve_device(device)
    summary = summary or RunSummary()
    per_chrom = []
    with summary.stage("fet_dispatch"):
        for seqid, (pair, regend) in sorted(pairs.items()):
            key = chromosome_key(cfg.seed, seqid)
            nslots, pending = _fet_dispatch(
                pair, regend, cfg, summary, key, device
            )
            per_chrom.append((seqid, nslots, pending))

    all_pending = [p for _, _, p in per_chrom if p is not None]
    with summary.stage("fet_sync"):
        fetched = _fetch(all_pending) if all_pending else None

    results = {}
    off = 0
    with summary.stage("fet_scatter"):
        for seqid, nslots, pending in per_chrom:
            if pending is None:
                results[seqid] = (np.zeros(nslots), np.zeros(nslots))
                continue
            scores, stddev, off = _scatter(pending[0], fetched, off, nslots)
            results[seqid] = (scores, stddev)
    return results
