"""Per-chromosome FET engine (``divergence_tpu/engine/fet_engine.py``).

Window plan (host) -> per-SNP scores once per chromosome (K1) -> every
window's percentile and bootstrap stddev in one launch (K2) -> dense
score / stddev tracks, with one device-to-host copy per device and run.
Its steps run under spans (``utils/trace.py``) of the ``RunSummary``
stages' names: ``fet_dispatch`` (a chromosome's ``fet_plan`` and
``fet_upload`` inside it), ``fet_sync`` and ``fet_scatter``.

Exact mode in the LUT regime takes the JAX engine's rank route instead:
K1r (the sorted LUT and each SNP's int32 rank into it) once per
chromosome, then K2r (K2 on the ranks), whose results equal K1 -> K2
bit for bit.  Fast mode and panels without a LUT keep K1 -> K2, as there.

``sharding=`` (a ``parallel.make_mesh`` tuple) cuts the valid windows
into contiguous shares, one per device: each device runs K1 (or K1r)
over the chromosome (one upload per device, cached on the ``SnpPair``)
and K2 (or K2r) over its share.  ``slot_range=`` restricts the windows to
the slots a host owns (multi-host partitioning,
``parallel/multihost.py``).  The bootstrap streams are keyed by (seed,
chromosome, slot), so both give the unsplit run's values.

Left out against the JAX engine, because Hopper does not need them: the
``lax.map`` window slices (``Bp``), the power-of-two ``P`` buckets and
the two-stage gather bound (``slice_span_bound``) — the K2 and K2r
kernels take every window of a chromosome at once.
"""

from __future__ import annotations

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.config import FetConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine.snp import SnpPair
from divergence_tpu_torch.kernels import fet as kfet
from divergence_tpu_torch.parallel.mesh import mesh_devices, to_host, window_slices
from divergence_tpu_torch.utils.summary import RunSummary
from divergence_tpu_torch.utils.trace import span


def chromosome_key(seed: int, seqid: str) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), chrom_hash(seqid))`` on the host: the
    stream every window of ``seqid`` folds its slot into."""
    return rng.fold_in(rng.prng_key(seed), rng.chrom_hash(seqid))


def use_ranks(cfg: FetConfig, pair: SnpPair) -> bool:
    """Whether the sweep takes the rank route (K1r -> K2r): exact mode
    where the panel's LUT is on (``divergence_tpu/engine/fet_engine.py``'s
    ``use_ranks``)."""
    return cfg.precision != "fast" and kfet.lut_active(pair.asize, pair.bsize)


def _fet_dispatch(
    pair: SnpPair,
    regend: int,
    cfg: FetConfig,
    summary: RunSummary | None,
    key: torch.Tensor,
    devices: tuple[torch.device, ...],
    slot_range: tuple[int, int] | None = None,
):
    """Enqueue one chromosome's FET sweep (no host sync).

    Returns (nslots, pending) with pending = (slots, [out_2xb per
    device share, in window order]) or None."""
    w = cfg.window
    with span("fet_plan", summary):
        plan = plan_windows(pair.positions, regend, w.wsize, w.wstep)
        nslots = plan.nslots
        if plan.num_windows == 0 or pair.npos == 0:
            return nslots, None
        valid = plan.valid_mask() & (plan.npos > 0)
        if slot_range is not None:
            # multi-host: only the owned slots (the halo SNPs they read are in
            # this host's input span, parallel/multihost.py)
            valid &= (plan.slot >= slot_range[0]) & (plan.slot < slot_range[1])
        ids = np.nonzero(valid)[0]
    if summary is not None:
        # accumulate across chromosomes (one summary spans a whole run)
        c = summary.counters
        c["windows_planned"] = c.get("windows_planned", 0) + plan.num_windows
        c["windows_evaluated"] = c.get("windows_evaluated", 0) + len(ids)
    if len(ids) == 0:
        return nslots, None

    fast = cfg.precision == "fast"
    ranked = use_ranks(cfg, pair)
    maxs = kfet.support_size(pair.asize, pair.bsize)
    nmax = pair.asize + pair.bsize + 2
    per_snp = {}   # per device: a device repeated in the mesh reuses K1's (K1r's) output
    outs = []
    for dev, sl in zip(devices, window_slices(len(ids), devices)):
        if sl.start == sl.stop:
            continue
        if dev not in per_snp:
            # int16 codes: FET only ==-compares them, so the compact upload
            # is result-identical (engine/snp.py)
            with span("fet_upload", summary):
                vals = pair.to_device(dev, compact=True, summary=summary)
            snp_fn = kfet.fet_snp_ranks if ranked else kfet.fet_snp_logs
            per_snp[dev] = snp_fn(vals, pair.asize, maxs, nmax, fast=fast)
        lo, npos, slot = (
            torch.from_numpy(np.ascontiguousarray(a[ids[sl]]))
            for a in (plan.lo, plan.npos, plan.slot)
        )
        window_args = (lo, npos, slot, key, float(cfg.percentile), cfg.bootstrap_samples)
        if ranked:
            outs.append(kfet.fet_aggregate_ranks(*per_snp[dev], *window_args))
        else:
            outs.append(kfet.fet_aggregate(per_snp[dev], *window_args))
    return nslots, (plan.slot[ids], outs)


def _fetch(pending: list) -> np.ndarray:
    """ONE device-to-host copy per device for any number of chromosomes'
    results: [2, total] float64 in pending order."""
    outs = [out for _, parts in pending for out in parts]
    return np.concatenate(to_host(outs, dim=1), axis=1).astype(np.float64, copy=False)


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
    device: str | torch.device | None = None,
    summary: RunSummary | None = None,
    seqid: str = "_",
    sharding=None,
    slot_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """FET scan of one chromosome on ``device``, or over the ``sharding``
    mesh's devices (a ``parallel.make_mesh`` tuple; it takes the place of
    ``device``).
    ``device`` defaults to the card (``"cuda"``); without one the call
    raises RuntimeError, and ``device="cpu"`` runs the plain torch path.

    Returns (scores, stddev) float64, each of ``regend // wstep`` slots —
    slot ``w.start // wstep`` like the reference adapter
    (statistics/FisherExactScoreStat.py:51-58).  ``seqid`` pins the
    bootstrap RNG stream to the chromosome identity, so the result equals
    the same chromosome inside :func:`run_fet_multi` and the JAX
    package's ``run_fet`` (exactly in law; to round-off in value), under
    any mesh and any ``slot_range`` split (slots outside the range stay 0)."""
    cfg = cfg or FetConfig()
    devices = mesh_devices(device, sharding)
    key = chromosome_key(cfg.seed, seqid)
    nslots, pending = _fet_dispatch(pair, regend, cfg, summary, key, devices, slot_range)
    if pending is None:
        return np.zeros(nslots), np.zeros(nslots)
    scores, stddev, _ = _scatter(pending[0], _fetch([pending]), 0, nslots)
    return scores, stddev


def run_fet_multi(
    pairs: dict[str, tuple[SnpPair, int]],
    cfg: FetConfig | None = None,
    *,
    device: str | torch.device | None = None,
    summary: RunSummary | None = None,
    sharding=None,
    slot_ranges: dict[str, tuple[int, int]] | None = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Genome-wide FET: every chromosome's kernels are enqueued before the
    device-to-host copies, one per device (the per-chromosome result is
    identical to :func:`run_fet`).  ``slot_ranges`` maps a chromosome to
    the slot range this host owns.  ``device`` as in :func:`run_fet`."""
    cfg = cfg or FetConfig()
    devices = mesh_devices(device, sharding)
    summary = summary or RunSummary()
    per_chrom = []
    with span("fet_dispatch", summary):
        for seqid, (pair, regend) in sorted(pairs.items()):
            key = chromosome_key(cfg.seed, seqid)
            nslots, pending = _fet_dispatch(
                pair, regend, cfg, summary, key, devices,
                (slot_ranges or {}).get(seqid),
            )
            per_chrom.append((seqid, nslots, pending))

    all_pending = [p for _, _, p in per_chrom if p is not None]
    with span("fet_sync", summary):
        fetched = _fetch(all_pending) if all_pending else None

    results = {}
    off = 0
    with span("fet_scatter", summary):
        for seqid, nslots, pending in per_chrom:
            if pending is None:
                results[seqid] = (np.zeros(nslots), np.zeros(nslots))
                continue
            scores, stddev, off = _scatter(pending[0], fetched, off, nslots)
            results[seqid] = (scores, stddev)
    return results
