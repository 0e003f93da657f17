"""Region calling over score tracks (post-processing).

Copied from ``divergence_tpu/stats/regions.py`` (the JAX package imports
jax, and the port runs where jax is not installed), verbatim apart from
the config import; ``tests/test_torch_host_copies.py`` holds the copy
equal to the original.

Pure-NumPy host code restating the reference's two filter tools:

* FET filter — Burke et al. threshold ``median(scores) +
  qnorm(normquantile) * percentile(stddevs, perc)`` then merge passing
  windows into segments (reference tools/FilterFisherScores.py:84-115).
* CSS regions — Benjamini-Hochberg FDR over the permutation p-values or
  top-N scores, then the same merge
  (reference tools/SignificantCSSRegions.py:102-150).

These run on gathered host-side tracks (one double per 500 bp — tiny), the
deliberately non-collective tail of the pipeline (SURVEY.md §5).

Deviation note: the reference uses the long-deprecated
``scipy.stats.cmedian`` (a binned median estimate); this module uses the
exact median.  The difference is below the estimator's own bin width.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import stats as sstats

from divergence_tpu_torch.config import CssRegionConfig, FetFilterConfig


@dataclasses.dataclass
class RegionCall:
    """Result of a region-calling pass."""

    segments: list[tuple[str, int, int]]
    threshold: float                 # score or p threshold actually applied
    n_windows_passing: int
    info: dict


def burke_components(
    scores: np.ndarray,
    stddevs: np.ndarray,
    norm_quantile: float = 0.999,
    stddev_percentile: float = 75.0,
) -> tuple[float, float, float]:
    """(limit, median, stddev-upper-quantile) of the Burke et al. 2010
    significance rule (reference tools/FilterFisherScores.py:84-87) —
    one pass over the genome-wide arrays, components reported once."""
    m = float(np.median(scores)) if len(scores) else float("nan")
    upper = (
        float(np.percentile(stddevs, stddev_percentile))
        if len(stddevs)
        else float("nan")
    )
    qnorm = float(sstats.norm.ppf(norm_quantile))
    return m + qnorm * upper, m, upper


def burke_limit(
    scores: np.ndarray,
    stddevs: np.ndarray,
    norm_quantile: float = 0.999,
    stddev_percentile: float = 75.0,
) -> float:
    """Burke et al. 2010 significance limit
    (reference tools/FilterFisherScores.py:84-87)."""
    return burke_components(
        scores, stddevs, norm_quantile, stddev_percentile
    )[0]


def bh_threshold(p: np.ndarray, fdr: float) -> float | None:
    """Benjamini-Hochberg step-up: the largest p_(k) with
    ``p_(k) <= k/n * fdr`` (reference tools/SignificantCSSRegions.py:102-123,
    descending scan with decrementing k).  None if no p passes."""
    n = len(p)
    if n == 0:
        return None
    order = np.argsort(p)[::-1]       # descending
    k = n
    for pi in order:
        if p[pi] <= (k / n) * fdr:
            return float(p[pi])
        k -= 1
    return None


def top_n_threshold(scores: np.ndarray, num_top: int) -> float:
    """Score of the N-th best window; ties are all kept
    (reference tools/SignificantCSSRegions.py:124-127)."""
    if len(scores) == 0:
        raise ValueError("no scores")
    num_top = min(num_top, len(scores))
    order = np.argsort(scores)[::-1]
    return float(scores[order[num_top - 1]])


def merge_windows(
    seqids: list[str] | np.ndarray,
    starts: np.ndarray,
    extension: int,
    chrom_lengths: dict[str, int] | None = None,
) -> list[tuple[str, int, int]]:
    """Merge passing windows into segments.

    Reference merge loop (tools/FilterFisherScores.py:97-115 ==
    tools/SignificantCSSRegions.py:133-150): a new segment opens when the
    chromosome changes or the gap to the previous window start exceeds
    ``extension``; each segment ends at ``last_start + extension``, clamped
    to ``chrom_length - 1``.  Inputs must be in track order (as read from
    the score file)."""
    segments: list[tuple[str, int, int]] = []
    curchrom: str | None = None
    seg_start = 0
    end_clamp = np.inf
    prev = -1_000_000
    for sid, start in zip(seqids, starts):
        sid = str(sid)
        start = int(start)
        if sid != curchrom or start - extension > prev:
            if curchrom is not None:
                segments.append(
                    (curchrom, seg_start, int(min(prev + extension, end_clamp)))
                )
            curchrom = sid
            seg_start = start
            if chrom_lengths is not None and sid in chrom_lengths:
                end_clamp = chrom_lengths[sid] - 1
            else:
                end_clamp = np.inf
        prev = start
    if curchrom is not None:
        segments.append(
            (curchrom, seg_start, int(min(prev + extension, end_clamp)))
        )
    return segments


def filter_fet_regions(
    seqids: list[str] | np.ndarray,
    starts: np.ndarray,
    scores: np.ndarray,
    stddevs: np.ndarray,
    cfg: FetFilterConfig | None = None,
    chrom_lengths: dict[str, int] | None = None,
) -> RegionCall:
    """FET region calling (reference tools/FilterFisherScores.py:55-115)."""
    cfg = cfg or FetFilterConfig()
    limit, median, upper = burke_components(
        scores, stddevs, cfg.norm_quantile, cfg.stddev_percentile
    )
    mask = scores >= limit
    segs = merge_windows(
        np.asarray(seqids)[mask],
        np.asarray(starts)[mask],
        cfg.max_distance,
        chrom_lengths,
    )
    return RegionCall(
        segments=segs,
        threshold=limit,
        n_windows_passing=int(mask.sum()),
        info={
            "median": median,
            "stddev_upper_quantile": upper,
            "norm_quantile": cfg.norm_quantile,
        },
    )


def call_css_regions(
    seqids: list[str] | np.ndarray,
    starts: np.ndarray,
    scores: np.ndarray,
    pvals: np.ndarray,
    cfg: CssRegionConfig | None = None,
    chrom_lengths: dict[str, int] | None = None,
) -> RegionCall:
    """CSS region calling, FDR or top-N mode
    (reference tools/SignificantCSSRegions.py:78-154)."""
    cfg = cfg or CssRegionConfig()
    info: dict = {"mode": cfg.mode, "n_windows": len(scores)}
    if cfg.mode == "fdr":
        testp = bh_threshold(np.asarray(pvals), cfg.fdr)
        if testp is None:
            return RegionCall([], np.nan, 0, dict(info, none_found=True))
        mask = np.asarray(pvals) <= testp
        threshold = testp
        info["estimated_false_discoveries"] = testp * len(pvals)
    else:
        threshold = top_n_threshold(np.asarray(scores), cfg.num_top)
        mask = np.asarray(scores) >= threshold
    segs = merge_windows(
        np.asarray(seqids)[mask],
        np.asarray(starts)[mask],
        cfg.window_size,
        chrom_lengths,
    )
    return RegionCall(
        segments=segs,
        threshold=float(threshold),
        n_windows_passing=int(mask.sum()),
        info=info,
    )
