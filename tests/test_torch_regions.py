"""The port's region calling (``divergence_tpu_torch.stats``, a copy of
``divergence_tpu/stats/regions.py``): ``tests/test_regions.py`` on the
copy, each result also equal to the JAX package's function on the same
input; then both callers on seeded multi-chromosome tracks."""

import dataclasses

import numpy as np
import pytest
from scipy import stats as sstats

import divergence_tpu.stats as jstats
from divergence_tpu.config import CssRegionConfig as JCssRegionConfig
from divergence_tpu.config import FetFilterConfig as JFetFilterConfig
from divergence_tpu_torch.config import CssRegionConfig, FetFilterConfig
from divergence_tpu_torch.stats import (
    bh_threshold,
    burke_limit,
    call_css_regions,
    filter_fet_regions,
    merge_windows,
    top_n_threshold,
)


def _same_call(got, want):
    """Two RegionCalls equal field by field (a NaN threshold equals NaN)."""
    assert got.segments == want.segments
    assert got.n_windows_passing == want.n_windows_passing
    assert got.info == want.info
    assert got.threshold == want.threshold or (
        np.isnan(got.threshold) and np.isnan(want.threshold)
    )


def _jax_cfg(cfg):
    cls = JCssRegionConfig if isinstance(cfg, CssRegionConfig) else JFetFilterConfig
    return cls(**dataclasses.asdict(cfg))


def test_burke_limit_formula():
    scores = np.array([1.0, 2.0, 3.0, 4.0, 100.0])
    stddevs = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
    limit = burke_limit(scores, stddevs, 0.999, 75.0)
    expected = 3.0 + sstats.norm.ppf(0.999) * np.percentile(stddevs, 75.0)
    assert limit == pytest.approx(expected)
    assert limit == jstats.burke_limit(scores, stddevs, 0.999, 75.0)


def test_bh_threshold_textbook():
    p = np.array([0.01, 0.04, 0.03, 0.005, 0.2])
    assert bh_threshold(p, 0.25) == pytest.approx(0.2)
    assert bh_threshold(p, 0.25) == jstats.bh_threshold(p, 0.25)
    assert bh_threshold(np.array([0.9, 0.95]), 0.01) is None
    assert bh_threshold(np.array([]), 0.05) is None


def test_bh_threshold_descending_scan_semantics():
    p = np.array([0.001, 0.01, 0.02, 0.04, 0.5])
    assert bh_threshold(p, 0.05) == pytest.approx(0.04)
    assert bh_threshold(p, 0.05) == jstats.bh_threshold(p, 0.05)


def test_top_n_threshold_keeps_ties():
    scores = np.array([5.0, 3.0, 3.0, 1.0])
    t = top_n_threshold(scores, 2)
    assert t == 3.0 == jstats.top_n_threshold(scores, 2)
    assert (scores >= t).sum() == 3


def test_merge_windows_gap_and_clamp():
    seqids = ["chr1"] * 4 + ["chr2"]
    starts = np.array([0, 500, 1000, 300_000, 100])
    segs = merge_windows(seqids, starts, extension=100_000, chrom_lengths={"chr1": 350_000})
    assert segs == [
        ("chr1", 0, 101_000),
        ("chr1", 300_000, 349_999),
        ("chr2", 100, 100_100),
    ]
    assert segs == jstats.merge_windows(
        seqids, starts, extension=100_000, chrom_lengths={"chr1": 350_000}
    )


def test_merge_windows_empty():
    assert merge_windows([], np.array([]), 1000) == []


def test_filter_fet_regions_end_to_end():
    n = 100
    rs = np.random.default_rng(0)
    seqids = ["chr1"] * n
    starts = np.arange(n) * 500
    scores = rs.normal(2.0, 0.01, n)
    scores[40:43] = 50.0
    stddevs = np.full(n, 0.05)
    cfg = FetFilterConfig(max_distance=1000)
    call = filter_fet_regions(seqids, starts, scores, stddevs, cfg)
    assert call.n_windows_passing == 3
    assert call.segments == [("chr1", 40 * 500, 42 * 500 + 1000)]
    assert call.threshold == pytest.approx(np.median(scores) + sstats.norm.ppf(0.999) * 0.05)
    _same_call(call, jstats.filter_fet_regions(seqids, starts, scores, stddevs, _jax_cfg(cfg)))


def test_call_css_regions_fdr_and_top():
    n = 50
    seqids = ["chr1"] * n
    starts = np.arange(n) * 500
    scores = np.linspace(1, 5, n)
    pvals = np.full(n, 0.8)
    pvals[10:13] = 1e-4
    cfg = CssRegionConfig(mode="fdr", fdr=0.05)
    call = call_css_regions(seqids, starts, scores, pvals, cfg)
    assert call.n_windows_passing == 3
    assert call.segments == [("chr1", 5000, 6000 + 2500)]
    assert call.info["estimated_false_discoveries"] == pytest.approx(1e-4 * n)
    _same_call(call, jstats.call_css_regions(seqids, starts, scores, pvals, _jax_cfg(cfg)))

    cfg = CssRegionConfig(mode="top", num_top=5)
    call = call_css_regions(seqids, starts, scores, pvals, cfg)
    assert call.n_windows_passing == 5
    assert call.segments == [("chr1", 45 * 500, 49 * 500 + 2500)]
    _same_call(call, jstats.call_css_regions(seqids, starts, scores, pvals, _jax_cfg(cfg)))


def test_call_css_regions_none_found():
    args = (["chr1"], np.array([0]), np.array([1.0]), np.array([0.9]))
    cfg = CssRegionConfig(mode="fdr", fdr=0.01)
    call = call_css_regions(*args, cfg)
    assert call.segments == []
    assert call.info.get("none_found")
    _same_call(call, jstats.call_css_regions(*args, _jax_cfg(cfg)))


def _seeded_tracks(seed):
    """Three chromosomes of 500 bp windows: background scores, a few
    divergent runs, p-values with small values inside the runs."""
    rs = np.random.default_rng(seed)
    seqids, starts, scores, aux, pvals = [], [], [], [], []
    for seqid, n in (("chrI", 900), ("chrII", 600), ("chrUn", 80)):
        s = rs.gamma(2.0, 0.6, n)
        p = rs.uniform(0.01, 1.0, n)
        for lo in rs.integers(0, n - 12, 3):
            s[lo:lo + rs.integers(2, 12)] += rs.uniform(4, 9)
            p[lo:lo + 4] = rs.uniform(1e-6, 1e-4, 4)
        keep = rs.random(n) > 0.1           # windows without SNPs are absent
        seqids += [seqid] * int(keep.sum())
        starts.append(np.arange(n)[keep] * 500)
        scores.append(s[keep])
        aux.append(rs.uniform(0.01, 0.4, n)[keep])
        pvals.append(p[keep])
    return seqids, np.concatenate(starts), np.concatenate(scores), np.concatenate(aux), \
        np.concatenate(pvals)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cfg", [
    FetFilterConfig(),
    FetFilterConfig(max_distance=2000, norm_quantile=0.99, stddev_percentile=50.0),
    CssRegionConfig(),
    CssRegionConfig(mode="top", num_top=25, window_size=1000),
    CssRegionConfig(fdr=1e-9),
], ids=["fet-default", "fet-tight", "css-fdr", "css-top", "css-none"])
def test_callers_equal_jax_on_seeded_tracks(seed, cfg):
    seqids, starts, scores, aux, pvals = _seeded_tracks(seed)
    lengths = {"chrI": 450_000, "chrII": 300_100, "chrUn": 40_000}
    if isinstance(cfg, FetFilterConfig):
        got = filter_fet_regions(seqids, starts, scores, aux, cfg, chrom_lengths=lengths)
        want = jstats.filter_fet_regions(seqids, starts, scores, aux, _jax_cfg(cfg),
                                         chrom_lengths=lengths)
    else:
        got = call_css_regions(seqids, starts, scores, pvals, cfg, chrom_lengths=lengths)
        want = jstats.call_css_regions(seqids, starts, scores, pvals, _jax_cfg(cfg),
                                       chrom_lengths=lengths)
    _same_call(got, want)
    if cfg != CssRegionConfig(fdr=1e-9):
        assert got.segments
