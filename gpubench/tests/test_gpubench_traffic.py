import numpy as np
import pytest

from gpubench import traffic
from gpubench.reference.windows import plan_windows

CONFIG = {"asize": 11, "bsize": 10, "snps_per_kb": 20, "missing_share": 0.03}


def mix(share, bp=200_000, island_bp=10_000):
    return {"scan": "css", "chromosomes": 2, "per_scan": 1, "bp": bp,
            "divergent_bp_share": share, "island_bp": island_bp}


@pytest.mark.parametrize("share", [0.0, 0.1, 1.0])
def test_chromosome_shape_and_codes(share):
    c = traffic.chromosome(CONFIG, mix(share), 2**31 + 17, 0, "cpu")
    assert c.positions.dtype == np.int64 and len(c.positions) == 4_000
    assert np.all(np.diff(c.positions) > 0) and c.positions[0] >= 1
    assert c.positions[-1] < 200_000
    assert c.avals.shape == (4_000, 11) and c.bvals.shape == (4_000, 10)
    assert c.avals.dtype == np.int16
    assert set(np.unique(np.concatenate([c.avals, c.bvals], 1))) <= {3, 0, -3, -10000}
    miss = (np.concatenate([c.avals, c.bvals], 1) == -10000).mean()
    assert 0.02 < miss < 0.04


def test_same_seed_same_panel_other_seed_other_panel():
    a = traffic.chromosome(CONFIG, mix(0.1), 5_000_000_000, 1, "cpu")
    b = traffic.chromosome(CONFIG, mix(0.1), 5_000_000_000, 1, "cpu")
    c = traffic.chromosome(CONFIG, mix(0.1), 5_000_000_001, 1, "cpu")
    assert np.array_equal(a.positions, b.positions) and np.array_equal(a.avals, b.avals)
    assert not np.array_equal(a.positions, c.positions)
    assert len(a.positions) == len(c.positions)


def _major_gap(c):
    """Mean |major-homozygote share A - B| over the SNPs."""
    fa = (c.avals == 3).mean(1)
    fb = (c.bvals == 3).mean(1)
    return np.abs(fa - fb)


def test_islands_hold_the_divergence():
    share, bp, isl = 0.1, 400_000, 10_000
    c = traffic.chromosome(CONFIG, mix(share, bp, isl), 99, 0, "cpu")
    gap = _major_gap(c)
    shared = traffic.chromosome(CONFIG, mix(0.0, bp), 99, 0, "cpu")
    apart = traffic.chromosome(CONFIG, mix(1.0, bp), 99, 0, "cpu")
    # an island's SNPs differ as much as an all-divergent chromosome's
    assert _major_gap(apart).mean() > 1.5 * _major_gap(shared).mean()
    top = np.sort(gap)[::-1][: int(0.05 * len(gap))].mean()
    assert top > np.sort(_major_gap(shared))[::-1][: int(0.05 * len(gap))].mean()
    # every seed: the same number of SNPs and the same windows planned
    other = traffic.chromosome(CONFIG, mix(share, bp, isl), 100, 0, "cpu")
    assert len(other.positions) == len(c.positions)
    p1 = plan_windows(c.positions, bp, 2500, 500)
    p2 = plan_windows(other.positions, bp, 2500, 500)
    assert len(p1.lo) == len(p2.lo)


def test_chromosomes_named_and_counted():
    cs = traffic.chromosomes(CONFIG, mix(1.0, 50_000), 3, "cpu")
    assert [c.seqid for c in cs] == ["chr1", "chr2"]
    assert all(c.bp == 50_000 for c in cs)


def test_islands_longer_than_stretch_refused():
    with pytest.raises(ValueError):
        traffic.chromosome(CONFIG, mix(0.9, 100_000, 60_000), 1, 0, "cpu")
