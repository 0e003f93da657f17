"""Seeded synthetic SNP data for smoke runs and benchmarks.

* :func:`make_chromosome` — the JAX package's bench workload generator
  (``bench.py:make_chromosome``, same stream for the same arguments):
  sorted distinct positions, Hardy-Weinberg genotypes from a per-SNP
  major-allele frequency, 3 % missing calls.
* :func:`make_panel` — stickleback-shaped two-population panel
  (``tests/conftest.py:make_panel``, vectorised): a fraction of SNPs is
  divergent between the groups, the rest share one frequency.
* :func:`make_freq_chromosome` — drosophila-mode test data: one
  allele-frequency column per population (``tests/test_engines.py``
  drosophila test, vectorised).
* :func:`write_gtrack` — one population as a GTrack valued-points file.

Genotype codes: 3 / -3 homozygous, 0 heterozygous, -10000 missing
(reference tools/VCFConvert.py:8-17).  Genotype matrices are int16,
frequency columns float64.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from divergence_tpu_torch.io.gtrack import gtrack_points_header


def make_chromosome(
    npos: int, region: int, asize: int, bsize: int, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, amat, bmat) of the bench's FET workload."""
    rng = np.random.default_rng(seed)
    if npos > 500_000:
        # oversampled unique ints instead of choice over arange(region)
        cand = rng.integers(1, region, size=int(npos * 1.05) + 64)
        positions = np.unique(cand)
        if len(positions) < npos:
            raise ValueError(f"region {region} too small for {npos} SNPs")
        positions = positions[
            np.sort(rng.choice(len(positions), npos, replace=False))
        ]
    else:
        positions = np.sort(
            rng.choice(
                np.arange(1, region, dtype=np.int64), npos, replace=False
            )
        )

    def draw(size):
        p_major = rng.uniform(0.2, 0.9, size=(npos, 1))
        g = rng.random((npos, size))
        het = p_major * (1 - p_major) * 2
        mat = np.where(
            g < p_major**2,
            3.0,
            np.where(g < p_major**2 + het, 0.0, -3.0),
        )
        miss = rng.random((npos, size)) < 0.03
        return np.where(miss, -10000.0, mat).astype(np.int16)

    return positions, draw(asize), draw(bsize)


def make_panel(
    npos: int,
    region: int,
    asize: int = 11,
    bsize: int = 10,
    seed: int = 0,
    divergent_frac: float = 0.15,
    missing_frac: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, amat, bmat): a two-population panel where a
    ``divergent_frac`` share of SNPs has a high major-allele frequency in
    group A and a low one in group B."""
    rng = np.random.default_rng(seed)
    cand = np.unique(rng.integers(1, region, size=int(npos * 1.2) + 64))
    if len(cand) < npos:
        raise ValueError(f"region {region} too small for {npos} SNPs")
    positions = np.sort(rng.choice(cand, npos, replace=False))
    divergent = rng.random(npos) < divergent_frac
    pa = np.where(
        divergent, rng.uniform(0.6, 0.95, npos), rng.uniform(0.3, 0.7, npos)
    )
    pb = np.where(divergent, rng.uniform(0.05, 0.4, npos), pa)

    def draw(size, p):
        p = p[:, None]
        g = rng.random((npos, size))
        hw = np.where(
            g < p * p, 3, np.where(g < p * p + (1 - p) * (1 - p), -3, 0)
        )
        miss = rng.random((npos, size)) < missing_frac
        return np.where(miss, -10000, hw).astype(np.int16)

    return positions, draw(asize, pa), draw(bsize, pb)


def make_freq_chromosome(
    npos: int, region: int, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, fa, fb): sorted distinct positions in [1, region) and
    two independent uniform [0, 1) frequency columns [npos, 1]."""
    rng = np.random.default_rng(seed)
    positions = np.sort(rng.choice(region - 1, size=npos, replace=False) + 1)
    fa = rng.uniform(0.0, 1.0, (npos, 1))
    fb = rng.uniform(0.0, 1.0, (npos, 1))
    return positions.astype(np.int64), fa, fb


def write_gtrack(
    path: str | Path,
    seqid: str,
    positions: np.ndarray,
    mat: np.ndarray,
    genome: str = "synthetic",
) -> None:
    """One row per (SNP, individual), position-major."""
    tail = f"\t{genome}\n"
    with open(path, "w") as fh:
        fh.write(gtrack_points_header(genome))
        for p, row in zip(positions.tolist(), mat.tolist()):
            head = f"{seqid}\t{p}\t"
            fh.write("".join(f"{head}{v}{tail}" for v in row))
