"""Genome metadata: chromosome names and lengths.

Copied verbatim from ``divergence_tpu/io/genome.py``: importing the JAX
package imports jax, and the port runs where jax is not installed.
``tests/test_torch_host_copies.py`` holds the two equal.

The reference pulls these from the HyperBrowser platform
(``GenomeInfo.getChrList`` / ``getChrLen``, reference
tools/FilterFisherScores.py:95, :109 — off-repo, SURVEY.md §2.6).  Here a
plain chrom-sizes file (two tab-separated columns ``seqid  length``, the
standard UCSC format) replaces the platform service.
"""

from __future__ import annotations

from pathlib import Path


def read_chrom_sizes(path: str | Path) -> dict[str, int]:
    """Read a UCSC-style chrom.sizes file into {seqid: length}."""
    sizes: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            sizes[cols[0]] = int(cols[1])
    return sizes


def write_chrom_sizes(path: str | Path, sizes: dict[str, int]) -> None:
    with open(path, "w") as fh:
        for seqid, length in sizes.items():
            fh.write(f"{seqid}\t{length}\n")
