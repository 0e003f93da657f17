"""VCF → GTrack valued-points conversion.

Re-provides the reference's converter (tools/VCFConvert.py): diploid
biallelic GT strings map to genotype codes, one output row per
(SNP, individual).

Copied from ``divergence_tpu/io/vcf.py``; only the imports differ (the
native converter is ``divergence_tpu_torch/native``'s).
``tests/test_torch_host_copies.py`` holds the copy equal to the original.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, TextIO

from divergence_tpu_torch.io.gtrack import gtrack_points_header

# GT-string → genotype code (reference tools/VCFConvert.py:8-17)
GENOTYPE_CODES: dict[str, int] = {
    "./.": -10000,
    ".|.": -10000,
    "1/0": 0,
    "0/1": 0,
    "1|0": 0,
    "0|1": 0,
    "0/0": 3,
    "0|0": 3,
    "1/1": -3,
    "1|1": -3,
}


def vcf_to_gtrack(
    vcf_path: str | Path,
    population: Iterable[str],
    out_path: str | Path,
    genome: str = "unknown",
) -> list[str]:
    """Convert a VCF to a GTrack valued-points file for one population.

    Returns the list of population members actually found in the VCF header
    (missing names are dropped with a warning, matching
    reference tools/VCFConvert.py:55-68).
    """
    population = list(population)
    is_gz = str(vcf_path).endswith(".gz")

    if not is_gz:
        # threaded C++ converter (native/vcf_convert.cpp) — identical
        # output bytes to the Python path below, which defines the
        # semantics (tests/test_native.py pins the equivalence)
        try:
            from divergence_tpu_torch.native import vcf_convert_native

            found = vcf_convert_native(
                vcf_path, out_path, gtrack_points_header(genome), population
            )
            if found is not None:
                for name in population:
                    if name not in found:
                        print(f"warning: {name} not found in VCF header")
                return found
        except ImportError:
            pass

    # .vcf.gz is the common interchange format; the reference converter
    # (tools/VCFConvert.py) reads plain text only — transparent gzip is
    # a documented extension
    if is_gz:
        import gzip

        opener = gzip.open(vcf_path, "rt")
    else:
        opener = open(vcf_path)
    with opener as fh, open(out_path, "w") as out:
        out.write(gtrack_points_header(genome))
        found = _convert_stream(fh, population, out)
    return found


def _convert_stream(fh: TextIO, population: list[str], out: TextIO) -> list[str]:
    header: list[str] | None = None
    chromidx = posidx = formatidx = -1
    gtidx = -1
    popidx: list[int] = []
    found: list[str] = []

    for line in fh:
        line = line.rstrip("\n")
        if not line:
            continue
        if header is None:
            if line.startswith("#CHROM"):
                header = line.split("\t")
                chromidx = header.index("#CHROM")
                posidx = header.index("POS")
                formatidx = header.index("FORMAT")
                for name in population:
                    try:
                        popidx.append(header.index(name))
                        found.append(name)
                    except ValueError:
                        print(f"warning: {name} not found in VCF header")
            continue
        if line.startswith("#"):
            continue
        cols = line.split("\t")
        if gtidx < 0:
            gtidx = cols[formatidx].split(":").index("GT")
        chrom = cols[chromidx]
        pos = cols[posidx]
        for idx, name in zip(popidx, found):
            gt = cols[idx].split(":")[gtidx]
            code = GENOTYPE_CODES.get(gt)
            if code is None:
                # non-biallelic / half-missing calls are treated as missing;
                # the reference would KeyError here (reference tools/VCFConvert.py:83) —
                # documented deviation for robustness.
                code = -10000
            out.write(f"{chrom}\t{pos}\t{code}\t{name}\n")
    if header is None:
        # a truncated/malformed VCF must fail loudly: a header-only
        # GTrack looks valid downstream and yields silently empty
        # results (the reference crashes with IndexError on such input)
        raise ValueError("no #CHROM header line found — not a VCF?")
    return found
