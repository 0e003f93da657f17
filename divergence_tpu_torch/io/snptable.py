"""Jones-et-al-style SNP table → GTrack valued points.

The reference's stickleback converter
(tools/ConvertSticklebackSnpsToGtrack.py:53-69) delegates to the platform
helper ``quick.webtools.SNPconvert.convertToGtrackFile`` which is NOT in
the reference repo (SURVEY.md §2.3); only its interface is visible: a raw
SNP table plus a list of individual IDs to extract, producing a GTrack
valued-points file.  This module re-provides that capability for the
common published layout of the Jones et al. 2012 stickleback SNP tables:

    seqid  pos  allele1  allele2  <genotype per individual> ...

where each genotype is a two-letter string (``AA``, ``AG``, ...) or a
missing marker (``NN``, ``--``, ``..``).  Codes follow the framework data
model (reference tools/VCFConvert.py:8-17): both letters == allele1 → 3,
both == allele2 → -3, mixed → 0, missing/other → -10000.

Copied from ``divergence_tpu/io/snptable.py``; only the imports differ.
``tests/test_torch_host_copies.py`` holds the copy equal to the original.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from divergence_tpu_torch.io.gtrack import gtrack_points_header

MISSING_MARKERS = {"NN", "--", "..", "00", "??"}


def snp_table_to_gtrack(
    table_path: str | Path,
    ids: Iterable[str | int],
    out_path: str | Path,
    genome: str = "unknown",
) -> list[str]:
    """Convert a SNP table to a GTrack valued-points file.

    ``ids`` selects individuals: header names if the table has a header
    line (first line starting with ``#`` or with a non-numeric second
    column), else 0-based column offsets into the genotype columns
    (matching the reference GUI's "comma-separated list over IDs",
    reference tools/ConvertSticklebackSnpsToGtrack.py:31).
    Returns the list of individual labels written."""
    import itertools

    ids = [str(x).strip() for x in ids]
    with open(table_path) as fh:
        # skip prose comment preamble: the header is the LAST leading
        # '#' line that actually has tab-separated columns (a published
        # table often starts with free-text '#' comments above it)
        first = fh.readline().rstrip("\n")
        while (
            first.startswith("#")
            and len(first.lstrip("#").split("\t")) < 3
        ):
            nxt = fh.readline()
            if not nxt:
                break
            first = nxt.rstrip("\n")
        cols = first.lstrip("#").split("\t")
        has_header = first.startswith("#") or (
            len(cols) > 1 and not cols[1].isdigit()
        )
        if has_header:
            header = cols
            data_lines = fh
            carry = None
        else:
            header = None
            data_lines = fh
            carry = first

        if header is not None:
            sel: list[int] = []
            labels: list[str] = []
            missing: list[str] = []
            for name in ids:
                if name in header:
                    sel.append(header.index(name))
                    labels.append(name)
                else:
                    missing.append(name)
            if missing:
                # a typo'd ID must not silently shrink the panel — the
                # downstream divergence analysis would be wrong with no
                # signal (population size is inferred from the data)
                raise ValueError(
                    f"individual IDs not in SNP table header: {missing}; "
                    f"header has {header[:8]}..."
                )
        else:
            sel = [4 + int(i) for i in ids]
            labels = ids
            # bounds-check offsets against the first data row: an
            # out-of-range id would otherwise produce a phantom
            # all-missing individual with no signal (the same silent
            # panel corruption the header branch raises on)
            ncols = len((carry or "").split("\t"))
            bad = [
                i for i, col in zip(ids, sel) if col < 4 or col >= ncols
            ]
            if bad:
                raise ValueError(
                    f"individual column offsets out of range: {bad} "
                    f"(table has {max(ncols - 4, 0)} genotype columns)"
                )
        if not labels:
            raise ValueError("no individual IDs selected")

        with open(out_path, "w") as out:
            out.write(gtrack_points_header(genome))
            lines = itertools.chain(
                [carry] if carry is not None else [], data_lines
            )
            for line in lines:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                c = line.split("\t")
                seqid, pos, a1, a2 = c[0], c[1], c[2].upper(), c[3].upper()
                for col, label in zip(sel, labels):
                    gt = c[col].upper() if col < len(c) else "NN"
                    if gt in MISSING_MARKERS or len(gt) != 2:
                        code = -10000
                    elif gt[0] == gt[1] == a1[0]:
                        code = 3
                    elif gt[0] == gt[1] == a2[0]:
                        code = -3
                    elif {gt[0], gt[1]} == {a1[0], a2[0]}:
                        code = 0
                    else:
                        code = -10000
                    out.write(f"{seqid}\t{pos}\t{code}\t{label}\n")
    return labels
