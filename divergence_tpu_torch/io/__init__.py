"""GTrack, VCF, SNP-table and chrom-sizes I/O (copied from the JAX package)."""

from divergence_tpu_torch.io.genome import read_chrom_sizes
from divergence_tpu_torch.io.gtrack import (
    PopulationTrack,
    read_gtrack_points,
    read_score_track,
    write_score_track,
    write_segments_track,
)
from divergence_tpu_torch.io.vcf import GENOTYPE_CODES, vcf_to_gtrack

__all__ = [
    "GENOTYPE_CODES",
    "PopulationTrack",
    "read_chrom_sizes",
    "read_gtrack_points",
    "read_score_track",
    "vcf_to_gtrack",
    "write_score_track",
    "write_segments_track",
]
