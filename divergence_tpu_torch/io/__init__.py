"""GTrack and chrom-sizes I/O (copied from the JAX package)."""

from divergence_tpu_torch.io.genome import read_chrom_sizes
from divergence_tpu_torch.io.gtrack import (
    PopulationTrack,
    read_gtrack_points,
    read_score_track,
    write_score_track,
    write_segments_track,
)

__all__ = [
    "PopulationTrack",
    "read_chrom_sizes",
    "read_gtrack_points",
    "read_score_track",
    "write_score_track",
    "write_segments_track",
]
