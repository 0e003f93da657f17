"""Window-axis sharding over a device mesh, and multi-host partitioning
(``divergence_tpu/parallel``).

The reference's parallel runtime is a 64-thread pthread pool with a
mutex-guarded task counter (reference statistics/css/threadcss.c:19-25);
here the window axis is cut into contiguous shares over a tuple of torch
devices (:func:`make_mesh`, :func:`window_slices`), and the hosts of a
multi-host run take disjoint slot ranges (:func:`partition_chromosomes`)
whose score-track shards are merged afterwards.
"""

from divergence_tpu_torch.parallel.mesh import (
    WINDOW_AXIS,
    make_mesh,
    pad_to_multiple,
    window_slices,
)
from divergence_tpu_torch.parallel.multihost import (
    HostAssignment,
    WorkRange,
    merge_score_shards,
    partition_chromosomes,
)
from divergence_tpu_torch.parallel.sharded import make_divergence_step

__all__ = [
    "WINDOW_AXIS",
    "make_mesh",
    "window_slices",
    "pad_to_multiple",
    "make_divergence_step",
    "HostAssignment",
    "WorkRange",
    "partition_chromosomes",
    "merge_score_shards",
]
