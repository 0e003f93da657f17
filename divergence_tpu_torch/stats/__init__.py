"""Host-side statistics: region calling over score tracks
(``divergence_tpu/stats``)."""

from divergence_tpu_torch.stats.regions import (
    RegionCall,
    bh_threshold,
    burke_limit,
    call_css_regions,
    filter_fet_regions,
    merge_windows,
    top_n_threshold,
)

__all__ = [
    "RegionCall",
    "burke_limit",
    "bh_threshold",
    "top_n_threshold",
    "merge_windows",
    "filter_fet_regions",
    "call_css_regions",
]
