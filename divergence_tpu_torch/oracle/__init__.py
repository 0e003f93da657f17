"""CPU oracle: an independent NumPy statement of the exact reference
semantics, the ground truth of the differential fuzz lane
(``tools/fuzz_ref.py``).

``reference.py`` is a byte copy of the JAX package's
``divergence_tpu/oracle/reference.py`` (it imports only ``math`` and
``numpy``); importing it from there would import jax, which the port
must not need.
"""

from divergence_tpu_torch.oracle.reference import (
    fet_count,
    fet_point_prob,
    fet_two_tailed,
    percentile_interp,
    window_fet,
    compute_fet,
    compare_all,
    compare_freq,
    fill_averages,
    cmds,
    calc_dist,
    css_score,
    smacof,
    smacof_runs,
    significance,
    window_css,
    compute_css,
)

__all__ = [
    "fet_count",
    "fet_point_prob",
    "fet_two_tailed",
    "percentile_interp",
    "window_fet",
    "compute_fet",
    "compare_all",
    "compare_freq",
    "fill_averages",
    "cmds",
    "calc_dist",
    "css_score",
    "smacof",
    "smacof_runs",
    "significance",
    "window_css",
    "compute_css",
]
