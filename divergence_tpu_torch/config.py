"""Typed configuration for the FET scan.

``WindowConfig`` and ``FetConfig`` copied verbatim from
``divergence_tpu/config.py`` (the JAX package imports jax, and the port
runs where jax is not installed); ``tests/test_torch_host_copies.py``
holds the two equal.  As there, the library defaults to
``precision="exact"`` and the CLI to ``fast``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Sliding-window geometry.

    Defaults match the reference GUI defaults
    (reference tools/FisherExactTestSNPTool.py:118-122).
    """

    wsize: int = 2500   # window size in base pairs
    wstep: int = 500    # window step in base pairs

    def __post_init__(self) -> None:
        if self.wsize <= 0 or self.wstep <= 0:
            raise ValueError("wsize and wstep must be positive")
        # wstep > wsize (sparse, non-overlapping sampling) is legal: the
        # reference validates only integer-ness (reference
        # tools/FisherExactTestSNPTool.py:199-223) and the window-loop
        # semantics are well-defined for any positive geometry
        # (tests/test_ref_c_differential.py::
        #  test_sparse_window_geometry_matches_reference_c)

    def num_slots(self, regend: int) -> int:
        """Length of the output score arrays.

        The reference Python adapter allocates ``regend // wstep`` slots and
        the kernels write window ``w`` at slot ``w.start // wstep``
        (reference statistics/FisherExactScoreStat.py:51-53,
        statistics/css/threadcss.c:262).
        """
        return max(regend // self.wstep, 0)

    def num_windows(self, regend: int) -> int:
        """Number of sliding windows actually evaluated.

        The serial reference loop runs while ``start + wsize <= regend +
        wstep`` (reference statistics/css/css.c:117); window ``k`` starts at
        ``k * wstep``.
        """
        if regend + self.wstep < self.wsize:
            return 0
        return (regend + self.wstep - self.wsize) // self.wstep + 1


@dataclasses.dataclass(frozen=True)
class FetConfig:
    """Fisher's Exact Test windowed scan.

    Defaults are the Burke et al. 2010 protocol used by the reference
    (reference tools/FisherExactTestSNPTool.py:118-126,
    statistics/fisher/cFisher.c:62).
    """

    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    percentile: float = 0.95      # window score = this percentile of -log10(p)
    bootstrap_samples: int = 100  # replicates for the stddev estimate
    seed: int = 0                 # deterministic RNG stream (reference is
                                  # wall-clock seeded; see SURVEY.md §5)

    # "exact": float64 end-to-end — bit-comparable to the reference's C
    # doubles (f64 is software-emulated on most TPUs).  "fast": float32
    # compute — scores agree with exact to ~1e-5 relative, p-value
    # distribution unchanged; ~2x throughput per chip (docs/PARITY.md).
    precision: str = "exact"

    def __post_init__(self) -> None:
        if not 0.0 <= self.percentile <= 1.0:
            raise ValueError("percentile must be in [0, 1]")
        if self.bootstrap_samples <= 1:
            raise ValueError("bootstrap_samples must be > 1")
        if self.precision not in ("exact", "fast"):
            raise ValueError("precision must be 'exact' or 'fast'")
