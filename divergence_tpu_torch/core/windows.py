"""Host-side sliding-window planning.

Copied verbatim from ``divergence_tpu/core/windows.py``: importing the JAX
package imports jax, and the port runs where jax is not installed.
``tests/test_torch_host_copies.py`` holds the two equal.

The reference advances two pointers per window inside each worker thread
(``slide_right``, reference statistics/css/comparative.c:49-71; driver loops reference statistics/css/css.c:117-135,
reference statistics/css/threadcss.c:253-275).  On a static-shape machine the right design is to
precompute *all* window index ranges up front with one vectorized
searchsorted pass, then hand dense, padded batches to the device
(SURVEY.md §5 long-context analogue, §7.6).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WindowPlan:
    """Index ranges for every sliding window over one chromosome.

    ``lo``/``npos`` index the *unique-position* axis of the SNP matrix
    (not the flattened row axis).  ``slot`` is the output-array index
    (``start // wstep``), matching the reference's scatter
    (reference statistics/css/threadcss.c:262)."""

    starts: np.ndarray   # [W] window start (bp)
    lo: np.ndarray       # [W] first SNP index in window
    npos: np.ndarray     # [W] number of SNPs in window
    slot: np.ndarray     # [W] output slot
    nslots: int          # output array length (regend // wstep)
    wsize: int
    wstep: int

    @property
    def num_windows(self) -> int:
        return len(self.starts)

    def valid_mask(self) -> np.ndarray:
        """Windows the engines evaluate: npos > 0 (reference statistics/css/css.c:123) and slot in
        range (the Python adapter truncates trailing windows whose slot
        falls outside the ``regend // wstep`` allocation)."""
        return (self.npos > 0) & (self.slot < self.nslots)


def plan_windows(
    positions: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
) -> WindowPlan:
    """Plan every window in one vectorized pass.

    ``positions``: [npos] unique, sorted SNP positions.
    A window [start, start+wsize] contains SNPs with
    ``start <= pos <= start + wsize`` (slide_right keeps ``pos >= start``
    on the left and ``pos <= stop`` on the right, reference statistics/css/comparative.c:59-65).
    """
    positions = np.asarray(positions)
    if regend + wstep < wsize:
        starts = np.zeros(0, dtype=np.int64)
    else:
        n = (regend + wstep - wsize) // wstep + 1
        starts = np.arange(n, dtype=np.int64) * wstep
    lo = np.searchsorted(positions, starts, side="left")
    hi = np.searchsorted(positions, starts + wsize, side="right")
    return WindowPlan(
        starts=starts,
        lo=lo.astype(np.int64),
        npos=(hi - lo).astype(np.int64),
        slot=(starts // wstep).astype(np.int64),
        nslots=max(regend // wstep, 0),
        wsize=wsize,
        wstep=wstep,
    )
