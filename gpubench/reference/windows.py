"""Frozen copy of ``divergence_tpu_torch/core/windows.py:plan_windows``:
the sliding windows of the reference tools (a window ``[start, start +
wsize]`` holds the SNPs with ``start <= pos <= start + wsize``, window k
starts at ``k * wstep`` while ``start + wsize <= regend + wstep``, and
writes slot ``start // wstep`` of ``regend // wstep``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WindowPlan:
    lo: np.ndarray       # [W] first SNP index in the window
    npos: np.ndarray     # [W] SNPs in the window
    slot: np.ndarray     # [W] output slot
    nslots: int

    def evaluated(self) -> np.ndarray:
        """The windows a scan scores: SNPs in them and a slot in range."""
        return (self.npos > 0) & (self.slot < self.nslots)


def plan_windows(positions: np.ndarray, regend: int, wsize: int, wstep: int) -> WindowPlan:
    positions = np.asarray(positions)
    if regend + wstep < wsize:
        starts = np.zeros(0, dtype=np.int64)
    else:
        n = (regend + wstep - wsize) // wstep + 1
        starts = np.arange(n, dtype=np.int64) * wstep
    lo = np.searchsorted(positions, starts, side="left")
    hi = np.searchsorted(positions, starts + wsize, side="right")
    return WindowPlan(lo=lo.astype(np.int64), npos=(hi - lo).astype(np.int64),
                      slot=(starts // wstep).astype(np.int64),
                      nslots=max(regend // wstep, 0))
