"""Aligned two-population SNP pair — the engine's input contract
(``divergence_tpu/engine/snp.py``).

The reference keeps two flattened position-major arrays per group and
assumes their position sets are identical (the kernels index group B's
window with group A's SNP count, reference statistics/fisher/cFisher.c:85-92).  Here the alignment is
*verified* at construction and the matrices are kept 2-D.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from divergence_tpu_torch.io.gtrack import PopulationTrack


@dataclasses.dataclass
class SnpPair:
    """Aligned SNP matrices for two populations on one chromosome."""

    positions: np.ndarray  # [npos] unique sorted positions
    avals: np.ndarray      # [npos, asize] genotype codes
    bvals: np.ndarray      # [npos, bsize]
    _device_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def to_device(
        self, device: str | torch.device, compact: bool = True, summary=None
    ) -> torch.Tensor:
        """Both populations as ONE ``[npos, asize+bsize]`` tensor on
        ``device`` (group-A columns first), uploaded once and cached per
        (device, compact).  An upload adds its bytes to the ``RunSummary``
        counter ``h2d_bytes`` where ``summary`` is given; a cached tensor
        adds nothing.

        ``compact=True`` uploads int16 when every value is an integer in
        int16 range (always true for the converter's genotype codes
        {3, -3, 0, -10000}, reference tools/VCFConvert.py:8-17): FET only
        ``==``-compares codes (``count_tables``), so the result is
        identical at a quarter of the float64 bytes.  Non-integral values
        keep their host dtype.  Unlike the JAX package, the SNP axis is not
        padded to a power of two: that padding only avoided XLA
        recompiles per chromosome length."""
        device = torch.device(device)
        compact = compact and self._int16_safe()
        key = (str(device), compact)
        cached = self._device_cache.get(key)
        if cached is None:
            mat = np.concatenate([self.avals, self.bvals], axis=1)
            if compact:
                mat = mat.astype(np.int16)
            cached = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
            self._device_cache[key] = cached
            if summary is not None:
                c = summary.counters
                c["h2d_bytes"] = c.get("h2d_bytes", 0) + cached.nbytes
        return cached

    def _int16_safe(self) -> bool:
        """True when both matrices hold integers representable in int16
        (cached — one host pass over each matrix)."""
        ok = self._device_cache.get("int16_safe")
        if ok is None:
            def check(mat):
                if np.issubdtype(mat.dtype, np.integer):
                    return bool(
                        mat.min(initial=0) >= -32768
                        and mat.max(initial=0) <= 32767
                    )
                return bool(
                    np.all(np.abs(mat) <= 32767.0)
                    and np.all(mat == np.trunc(mat))
                )
            ok = check(self.avals) and check(self.bvals)
            self._device_cache["int16_safe"] = ok
        return ok

    @property
    def asize(self) -> int:
        return self.avals.shape[1]

    @property
    def bsize(self) -> int:
        return self.bvals.shape[1]

    @property
    def npos(self) -> int:
        return len(self.positions)

    def slice_span(self, pos_lo: int, pos_hi: int) -> "SnpPair":
        """New pair restricted to positions in ``[pos_lo, pos_hi]``
        (inclusive, the window span of ``core/windows.plan_windows``), with
        a device cache of its own.  Slot-range multi-host partitioning
        gives a host its owned slots' span plus the wsize - wstep halo at
        each cut: window contents, and so scores and slot-keyed streams,
        are unchanged."""
        i0 = int(np.searchsorted(self.positions, pos_lo, side="left"))
        i1 = int(np.searchsorted(self.positions, pos_hi, side="right"))
        return SnpPair(
            positions=self.positions[i0:i1],
            avals=self.avals[i0:i1],
            bvals=self.bvals[i0:i1],
        )

    @classmethod
    def from_tracks(cls, a: PopulationTrack, b: PopulationTrack) -> "SnpPair":
        pa = a.positions_unique()
        pb = b.positions_unique()
        if len(pa) != len(pb) or not np.array_equal(pa, pb):
            raise ValueError(
                f"{a.seqid}: population position sets differ "
                f"({len(pa)} vs {len(pb)} SNPs); the divergence statistics "
                "require both groups called at the same SNPs"
            )
        return cls(
            positions=pa,
            avals=a.values_matrix(),
            bvals=b.values_matrix(),
        )
