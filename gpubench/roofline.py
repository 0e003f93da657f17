"""The card's published peaks and the least time a piece of work needs:
a frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``PEAK_OPS_PER_S`` and ``bound`` (NVIDIA's H100 SXM data sheet, dense, at
700 W; float32 and float64 outside the tensor cores, a multiply-add two
operations; "f32_op", "i32", "f64_op": single operations that are not
multiply-adds, at their instruction rate, 128 float32 lanes, 64 int32 and
64 float64 lanes per SM and clock, NVIDIA's Hopper whitepaper; "sfu": 16
exp2 / log2 a clock on each of the 132 SMs at 1,980 MHz)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, SFU_PER_SM_CLOCK = 132, 16
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "f32_op": 33.5e12, "i32": 16.75e12,
                  "f64_op": 17e12, "sfu": SFU_PER_SM_CLOCK * SMS * 1.98e9}


def bound_s(nbytes: float, ops: dict) -> tuple[float, str]:
    """(seconds, bound by): the larger of ``nbytes`` (each input read once,
    each output written once) over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[t] for t, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
