"""The traced span of a ``--trace 1`` run: a few scans after the window
under ``torch.profiler`` (CPU and CUDA activities), read back from its
chrome trace, and checked against the kernel wrappers' launch counts over
the same scans.  A wrapper launch starts at least one kernel of its own;
where the trace holds fewer records of a wrapper's kernels than the
wrapper counted launches (records lost, as in long profiled spans), the
span is shortened and traced again, down to one scan; if even that
disagrees, the trace is marked incomplete and its metrics stay silent.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

import numpy as np

# the kernels (``csrc/``) each wrapper launch starts at least one of
WRAPPER_KERNELS = {
    "css_dissim": ("css_dissim",), "css_dissim_tiles": ("css_dissim_rows", "css_dissim_tile"),
    "css_dissim_gathered": ("css_dissim_gathered",),
    "css_cmds": ("css_cmds",), "css_cmds_block": ("css_cmds_block",),
    "css_smacof": ("css_smacof",), "css_smacof_block": ("css_smacof_block",),
    "css_mc_coeff": ("css_mc_coeff",), "css_mc_coeff_block": ("css_mc_coeff_write",),
    "css_mc_shared": ("css_mc_shared_tile",), "css_mc_scan": ("css_mc_scan",),
    "css_mc_window": ("window_hits",), "css_mc_window_block": ("window_hits_block",),
    "css_mc_power": ("power_shared", "power_sums"),
    "css_mc_power_window_block": ("power_window_block",),
    "css_perm_chunk": ("perm_chunk",), "css_perm_chunk_block": ("perm_chunk_block",),
    "fet_lut_build": ("fet_lut_build",), "fet_snp_logs": ("fet_snp_logs",),
    "fet_aggregate": ("fet_aggregate", "fet_aggregate_warp"),
    "fet_aggregate_wide": ("fet_aggregate_wide",),
    "fet_window": ("fet_window", "fet_window_warp"), "fet_window_wide": ("fet_window_wide",),
    "fet_lut_rank": ("lut_onesweep",), "fet_snp_ranks": ("snp_rank_lookup",),
    "fet_aggregate_ranks": ("fet_aggregate_ranks", "fet_aggregate_ranks_warp"),
    "fet_aggregate_ranks_wide": ("fet_aggregate_ranks_wide",),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
SCAN_RANGE = "gpubench.scan"


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list          # (short name, seconds) of every kernel record in the window
    device_ops: list       # [[name, seconds]] top 10
    idle_gaps: list        # [[host activity, seconds]] top 10
    scans: list            # gpubench.scans.Scan of the traced span
    launches: dict         # wrapper launch counts over the span
    complete: bool
    note: str = ""
    order: list = dataclasses.field(default_factory=list)   # group of each traced scan

    def kernel_seconds(self, names) -> float:
        return sum(s for n, s in self.kernels if n in names)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_chrome_trace(events: list, scans: list, launches: dict) -> Trace:
    """The span between the first scan range's start and the last one's
    end: its device intervals, their union, the longest kernels and the
    idle gaps named by the innermost host activity at their middle."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = [e for e in xs if e.get("name") == SCAN_RANGE and e.get("cat") == "user_annotation"]
    if not ranges:
        return Trace(0.0, 0.0, [], [], [], scans, launches, False, "no scan range in the trace")
    w0 = min(e["ts"] for e in ranges)
    w1 = max(e["ts"] + e["dur"] for e in ranges)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    kernels = [(short_name(e["name"]), e["dur"] * 1e-6) for e in dev if e["cat"] == "kernel"]
    merged = _merge([[max(e["ts"], w0), min(e["ts"] + e["dur"], w1)] for e in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    by_name: dict = {}
    for n, s in kernels:
        by_name[n] = by_name.get(n, 0.0) + s
    for e in dev:
        if e["cat"] != "kernel":
            by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + e["dur"] * 1e-6
    device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10]
    host = [e for e in xs if e.get("cat") in HOST_CATS and e["ts"] < w1
            and e["ts"] + e["dur"] > w0]
    h_ts = np.array([e["ts"] for e in host], dtype=np.float64)
    h_dur = np.array([e["dur"] for e in host], dtype=np.float64)
    gaps: dict = {}
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        over = np.nonzero((h_ts <= mid) & (h_ts + h_dur >= mid))[0]
        name = host[over[np.argmin(h_dur[over])]]["name"] if len(over) else "host (no range)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    idle_gaps = sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10]
    counted = {}
    for n, _ in kernels:
        counted[n] = counted.get(n, 0) + 1
    missing = [w for w, d in launches.items()
               if d > 0 and w in WRAPPER_KERNELS
               and sum(counted.get(k, 0) for k in WRAPPER_KERNELS[w]) < d]
    note = f"fewer kernel records than launches of {missing}" if missing else ""
    return Trace((w1 - w0) * 1e-6, busy, kernels, device_ops, idle_gaps, scans, launches,
                 not missing, note)


def profile(program, groups: list, order: list, clock) -> Trace:
    """Scans ``order`` (group indices) under the profiler; the trace is
    written to ``TMPDIR`` and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    on_card = torch.device(program.device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    before = program.launches()
    scans = []
    with torch.profiler.profile(activities=acts) as prof:
        for g in order:
            with record_function(SCAN_RANGE):
                scans.append(program.scan(groups[g], clock))
        if on_card:
            torch.cuda.synchronize()
    after = program.launches()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    tr = read_chrome_trace(events, scans, {k: after[k] - before[k] for k in after})
    tr.order = list(order)
    return tr


def traced_span(program, groups: list, first: int, scans: int, clock) -> Trace:
    """:func:`profile` over ``scans`` scans from group ``first`` on, halved
    until every wrapper's launches have their kernel records."""
    n = max(1, scans)
    while True:
        order = [(first + i) % len(groups) for i in range(n)]
        tr = profile(program, groups, order, clock)
        if tr.complete or n == 1:
            return tr
        n //= 2
