"""The readers of the program's spans and counters, on hand-made run
records and traces; and a traced CSS run on the CPU, in which every one
of them but the device trace's reports."""

import time
from pathlib import Path

import pytest
import torch

from gpubench import harness
from gpubench.scans import Scan
from gpubench.tests.tiny import tiny_root
from gpubench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
PROGRAM_READERS = ["css_plan_ms", "css_upload_gb_per_s", "mc_ranges_per_scan",
                   "mc_perms_run_ratio"]


def _scan(plan_s=0.002, upload_s=0.004, h2d=8_000_000, ranges=10, run=2_000_000):
    return Scan(outputs={}, wall_s=0.1,
                timings_s={"css_plan": plan_s, "css_upload": upload_s, "css_mc": 0.08},
                counters={"h2d_bytes": h2d, "mc_ranges": ranges, "mc_perms_run": run})


def _trace(gaps, window_s=0.4, busy_s=0.3):
    return Trace(window_s, busy_s, [], [], gaps, [], {}, True)


def _record(scans, kind="css", perms=1_000_000, trace=None):
    return harness.RunRecord(
        workload="w", config={}, traffic={"scan": kind}, setup_s=1.0, window_s=1.0,
        scans=scans, work=[{"permutations": perms, "scored": 10, "windows": 10}] * len(scans),
        group_work=[], launches={}, trace=trace)


def _read(name, run):
    return harness.reader(REPO, name)(run)


def test_idle_unattributed_share_of_hand_made_gaps():
    gaps = [["gpubench.scan", 0.02], ["css_plan", 0.05], ["aten::copy_", 0.01],
            ["host (no range)", 0.005], ["mc_range", 0.015]]
    run = _record([_scan()], trace=_trace(gaps, window_s=0.4, busy_s=0.3))
    assert _read("idle_unattributed_pct.css", run) == pytest.approx(100 * 0.025 / 0.1)
    named_only = _record([_scan()], trace=_trace([["css_mc", 0.1]]))
    assert _read("idle_unattributed_pct.css", named_only) == 0.0


@pytest.mark.parametrize("trace", [None, _trace([]), _trace([["x", 0.1]], busy_s=0.0),
                                   _trace([["x", 0.1]], window_s=0.3, busy_s=0.3)])
def test_idle_unattributed_silent_without_its_input(trace):
    assert _read("idle_unattributed_pct.css", _record([_scan()], trace=trace)) is None


def test_css_plan_ms_is_the_mean_span_a_scan():
    run = _record([_scan(plan_s=0.002), _scan(plan_s=0.004)])
    assert _read("css_plan_ms", run) == pytest.approx(3.0)


def test_css_upload_rate_is_bytes_over_span_seconds():
    run = _record([_scan(upload_s=0.004, h2d=8_000_000), _scan(upload_s=0.006, h2d=12_000_000)])
    assert _read("css_upload_gb_per_s", run) == pytest.approx(2.0)


def test_mc_ranges_per_scan_is_the_mean_count():
    run = _record([_scan(ranges=10), _scan(ranges=12), _scan(ranges=11)])
    assert _read("mc_ranges_per_scan", run) == pytest.approx(11.0)


def test_mc_perms_run_ratio_against_the_checked_work():
    run = _record([_scan(run=3_000_000), _scan(run=1_000_000)], perms=1_000_000)
    assert _read("mc_perms_run_ratio", run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", PROGRAM_READERS + ["idle_unattributed_pct.css"])
def test_readers_silent_outside_a_css_run(name):
    gaps = [["gpubench.scan", 0.02]]
    assert _read(name, _record([_scan()], kind="fet", trace=_trace(gaps))) is None


@pytest.mark.parametrize("name", PROGRAM_READERS)
def test_readers_silent_where_the_program_has_no_counter_or_span(name):
    """A program without the spans and counters (the parent of the change
    that brought them) gives no reading, and no error."""
    bare = Scan(outputs={}, wall_s=0.1, timings_s={"css_mc": 0.08}, counters={})
    assert _read(name, _record([bare])) is None
    assert _read(name, _record([])) is None


def test_traced_css_run_reports_the_program_readers(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        root = tiny_root(tmp_path)
        r = harness.run_cell(root, "ceu-gbr.css_null", 2**31 + 5, 0.0, True,
                             torch.device("cpu"), time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    for name in PROGRAM_READERS:
        assert r["metrics"][name]["value"] > 0, name
    # windows that stop early: the product runs past their stops
    assert r["metrics"]["mc_perms_run_ratio"]["value"] >= 1.0
