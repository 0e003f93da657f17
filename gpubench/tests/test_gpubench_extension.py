"""A later change adds a cell, a mix and a metric as new files and new
entries of BENCHMARK.json only; the harness finds them by name."""

import json
import time

import torch

from gpubench import harness
from gpubench.tests.tiny import tiny_root

READER = '''
"""windows_a_scan (host clock): windows scored per scan."""


def read(run):
    return sum(w["scored"] for w in run.work) / len(run.scans)
'''


def test_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpubench").rglob("*") if p.is_file()}
    g = root / "gpubench"
    cfg = json.loads((g / "configs" / "stickleback-11x10.json").read_text())
    cfg["asize"], cfg["bsize"] = 6, 5
    (g / "configs" / "small-6x5.json").write_text(json.dumps(cfg))
    (g / "traffic" / "css_sparse.json").write_text(json.dumps(
        {"scan": "css", "chromosomes": 2, "per_scan": 2, "bp": 60_000,
         "divergent_bp_share": 0.2, "island_bp": 5_000}))
    (g / "metrics" / "windows_a_scan.py").write_text(READER)
    (g / "checks" / "small.css_sparse.json").write_text(
        (g / "checks" / "stickleback.css_hot.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small-6x5", "source": "https://example.org/small",
                             "file": "gpubench/configs/small-6x5.json", "reduced": [],
                             "why": "a test panel"})
    bench["workloads"].append({"name": "small.css_sparse", "config": "small-6x5",
                               "traffic": "css_sparse", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "windows_a_scan", "unit": "windows", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["small.css_sparse"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in (root / "gpubench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())      # nothing edited

    r = harness.run_cell(root, "small.css_sparse", 8, 0.0, False, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["windows_a_scan"]["value"] > 0
    assert r["metrics"]["windows_a_scan"]["unit"] == "windows"
    # css_windows_per_s lists its cells, so the new cell does not report it
    assert {"setup_s", "windows_a_scan"} == set(r["metrics"])
