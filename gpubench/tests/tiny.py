"""A copy of the benchmark's data files at sizes a CPU test holds: the
same configurations, mixes, metrics and checks, with shorter chromosomes,
fewer of them and a lower MC cap; plus the FET genome cell, whose mix,
readers and check file are in ``gpubench/`` and whose entries are not in
``BENCHMARK.json`` yet (its host-paced spread is too wide for a bound)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SIZES = {"css_hot_8mb": (150_000, 3), "css_null_10mb": (100_000, 2),
         "fet_genome_8m": (100_000, 3), "css_hot_500kb": (30_000, 2)}
MC_RUNS = 2_000
FET_CELL = {"name": "stickleback.fet_genome", "config": "stickleback-11x10",
            "traffic": "fet_genome_8m", "chips": 1, "why": "the FET main path"}
FET_METRIC = {"name": "fet_snp_tests_per_s", "unit": "tests/s", "better": "higher",
              "bound": 0.25, "source": "host_clock", "workloads": ["stickleback.fet_genome"]}


def tiny_root(tmp: Path) -> Path:
    """A root with ``BENCHMARK.json`` and ``gpubench``'s data files,
    shrunk; the code stays the repository's."""
    root = tmp / "root"
    (root / "gpubench").mkdir(parents=True)
    for sub in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(REPO / "gpubench" / sub, root / "gpubench" / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(FET_CELL)
    bench["end_to_end"].append(FET_METRIC)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in (root / "gpubench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["mc_runs"] = MC_RUNS
        p.write_text(json.dumps(cfg))
    for name, (bp, n) in SIZES.items():
        p = root / "gpubench" / "traffic" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix["bp"], mix["chromosomes"] = bp, n
        mix["per_scan"] = min(mix["per_scan"], n)
        if 0 < mix["divergent_bp_share"] < 1:
            mix["divergent_bp_share"] = 0.1
        p.write_text(json.dumps(mix))
    return root
