"""Structured run summaries and per-stage timing.

``RunSummary`` is copied verbatim from ``divergence_tpu/utils/summary.py``:
importing the JAX package imports jax, and the port runs where jax is not
installed.  ``tests/test_torch_host_copies.py`` holds the two equal.  The
JAX package's ``StageTimer`` has no copy: the port times its stages with
``RunSummary.stage``, through ``utils/trace.py:span``.

The reference's observability is printf + gettimeofday pairs
(reference statistics/css/comparative.c:107-114, reference statistics/css/threadcss.c:55-107).  Here every run can emit a
JSON summary: window counts, discards, per-stage wall-clock, throughput.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any


@dataclasses.dataclass
class RunSummary:
    name: str = "run"
    counters: dict[str, Any] = dataclasses.field(default_factory=dict)
    timings_s: dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings_s[label] = (
                self.timings_s.get(label, 0.0) + time.perf_counter() - t0
            )

    def to_json(self) -> str:
        # peak RSS at serialization time: memory observability for
        # production runs (host-side bounding is a design claim —
        # BASELINE.md — so every summary records the evidence)
        try:
            import resource

            self.counters["peak_rss_mb"] = round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
                1,
            )
        except ImportError:  # non-POSIX
            pass
        return json.dumps(
            {
                "name": self.name,
                "counters": self.counters,
                "timings_s": {k: round(v, 6) for k, v in self.timings_s.items()},
            }
        )

    def write(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")
