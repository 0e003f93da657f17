"""One run of one cell: set-up, the measured window, the traced span, the
check, the metrics.  Everything that belongs to a configuration, a mix, a
metric or a cell's check is a file found by its name in ``BENCHMARK.json``:

* ``BENCHMARK.json``'s configuration entry names its file (panel, tool
  settings, SNP density);
* ``gpubench/traffic/<traffic>.json`` — the mix (:mod:`gpubench.traffic`);
* ``gpubench/metrics/<metric>.py`` — a reader, ``read(run) -> float | None``,
  for every end-to-end and per-layer metric;
* ``gpubench/checks/<workload>.json`` — the check's rules and limits.

A scan is one entry call over one group of the mix's chromosomes (``per_scan``
of them, in order); the window runs the groups round-robin, back to back,
one caller, until ``--seconds`` have passed, and ends when its last scan
returns.  Set-up generates the chromosomes and scans every group once,
which builds and warms every kernel and shape the window uses.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from gpubench import check, scans, traffic
from gpubench.trace import Trace, traced_span

FORBIDDEN = ("jax", "jaxlib", "flax", "divergence_tpu")
TRACE_SCANS = 4


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads."""
    workload: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    scans: list            # gpubench.scans.Scan of the window
    work: list             # per scan: gpubench.scans.group_work of its group
    group_work: list       # per group: gpubench.scans.group_work
    launches: dict         # wrapper launches over the window
    trace: Trace | None


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: Path, bench: dict, workload: str) -> dict:
    """The workload's entry, its configuration and mix (as files hold
    them), its metrics by kind, and its check's rules."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]

    return {
        "workload": wl,
        "config": json.loads((root / cfg_entry["file"]).read_text()),
        "traffic": json.loads(
            (root / "gpubench" / "traffic" / f"{wl['traffic']}.json").read_text()),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
        "rules": check.load_rules(root, workload),
    }


def reader(root: Path, name: str):
    path = root / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Ends the run, naming them, where such modules are loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"gpubench: modules of JAX or the JAX package loaded: {found}")


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, clock=time.perf_counter) -> dict:
    """One run; returns the result line's object (``correct`` False where
    the check fails; raises where the run cannot finish)."""
    import torch

    spec = cell(root, load_bench(root), workload)
    config, mix = spec["config"], spec["traffic"]
    on_card = torch.device(device).type == "cuda"

    t_data = clock()
    chroms = traffic.chromosomes(config, mix, seed, device)
    per = int(mix["per_scan"])
    groups = [chroms[i:i + per] for i in range(0, len(chroms), per)]
    t_program = clock()
    program = scans.Program(config, mix, seed, device)
    t_warm = clock()
    first = [program.scan(g, clock) for g in groups]       # builds and warms up
    if on_card:
        torch.cuda.synchronize()
    work = [scans.group_work(config, mix["scan"], g, s.outputs) for g, s in zip(groups, first)]
    setup_s = clock() - t_start
    say(f"[gpubench] {workload} seed {seed}: set-up {setup_s:.3f} s (imports "
        f"{t_data - t_start:.3f}, data {t_program - t_data:.3f}, program import "
        f"{t_warm - t_program:.3f}, warm-up scans {[round(s.wall_s, 3) for s in first]}), "
        f"{len(groups)} groups")

    before = program.launches()
    window = []
    t0 = clock()
    while True:
        window.append(program.scan(groups[len(window) % len(groups)], clock))
        if clock() - t0 >= seconds:
            break
    window_s = clock() - t0
    after = program.launches()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    say(f"[gpubench] window {window_s:.3f} s, {len(window)} scans")

    tr = None
    if trace:
        tr = traced_span(program, groups, len(window) % len(groups),
                         min(TRACE_SCANS, max(1, len(groups))), clock)
        say(f"[gpubench] traced {len(tr.scans)} scans: window {tr.window_s:.4f} s, busy "
            f"{tr.busy_s:.4f} s, complete {tr.complete} {tr.note}")
    refuse_forbidden()

    repeats = sum(not scans.same_outputs(s.outputs, first[i % len(groups)].outputs)
                  for i, s in enumerate(window))
    outputs = {k: v for s in first for k, v in s.outputs.items()}
    record = RunRecord(workload, config, mix, setup_s, window_s, window,
                       [work[i % len(groups)] for i in range(len(window))], work,
                       {k: after[k] - before[k] for k in after}, tr)
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = clock()
    nums = check.numbers(mix["scan"], config, spec["rules"], chroms, outputs, seed, device)
    nums["repeat_mismatch"] = repeats
    correct, shown = check.verdict(nums, spec["rules"]["limits"])
    say(f"[gpubench] check {clock() - t_check:.2f} s: " + json.dumps(
        {k: v for k, v in nums.items() if k not in spec["rules"]["limits"]}))

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": len(window),
              "failed": 0 if correct else len(window), "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = shown
    # the check and every reader have run: nothing they loaded is JAX's
    refuse_forbidden()
    for name, v in shown.items():
        say(f"[gpubench] check {name}: {v['value']} (limit {v['limit']})")
    return result
