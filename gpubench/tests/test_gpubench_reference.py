"""The reference against the port's plain CPU path, through a whole run of
each cell at a small size, and the reference's own answers against its
judge."""

import time

import numpy as np
import pytest
import torch

from gpubench import check, harness, traffic
from gpubench.reference import mc as rmc
from gpubench.tests.tiny import tiny_root

WORKLOADS = ["stickleback.css_hot", "ceu-gbr.css_null", "stickleback.fet_genome",
             "yri-ceu.css_hot"]


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_on_cpu_matches_reference(tmp_path, few_threads, workload):
    root = tiny_root(tmp_path)
    r = harness.run_cell(root, workload, 2**31 + 77, 0.0, workload == "stickleback.css_hot",
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    for name, v in r["checks"].items():
        assert v["value"] <= v["limit"], name
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = harness.cell(root, harness.load_bench(root), workload)
    want = {m["name"] for m in spec["per_layer" if workload == "stickleback.css_hot"
                                     else "end_to_end"]}
    # the CPU run has no device trace: those readers stay silent
    assert set(r["metrics"]) <= want
    assert "setup_s" in r["metrics"] or workload == "stickleback.css_hot"


@pytest.mark.parametrize("workload", ["stickleback.css_hot", "stickleback.fet_genome"])
def test_reference_answers_pass_their_own_judge(tmp_path, few_threads, workload):
    root = tiny_root(tmp_path)
    spec = harness.cell(root, harness.load_bench(root), workload)
    config, mix, rules = spec["config"], spec["traffic"], spec["rules"]
    chroms = traffic.chromosomes(config, mix, 41, "cpu")
    out = check.control_outputs(mix["scan"], config, rules, chroms, 41, "cpu", prec="f64")
    nums = check.numbers(mix["scan"], config, rules, chroms, out, 41, "cpu")
    nums["repeat_mismatch"] = 0
    ok, shown = check.verdict(nums, rules["limits"])
    assert ok, shown
    gaps = [v for k, v in nums.items() if k.endswith("_gap") or k == "mc_band"]
    assert max(gaps) < 1e-9


def test_decode_inverts_the_estimator():
    runs, thr = 2_000, 10
    hits = np.array([10, 10, 3, 0, 10])
    n = np.array([11, 1_999, runs, runs, runs])
    h, m = rmc.decode((hits + 1.0) / (n + 1.0), runs, thr)
    assert np.array_equal(h, hits) and np.array_equal(m, n)
    h, m = rmc.decode(np.array([0.3, 0.0]), runs, thr)
    assert (h == -1).all() and (m == -1).all()


def test_bands_flag_impossible_answers():
    torch.manual_seed(0)
    a, b, runs = 4, 3, 512
    x = torch.rand(5, a + b, 2, dtype=torch.float64)
    dist = torch.cdist(x, x)
    obs = torch.full((5,), -10.0, dtype=torch.float64)      # every permutation hits
    scale = torch.ones(5, dtype=torch.float64)
    t = rmc.bands(dist, obs, scale, np.array([10, 10, 0, 5, 10]), np.array([10, 20, runs, 100, 0]),
                  3, a, b, 256, runs, 10)
    assert t[0] == 0.0                 # stops at its 10th permutation: all hits
    assert np.isinf(t[3]) and np.isinf(t[4])
    assert t[1] > 1.0 and t[2] > 1.0   # hits missing that the scores make certain


@pytest.mark.parametrize("workload", ["stickleback.css_hot", "ceu-gbr.css_null"])
def test_work_from_the_answers_equals_the_engine_counters(tmp_path, few_threads, workload):
    """The windows scored and permutations counted from a scan's checked
    answers are what a sound engine's own counters say."""
    from gpubench import scans

    root = tiny_root(tmp_path)
    spec = harness.cell(root, harness.load_bench(root), workload)
    config, mix = spec["config"], spec["traffic"]
    chroms = traffic.chromosomes(config, mix, 2**32 + 9, "cpu")
    program = scans.Program(config, mix, 2**32 + 9, torch.device("cpu"))
    for c in chroms:
        s = program.scan([c], time.perf_counter)
        w = scans.group_work(config, "css", [c], s.outputs)
        assert w["scored"] == s.counters["windows_scored"] > 0
        assert w["permutations"] == s.counters["mc_permutations"] > 0
        assert w["windows"] == s.counters["windows_scored"] + s.counters["windows_discarded"]
