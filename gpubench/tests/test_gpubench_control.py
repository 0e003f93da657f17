"""The check's control and faults at a test size: the reference in
bfloat16 in the program's place, and a run with the timed path broken
underneath (the chip's look skipped: the CPU path), each come out not
correct."""

import time

import numpy as np
import pytest
import torch

from gpubench import check, harness, traffic
from gpubench.tests.tiny import tiny_root


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["stickleback.css_hot", "yri-ceu.css_hot",
                                      "stickleback.fet_genome"])
def test_control_in_bfloat16_is_not_correct(tmp_path, few_threads, workload):
    root = tiny_root(tmp_path)
    spec = harness.cell(root, harness.load_bench(root), workload)
    config, mix, rules = spec["config"], spec["traffic"], spec["rules"]
    chroms = traffic.chromosomes(config, mix, 2**31 + 3, "cpu")
    out = check.control_outputs(mix["scan"], config, rules, chroms, 2**31 + 3, "cpu")
    nums = check.numbers(mix["scan"], config, rules, chroms, out, 2**31 + 3, "cpu")
    nums["repeat_mismatch"] = 0
    ok, shown = check.verdict(nums, rules["limits"])
    assert not ok, shown
    gap = "css_score_gap" if mix["scan"] == "css" else "fet_score_gap"
    assert nums[gap] > 10 * rules["limits"][gap]


def _run(root, workload):
    return harness.run_cell(root, workload, 2**31 + 5, 0.0, False, torch.device("cpu"),
                            time.perf_counter())


def _half_windows(fn, col):
    """``fn``'s outputs with the second half of the windows' column ``col``
    dropped to zero (half the batch left out)."""
    def broken(*args, **kw):
        out = list(fn(*args, **kw))
        n = out[col].shape[-1]
        out[col] = out[col].clone()
        out[col][..., n // 2:] = 0
        return tuple(out)
    return broken


def test_css_half_the_windows_left_out(tmp_path, few_threads, monkeypatch):
    from divergence_tpu_torch.kernels import css as kcss

    monkeypatch.setattr(kcss, "css_cmds", _half_windows(kcss.css_cmds, 0))
    assert not _run(tiny_root(tmp_path), "stickleback.css_hot")["correct"]


def test_css_one_score_altered(tmp_path, few_threads, monkeypatch):
    from divergence_tpu_torch.kernels import css as kcss

    real = kcss.css_cmds

    def altered(*args, **kw):
        scores, dist, valid = real(*args, **kw)
        scores = scores.clone()
        scores[len(scores) // 3] *= 1.001
        return scores, dist, valid
    monkeypatch.setattr(kcss, "css_cmds", altered)
    r = _run(tiny_root(tmp_path), "stickleback.css_hot")
    assert not r["correct"] and r["checks"]["css_score_gap"]["value"] > 1e-4


def test_mc_state_returned_unchanged(tmp_path, few_threads, monkeypatch):
    """The MC's loop leaves its (hits, n) as it found them: p = 1, which
    reads as a stop at the 10th of 10 permutations."""
    from divergence_tpu_torch.kernels import perm as kperm

    def unchanged(dist, scores, *args, **kw):
        z = np.zeros(dist.shape[0], dtype=np.int64)
        return kperm.McResult(pvals=np.ones(dist.shape[0]), nscores=z, hits=z.copy())
    monkeypatch.setattr(kperm, "significance", unchanged)
    r = _run(tiny_root(tmp_path), "stickleback.css_hot")
    band = r["checks"]["mc_band"]["value"]
    assert not r["correct"] and float(band) > r["checks"]["mc_band"]["limit"]


def test_mc_one_p_value_altered(tmp_path, few_threads, monkeypatch):
    from divergence_tpu_torch.kernels import perm as kperm

    real = kperm.significance

    def altered(*args, **kw):
        res = real(*args, **kw)
        res.pvals[len(res.pvals) // 2] = 2.0 / (res.nscores[len(res.pvals) // 2] + 1.0)
        return res
    monkeypatch.setattr(kperm, "significance", altered)
    assert not _run(tiny_root(tmp_path), "ceu-gbr.css_null")["correct"]


def test_fet_half_the_windows_left_out(tmp_path, few_threads, monkeypatch):
    from divergence_tpu_torch.kernels import fet as kfet

    real = kfet.fet_aggregate

    def broken(*args, **kw):
        out = real(*args, **kw).clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    monkeypatch.setattr(kfet, "fet_aggregate", broken)
    assert not _run(tiny_root(tmp_path), "stickleback.fet_genome")["correct"]


def test_fet_one_stddev_altered(tmp_path, few_threads, monkeypatch):
    from divergence_tpu_torch.kernels import fet as kfet

    real = kfet.fet_aggregate

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[1, :] *= 1.001
        return out
    monkeypatch.setattr(kfet, "fet_aggregate", altered)
    r = _run(tiny_root(tmp_path), "stickleback.fet_genome")
    assert not r["correct"] and r["checks"]["fet_stddev_gap"]["value"] > 1e-4


def test_a_scan_that_differs_from_its_first(tmp_path, few_threads, monkeypatch):
    """Every scan is compared: a later scan that differs fails the run."""
    from divergence_tpu_torch.kernels import fet as kfet

    real = kfet.fet_aggregate
    calls = {"n": 0}

    def drifting(*args, **kw):
        calls["n"] += 1
        out = real(*args, **kw)
        return out * 1.0001 if calls["n"] > 3 else out
    monkeypatch.setattr(kfet, "fet_aggregate", drifting)
    r = harness.run_cell(tiny_root(tmp_path), "stickleback.fet_genome", 9, 0.3, False,
                         torch.device("cpu"), time.perf_counter())
    assert not r["correct"] and r["checks"]["repeat_mismatch"]["value"] > 0
