"""The port's cache of K1's LUT and K1r's sort of it
(``divergence_tpu_torch/kernels/fet.py``: ``lut_cached``,
``lut_rank_cached``, ``clear_lut_cache``) on the CPU, where the wrappers
read it too.

One entry per (asize, bsize, maxs, nmax, dtype, device): each key part
gives its own entry, and a key met again returns the same storage without
a second build.  The cached path changes no result: ``run_fet`` over
several chromosomes with the cache warm equals, bit for bit, each
chromosome run with the cache cleared, in both precisions (exact mode on
the rank path); the cached sort equals ``fet_lut_rank_plain`` of a fresh
plain LUT; and the warm runs stay within the FET tolerances of the JAX
package's ``run_fet`` (exact 1e-12, fast 1e-5, relative to
max(|reference|, 1))."""

import sys
import threading

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu_torch import FetConfig
from divergence_tpu_torch.engine import SnpPair, run_fet, run_fet_multi
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.tools.synth import make_panel
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

TOL = {"exact": 1e-12, "fast": 1e-5}
CPU = torch.device("cpu")
DT = {"exact": torch.float64, "fast": torch.float32}
PANEL = (5, 4)
REGION = 20_000


@pytest.fixture(autouse=True)
def empty_cache():
    tfet.clear_lut_cache()
    yield
    tfet.clear_lut_cache()


@pytest.fixture
def builds(monkeypatch):
    """Counts the cache's LUT builds and sorts (its calls of ``fet_lut``
    and ``fet_lut_rank``)."""
    calls = {"lut": 0, "rank": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfet, "fet_lut", count("lut", tfet.fet_lut))
    monkeypatch.setattr(tfet, "fet_lut_rank", count("rank", tfet.fet_lut_rank))
    return calls


def _key(asize=5, bsize=4, dtype=torch.float64, device=CPU):
    return (asize, bsize, tfet.support_size(asize, bsize), asize + bsize + 2, dtype, device)


def _chromosomes(n, seed0):
    out = {}
    for i in range(n):
        pos, am, bm = make_panel(400, REGION, *PANEL, seed=seed0 + i)
        out[f"chr{i}"] = (pos, am, bm)
    return out


def _bits(a):
    return np.asarray(a).view(np.uint64)


def test_same_key_same_storage_one_build(builds):
    first = tfet.lut_cached(*_key())
    again = tfet.lut_cached(*_key())
    assert builds == {"lut": 1, "rank": 0}
    assert again.data_ptr() == first.data_ptr()
    sorted_1, rank_1 = tfet.lut_rank_cached(*_key())
    sorted_2, rank_2 = tfet.lut_rank_cached(*_key())
    assert builds == {"lut": 1, "rank": 1}
    assert sorted_2.data_ptr() == sorted_1.data_ptr()
    assert rank_2.data_ptr() == rank_1.data_ptr()
    tfet.clear_lut_cache()
    tfet.lut_cached(*_key())
    assert builds == {"lut": 2, "rank": 1}


@pytest.mark.parametrize("part,value", [(0, 6), (1, 3), (2, 9), (3, 13),
                                        (4, torch.float32), (5, torch.device("meta"))])
def test_each_key_part_gives_its_own_entry(monkeypatch, part, value):
    """Each of the six key parts, changed alone, builds a second entry.
    The build is a stub here (a tensor of the key's size), so that a key
    of a device this machine lacks can be asked for."""
    made = []

    def stub(asize, bsize, maxs, nmax, dtype, device):
        made.append((asize, bsize, maxs, nmax, dtype, device))
        return torch.zeros((asize + 1) ** 2 * (bsize + 1) ** 2, dtype=dtype)

    monkeypatch.setattr(tfet, "fet_lut", stub)
    monkeypatch.setattr(tfet, "_stamp", lambda device: (None, None))
    base = list(_key())
    other = list(base)
    other[part] = value
    a = tfet.lut_cached(*base)
    b = tfet.lut_cached(*other)
    assert made == [tuple(base), tuple(other)]
    assert a.data_ptr() != b.data_ptr()
    assert tfet.lut_cached(*base).data_ptr() == a.data_ptr()
    assert tfet.lut_cached(*other).data_ptr() == b.data_ptr()
    assert len(made) == 2


def test_cuda_device_without_index_shares_the_indexed_key(monkeypatch):
    """``cuda`` and ``cuda:<current>`` name one device: one key."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tfet._key_device("cuda") == torch.device("cuda", 0)
    assert tfet._key_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert tfet._key_device("cpu") == CPU


def test_least_recently_used_entry_dropped(monkeypatch, builds):
    monkeypatch.setattr(tfet, "_LUT_CACHE_ENTRIES", 2)
    first = tfet.lut_cached(*_key(asize=3))
    tfet.lut_cached(*_key(asize=4))
    tfet.lut_cached(*_key(asize=3))          # now the most recent
    tfet.lut_cached(*_key(asize=5))          # drops asize=4
    assert builds["lut"] == 3
    assert tfet.lut_cached(*_key(asize=3)).data_ptr() == first.data_ptr()
    tfet.lut_cached(*_key(asize=4))
    assert builds["lut"] == 4


def test_threads_build_a_key_once(builds):
    """Many threads asking for one key at once, with the interpreter
    switching threads as often as it can: one build, one storage."""
    got = []

    def use():
        got.append(tfet.lut_cached(*_key()).data_ptr())
        got.append(tfet.lut_rank_cached(*_key())[0].data_ptr())

    threads = [threading.Thread(target=use) for _ in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == {"lut": 1, "rank": 1} and len(got) == 64 and len(set(got)) == 2


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_cached_sort_equals_the_plain_sort_of_a_fresh_lut(prec):
    dt = DT[prec]
    key = _key(11, 10, dt)
    lut_sorted, rank_of_entry = tfet.lut_rank_cached(*key)
    p_sorted, p_rank = tfet.fet_lut_rank_plain(tfet.fet_lut_plain(*key))
    assert torch.equal(rank_of_entry, p_rank)
    assert torch.equal(lut_sorted.view(torch.int64 if prec == "exact" else torch.int32),
                       p_sorted.view(torch.int64 if prec == "exact" else torch.int32))
    assert torch.equal(tfet.lut_cached(*key), tfet.fet_lut_plain(*key))


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_wrappers_on_the_cpu_equal_their_plain_versions(prec, builds):
    """``fet_snp_logs`` and ``fet_snp_ranks`` read the cache on the CPU
    and give their plain versions' bits; the plain versions build their
    own LUT and leave the cache alone."""
    pos, am, bm = make_panel(2_000, REGION, 11, 10, seed=3)
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1))
    maxs, nmax, fast = tfet.support_size(11, 10), 23, prec == "fast"
    for _ in range(2):
        assert torch.equal(tfet.fet_snp_logs(vals, 11, maxs, nmax, fast),
                           tfet.fet_snp_logs_plain(vals, 11, maxs, nmax, fast))
        ls, r = tfet.fet_snp_ranks(vals, 11, maxs, nmax, fast)
        pls, pr = tfet.fet_snp_ranks_plain(vals, 11, maxs, nmax, fast)
        assert torch.equal(r, pr) and torch.equal(ls, pls)
    assert builds == {"lut": 1, "rank": 1}


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_over_chromosomes_equals_cold_runs(prec, builds):
    """Three chromosomes with the cache warm after the first (one build,
    and on exact mode's rank path one sort) against each chromosome run
    with the cache cleared: the same bits; ``run_fet_multi`` too; and, on
    the first, the JAX package's ``run_fet`` within the FET tolerances."""
    chroms = _chromosomes(3, 60)
    cfg = FetConfig(precision=prec, seed=5)
    cold = {}
    for name, (pos, am, bm) in chroms.items():
        tfet.clear_lut_cache()
        cold[name] = run_fet(SnpPair(pos, am, bm), REGION, cfg, device=CPU, seqid=name)
    assert builds == {"lut": 3, "rank": 3 if prec == "exact" else 0}
    tfet.clear_lut_cache()
    warm = {name: run_fet(SnpPair(pos, am, bm), REGION, cfg, device=CPU, seqid=name)
            for name, (pos, am, bm) in chroms.items()}
    assert builds == {"lut": 4, "rank": 4 if prec == "exact" else 0}
    multi = run_fet_multi({name: (SnpPair(*c), REGION) for name, c in chroms.items()}, cfg,
                          device=CPU)
    assert builds == {"lut": 4, "rank": 4 if prec == "exact" else 0}
    for name, (pos, am, bm) in chroms.items():
        for i in range(2):
            assert np.array_equal(_bits(warm[name][i]), _bits(cold[name][i]))
            assert np.array_equal(_bits(multi[name][i]), _bits(cold[name][i]))
    pos, am, bm = chroms["chr0"]
    want = jax_run_fet(JSnpPair(pos, am, bm), REGION, JFetConfig(precision=prec, seed=5),
                       seqid="chr0")
    for got, ref in zip(warm["chr0"], want):
        ref = np.asarray(ref, dtype=np.float64)
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= TOL[prec], err.max()


def test_fet_lut_and_its_sort_stay_uncached(builds):
    """``fet_lut`` and ``fet_lut_rank`` compute anew on every call and
    leave the cache as it was."""
    key = _key()
    a, b = tfet.fet_lut(*key), tfet.fet_lut(*key)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    tfet.fet_lut_rank(a)
    assert builds == {"lut": 2, "rank": 1}
    assert len(tfet._lut_cache) == 0
