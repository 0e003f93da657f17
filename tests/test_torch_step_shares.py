"""The sharded step's shares at once (divergence_tpu_torch/parallel/sharded.py)
on the CPU: a step over 3, 4 and 8 CPU shares byte-equal to one share on
host (numpy) and tensor inputs; one upload a share, whatever the mesh (a
spy on ``sharded._upload``), carrying the share's rows and the MC key's
words; the pinned buffer's layout read back exactly; the three wrappers
the step calls (``fet_window_batch``, ``css_window_batch``,
``css_dissim_gathered``) equal when handed their descriptors already on
the device; a failing share raising.  On CUDA the same step enqueues each
share on its own stream with no host sync: tests/test_torch_kernels_gpu.py
(``-k step_shares``) and chip_smoke.py phases 13 and 20.

Tolerances: per-window outputs and ``windows_evaluated`` bit-equal,
``score_sum`` within rtol 1e-9 (its partials are summed in share order);
the wrappers bit-equal."""

import numpy as np
import pytest
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.parallel import make_divergence_step, make_mesh, window_slices
from divergence_tpu_torch.parallel import sharded
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
OUTPUTS = sharded.OUTPUTS
B, P = 24, 32      # 24 windows divide over 1, 3, 4 and 8 shares


def _codes(B, P, asize, bsize, seed):
    """float64 genotype codes with the bench's frequencies and npos in
    [P/2, P] (tests/test_torch_parallel.py:_batch)."""
    rs = np.random.default_rng(seed)
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    av = rs.choice(codes, size=(B, P, asize), p=[0.45, 0.35, 0.15, 0.05])
    bv = rs.choice(codes, size=(B, P, bsize), p=[0.45, 0.35, 0.15, 0.05])
    return av, bv, rs.integers(P // 2, P + 1, size=(B,))


def _freqs(B, P, seed):
    rs = np.random.default_rng(seed)
    fa = rs.uniform(0, 1, size=(B, P, 1))
    fb = np.clip(fa + rs.normal(0, 0.2, size=(B, P, 1)), 0, 1)
    return fa, fb, rs.integers(P // 2, P + 1, size=(B,))


CASES = [
    ("cmds", (5, 4), {"nsamples": 4, "mc_chunk": 8}),
    ("smacof", (5, 4), {"nsamples": 4, "mc_chunk": 8, "mds": 1, "smacof_iters": 5,
                        "smacof_inits": 2}),
    ("drosophila", (1, 1), {"nsamples": 4, "mc_chunk": 8, "drosophila": True}),
]


def _inputs(name, panel, kind):
    """(av, bv, npos, slot) as numpy arrays, or as tensors (int16 codes)."""
    av, bv, npos = (_freqs(B, P, 11) if name == "drosophila" else _codes(B, P, *panel, 13))
    slot = np.arange(300, 300 + B)
    if kind == "numpy":
        return av, bv, npos, slot
    if name != "drosophila":
        av, bv = (tfet.codes_int16(torch.from_numpy(x)) for x in (av, bv))
    else:
        av, bv = torch.from_numpy(av), torch.from_numpy(bv)
    return av, bv, torch.from_numpy(npos), torch.from_numpy(slot)


def _step(n, panel, kw):
    return make_divergence_step(make_mesh(devices=[CPU] * n), *panel, **kw)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("name,panel,kw", CASES, ids=[c[0] for c in CASES])
def test_step_over_shares_is_one_share(name, panel, kw, n, kind):
    args = (*_inputs(name, panel, kind), rng.prng_key(3))
    one = _step(1, panel, kw)(*args)
    many = _step(n, panel, kw)(*args)
    for k in OUTPUTS:
        assert many[k].dtype == one[k].dtype and many[k].shape == (B,), k
        assert torch.equal(many[k], one[k]), k
    assert float(many["windows_evaluated"]) == float(one["windows_evaluated"]) == B
    s1, sn = float(one["score_sum"]), float(many["score_sum"])
    assert abs(s1 - sn) <= 1e-9 * abs(s1)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_one_upload_a_share(monkeypatch, n, kind):
    """The step calls its upload helper once a share, with the share's
    codes and one int64 row of (npos, slot, the MC key's two words)."""
    av, bv, npos, slot = _inputs("cmds", (5, 4), kind)
    key = rng.prng_key(8)
    calls = []
    real = sharded._upload

    def spy(dev, tensors):
        calls.append((dev, [t.clone() for t in tensors]))
        return real(dev, tensors)

    monkeypatch.setattr(sharded, "_upload", spy)
    out = _step(n, (5, 4), {"nsamples": 4, "mc_chunk": 8})(av, bv, npos, slot, key)
    assert len(calls) == n
    k_mc = rng.fold_in(rng.fold_in(key, 2), 0)
    for (dev, tensors), sl in zip(calls, window_slices(B, [CPU] * n)):
        assert dev == CPU and len(tensors) == 3
        a, b, rows = tensors
        assert torch.equal(a, torch.as_tensor(av[sl]))
        assert torch.equal(b, torch.as_tensor(bv[sl]))
        want = torch.cat([torch.as_tensor(npos[sl]), torch.as_tensor(slot[sl]), k_mc])
        assert rows.dtype == torch.int64 and torch.equal(rows, want)
    assert float(out["windows_evaluated"]) == B


def test_pack_reads_back_every_tensor():
    """One byte buffer holds tensors of any dtype and size, each at an
    aligned offset, and reads each back bit for bit."""
    ts = [torch.arange(7, dtype=torch.int64), torch.randn(3, 5, dtype=torch.float64),
          torch.tensor([True, False, True]), torch.zeros((0, 4), dtype=torch.int16),
          torch.tensor([[3, -3, 0]], dtype=torch.int16), torch.randn(9, dtype=torch.float32)]
    buf, layout = sharded._pack(ts, pin=False)
    assert buf.dtype == torch.uint8 and buf.numel() % sharded._ALIGN == 0
    assert all(off % sharded._ALIGN == 0 for off, *_ in layout)
    back = sharded._unpack(buf, layout)
    for t, u in zip(ts, back):
        assert u.dtype == t.dtype and u.shape == t.shape and torch.equal(u, t)


def test_upload_on_the_cpu_is_the_tensors_themselves():
    ts = [torch.arange(3), torch.ones(2, 2)]
    assert all(u is t for u, t in zip(sharded._upload(CPU, ts), ts))


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_fet_window_batch_with_descriptors_on_the_device(prec):
    av, bv, npos = _codes(16, 32, 5, 4, 21)
    av, bv, npos = torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos)
    slot = torch.arange(50, 66)
    maxs, nmax = tfet.support_size(5, 4), 11
    args = (av, bv, npos, 0.95, rng.prng_key(2), 20, maxs, nmax, prec == "fast", slot)
    want = tfet.fet_window_batch(*args)
    got = tfet.fet_window_batch(*args, npos_d=npos.clone(), slot_d=slot.clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("name,panel,kw", [
    ("cmds", (5, 4), {}),
    ("smacof", (5, 4), {"mds": 1, "smacof_iters": 5, "smacof_inits": 2}),
    ("drosophila", (1, 1), {"drosophila": True}),
], ids=["cmds", "smacof", "drosophila"])
def test_css_window_batch_with_descriptors_on_the_device(name, panel, kw, prec, plain):
    av, bv, npos = (_freqs(16, 32, 4) if name == "drosophila" else _codes(16, 32, *panel, 4))
    av, bv, npos = torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos)
    slot = torch.arange(80, 96)
    args = (av, bv, npos, rng.prng_key(6), *panel)
    opts = dict(kw, fast=prec == "fast", slot=slot, plain=plain)
    want = tcss.css_window_batch(*args, **opts)
    got = tcss.css_window_batch(*args, **opts, npos_d=npos.clone(), slot_d=slot.clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_css_dissim_gathered_with_descriptors_on_the_device(dtype):
    av, bv, npos = _codes(16, 32, 11, 10, 5)
    a16, b16 = (tfet.codes_int16(torch.from_numpy(x)) for x in (av, bv))
    npos = torch.from_numpy(npos)
    want = tcss.css_dissim_gathered(a16, b16, npos, dtype)
    got = tcss.css_dissim_gathered(a16, b16, npos, dtype, npos.clone())
    assert got.dtype == dtype and torch.equal(got, want)


def test_a_failing_share_raises(monkeypatch):
    """A share whose CSS call raises makes the step raise; the step then
    runs again as before."""
    av, bv, npos, slot = _inputs("cmds", (5, 4), "numpy")
    key = rng.prng_key(4)
    kw = {"nsamples": 4, "mc_chunk": 8}
    want = _step(4, (5, 4), kw)(av, bv, npos, slot, key)
    failing = int(slot[window_slices(B, [CPU] * 4)[2].start])
    real = tcss.css_window_batch

    def css(*args, slot=None, **kwargs):
        if int(slot[0]) == failing:
            raise RuntimeError("share 2 failed")
        return real(*args, slot=slot, **kwargs)

    monkeypatch.setattr(tcss, "css_window_batch", css)
    with pytest.raises(RuntimeError, match="share 2 failed"):
        _step(4, (5, 4), kw)(av, bv, npos, slot, key)
    monkeypatch.setattr(tcss, "css_window_batch", real)
    again = _step(4, (5, 4), kw)(av, bv, npos, slot, key)
    for k in OUTPUTS:
        assert torch.equal(again[k], want[k]), k
