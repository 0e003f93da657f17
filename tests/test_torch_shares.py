"""The sharded MC of the port (kernels/perm.py: ``significance`` and
``approx_significance`` with ``sharding=``, ``_over_shares``) on CPU
meshes.

``significance`` runs every share at once, in a host thread of its own
(on CUDA also a stream of its own; tests/test_torch_kernels_gpu.py holds
that on the card); ``approx_significance`` asks every share for its power
sums of a round before it brings any back, and fits once.  A window's
result depends on its own permutation stream and stop only, so the
sharded call equals the unsharded one byte for byte on every route and
mesh, uneven shares included; both are held against the JAX
package's ``significance`` / ``approx_significance`` with the tolerances
of tests/test_torch_mc.py, tests/test_torch_mc_window.py and
tests/test_torch_approx.py.  Also here: a share that raises, the launch
counter under threads, the kernel library's first use from several
threads, and the TF32 setting the shares' plain products share."""

import concurrent.futures
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu import native
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import _build, _cuda
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.parallel import make_mesh, window_slices
from divergence_tpu_torch.tools.synth import make_panel
import test_torch_mc
import test_torch_mc_window
from test_torch_approx import _windows, assert_approx_in_band
from test_torch_mc_window import _keys
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
# (asize, bsize, maker, seed): two of tests/test_torch_approx.py's cases;
# in the first some approx windows escalate, in both the MC stops some
# windows early and takes others to RUNS
PANELS = [(11, 10, make_panel, 13), (5, 4, make_panel, 7)]
MESHES = [1, 3, 4]       # shares of the CPU; 3 does not divide the windows
CHUNK, RUNS, THRESHOLD = 64, 512, 10
APPROX_CHUNK = 512       # tests/test_torch_approx.py's chunk
# route -> (approx mode, significance's backend, stream)
ROUTES = {
    "shared": (False, "xla", "shared"),
    "window": (False, "xla", "window"),
    "native": (False, "native", "window"),
    "approx_shared": (True, None, "shared"),
    "approx_window": (True, None, "window"),
}
FIELDS = ("pvals", "nscores", "hits")
# name prefix of the threads of _over_shares
SHARE_THREADS = "mc-share"


def _port(route, data, asize, bsize, key, sharding=None):
    dist, scores, chroms, slots = data
    approx, backend, stream = ROUTES[route]
    if approx:
        return tperm.approx_significance(dist, scores, asize, bsize, key, chunk=APPROX_CHUNK,
                                         chroms=chroms, slots=slots, stream=stream,
                                         sharding=sharding)
    return tperm.significance(dist, scores, asize, bsize, THRESHOLD, RUNS, key, chunk=CHUNK,
                              chroms=chroms, slots=slots, backend=backend, stream=stream,
                              sharding=sharding)


def _jax(route, data, asize, bsize, key):
    dist, scores, chroms, slots = data
    approx, backend, stream = ROUTES[route]
    if approx:
        return jperm.approx_significance(np.asarray(dist), scores, asize, bsize, key,
                                         chunk=APPROX_CHUNK, chroms=chroms, slots=slots,
                                         stream=stream)
    return jperm.significance(np.asarray(dist), scores, asize, bsize, THRESHOLD, RUNS, key,
                              chunk=CHUNK, chroms=chroms, slots=slots, backend=backend,
                              stream=stream)


def _assert_bytes_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


@pytest.fixture(scope="module")
def cases():
    """(panel, route) -> (windows, the unsharded port run, the JAX run or
    None), made once for the module."""
    made = {}

    def get(panel, route):
        if (panel, route) not in made:
            asize, bsize, maker, seed = panel
            data = _windows(asize, bsize, maker, seed)
            jkey, tkey = _keys(7)
            want = None
            if ROUTES[route][1] != "native" or native.native_available():
                want = _jax(route, data, asize, bsize, jkey)
            made[panel, route] = (data, _port(route, data, asize, bsize, tkey), want)
        return made[panel, route]

    return get


def _assert_matches_jax(route, data, asize, bsize, got, want):
    """The JAX package's run, to the tolerances of its own MC tests."""
    dist, scores, chroms, slots = data
    approx, backend, stream = ROUTES[route]
    _, tkey = _keys(7)
    if approx:
        assert_approx_in_band(got, want, asize + bsize)
        return
    if backend == "native":
        _assert_bytes_equal(got, want)
        return
    if stream == "shared":
        n_ties = test_torch_mc._explain_differences(dist, scores, got, want, tkey, asize,
                                                    bsize, CHUNK)
    else:
        wkeys = rng.window_keys(tkey, chroms, slots)
        n_ties = test_torch_mc_window._explain_differences(dist, scores, wkeys, got, want,
                                                           asize, bsize, CHUNK, "mix")
    same = (got.nscores == want.nscores) & (got.hits == want.hits)
    assert np.array_equal(got.pvals[same], want.pvals[same])
    assert n_ties <= 1


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("panel", PANELS, ids=lambda p: f"{p[0]}+{p[1]}")
def test_sharded_equals_unsharded_and_jax(cases, panel, route, n):
    data, one, want = cases(panel, route)
    asize, bsize = panel[:2]
    assert len(data[1]) > 3 * n        # every share holds windows
    if ROUTES[route][0]:
        assert (one.nscores >= 2 * APPROX_CHUNK).all()
        assert (one.nscores > 2 * APPROX_CHUNK).any() or panel != PANELS[0]
    else:
        assert (one.nscores < RUNS).any() and (one.nscores == RUNS).any()
    got = _port(route, data, asize, bsize, _keys(7)[1], make_mesh(devices=[CPU] * n))
    _assert_bytes_equal(got, one)
    if want is not None:
        _assert_matches_jax(route, data, asize, bsize, got, want)


@pytest.mark.parametrize("route", ["shared", "window"])
def test_shares_run_at_once(cases, monkeypatch, route):
    """Every share's single-device run waits at one barrier of the mesh's
    size: a serial loop over the shares would break it at its timeout."""
    panel = PANELS[1]
    data, one, _ = cases(panel, route)
    n = 4
    barrier = threading.Barrier(n, timeout=10)
    threads = set()
    single = tperm._significance

    def waiting(*args):
        threads.add(threading.get_ident())
        barrier.wait()
        return single(*args)

    monkeypatch.setattr(tperm, "_significance", waiting)
    got = _port(route, data, *panel[:2], _keys(7)[1], make_mesh(devices=[CPU] * n))
    _assert_bytes_equal(got, one)
    assert len(threads) == n and threading.get_ident() not in threads


@pytest.mark.parametrize("route", ["approx_shared", "approx_window"])
def test_approx_enqueues_every_share_before_reading_one(cases, monkeypatch, route):
    """Approx mode's power sums: in every round each share's sums are
    asked for (on CUDA: enqueued on the share's stream) before any is
    brought to the host, and the fit runs once over all windows."""
    panel = PANELS[0]
    data, one, _ = cases(panel, route)
    log = []
    single = tperm.null_power_sums

    class Pending:
        def __init__(self, t):
            self.t = t

        def cpu(self):
            log.append("read")
            return self.t

    def sums(*args):
        log.append("sums")
        return Pending(single(*args))

    fits = []
    tail = tperm._pearson3_tail

    def fit(*args):
        fits.append(len(args[0]))
        return tail(*args)

    monkeypatch.setattr(tperm, "null_power_sums", sums)
    monkeypatch.setattr(tperm, "_pearson3_tail", fit)
    got = _port(route, data, *panel[:2], _keys(7)[1], make_mesh(devices=[CPU] * 4))
    _assert_bytes_equal(got, one)
    rounds = "".join("s" if e == "sums" else "r" for e in log).replace("rs", "r|s").split("|")
    assert len(rounds) >= 2 and rounds[0] == "ssssrrrr"           # escalation ran
    assert all(r == "s" * (len(r) // 2) + "r" * (len(r) // 2) for r in rounds)
    assert fits[:2] == [len(data[1])] * 2 and len(fits) == 2 * len(rounds)


def test_a_failing_share_raises_after_every_share_ends(cases, monkeypatch):
    """The error of a share reaches the caller once the other shares have
    ended; no worker thread is left."""
    panel = PANELS[1]
    data, _, _ = cases(panel, "window")
    mesh = make_mesh(devices=[CPU] * 4)
    dist = data[0]
    failing = dist[window_slices(len(dist), mesh)[2]].data_ptr()
    ended = []
    single = tperm._significance

    def share(d, *rest):
        if d.data_ptr() == failing:
            raise RuntimeError("share 2 failed")
        time.sleep(0.2)
        out = single(d, *rest)
        ended.append(d.data_ptr())
        return out

    monkeypatch.setattr(tperm, "_significance", share)
    with pytest.raises(RuntimeError, match="share 2 failed"):
        _port("window", data, *panel[:2], _keys(7)[1], mesh)
    assert len(ended) == 3
    left = [t for t in threading.enumerate() if t.name.startswith(SHARE_THREADS)]
    assert not left, left


@pytest.mark.parametrize("counts,name", [
    (tperm.LAUNCHES, "css_mc_shared"), (tperm.COEFF_LAUNCHES, "mix"),
    (tperm.POWER_LAUNCHES, "window"), (tfet.LAUNCHES, "fet_aggregate"),
    (tcss.LAUNCHES, "css_cmds"),
])
def test_launch_counts_are_exact_under_threads(monkeypatch, counts, name):
    """8 threads x 10,000 counts, the interpreter switching threads as
    often as it can: not one lost."""
    monkeypatch.setitem(counts, name, 0)
    threads, per = 8, 10_000
    start = threading.Barrier(threads, timeout=10)

    def work():
        start.wait()
        for _ in range(per):
            _cuda.count(counts, name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            futures = [pool.submit(work) for _ in range(threads)]
        for f in futures:
            f.result()
    finally:
        sys.setswitchinterval(interval)
    assert counts[name] == threads * per


def test_kernel_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Six threads at the library's first use: one build, one load, one
    library (the build and the load stubbed: no nvcc here)."""
    monkeypatch.setattr(_build, "_built", None)
    monkeypatch.setattr(_build, "_lib", None)
    builds, loads = [], []

    def compile_stub():
        builds.append(threading.get_ident())
        time.sleep(0.1)       # the others arrive while it builds
        return _build.BuildInfo(Path("libstub.so"), 0.0, "")

    def load_stub(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_compile", compile_stub)
    monkeypatch.setattr(_build, "_load", load_stub)
    n = 6
    start = threading.Barrier(n, timeout=10)

    def first_use():
        start.wait()
        return _build.library()

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(first_use) for _ in range(n)]
    libs = [f.result() for f in futures]
    assert len(builds) == 1 and loads == [Path("libstub.so")]
    assert all(lib is libs[0] for lib in libs)
    assert _build.build().path == Path("libstub.so") and len(builds) == 1


def test_full_f32_matmul_is_shared_by_threads(monkeypatch):
    """The shares' plain products clear TF32 together: it stays off while
    any share is inside, and the caller's setting is back once the last
    leaves, whichever entered first."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    n = 4
    inside = threading.Barrier(n, timeout=10)
    first_in, first_out = threading.Event(), threading.Event()
    seen = []

    def share(i):
        if i:
            first_in.wait(10)
        with tperm._full_f32_matmul():
            first_in.set()
            inside.wait()
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            if i:
                first_out.wait(10)
        if not i:
            first_out.set()

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(share, i) for i in range(n)]
    for f in futures:
        f.result()
    assert seen == [False] * n
    assert torch.backends.cuda.matmul.allow_tf32 is True
