"""The port's ``run-fet`` and ``run-css`` CLI (``--device cpu``) against
the JAX CLI on the same toy GTrack pair: identical rows (seqid, start),
values within tolerance relative to max(|ref|, 1), and ``--resume``
reproducing the fresh track byte for byte; ``run-css`` in its three MDS
modes, in drosophila mode on a frequency-track pair, and with every
phase-2 option (``--p-mode approx``, ``--mc-stream window``, ``--rng
threefry``, ``--perm-backend native``).

run-fet: 1e-12 (exact) / 1e-5 (fast).  run-css: scores 1e-9 (exact) /
the JAX package's fast-vs-exact band, rtol 2e-3 atol 1e-4 (fast); p equal
except on near-tie windows (tests/test_torch_mc.py), approx p within the
band of tests/test_torch_approx.py."""

import json

import numpy as np
import pytest
import torch

from divergence_tpu.io.gtrack import read_score_track as jax_read_score_track
from divergence_tpu.tools.cli import main as jax_cli
from divergence_tpu_torch.io import read_score_track
from divergence_tpu_torch.tools import synth
from divergence_tpu_torch.tools.cli import main as torch_cli
from test_torch_css_engine import assert_new_option_pvals_match
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

TOL = {"exact": 1e-12, "fast": 1e-5}


@pytest.fixture(scope="module")
def toy_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    sizes = {"chrA": 30_000, "chrB": 22_000}
    for i, (seqid, region) in enumerate(sizes.items()):
        pos, am, bm = synth.make_panel(400, region - 100, 6, 5, seed=70 + i)
        mode = "w" if i == 0 else "a"
        for name, mat in (("popA", am), ("popB", bm)):
            path = tmp / f"{name}_{seqid}.gtrack"
            synth.write_gtrack(path, seqid, pos, mat)
            with open(tmp / f"{name}.gtrack", mode) as out:
                out.write(path.read_text())
    (tmp / "chrom.sizes").write_text(
        "".join(f"{s}\t{n}\n" for s, n in sizes.items())
    )
    return tmp


def _args(tmp, out, prec, *extra):
    return [
        "run-fet", "--pop-a", str(tmp / "popA.gtrack"),
        "--pop-b", str(tmp / "popB.gtrack"), "--out", str(out),
        "--chrom-sizes", str(tmp / "chrom.sizes"), "--precision", prec,
        "--seed", "4", *extra,
    ]


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_cli_matches_jax_cli(toy_pair, prec):
    tmp = toy_pair
    jax_cli(_args(tmp, tmp / f"jax_{prec}.track", prec))
    torch_cli(
        _args(tmp, tmp / f"torch_{prec}.track", prec, "--device", "cpu",
              "--summary", str(tmp / f"torch_{prec}.json"))
    )
    js, jstart, jsc, jsd = jax_read_score_track(tmp / f"jax_{prec}.track")
    ts, tstart, tsc, tsd = read_score_track(tmp / f"torch_{prec}.track")
    assert ts == js and np.array_equal(tstart, jstart)
    assert len(ts) > 50 and set(ts) == {"chrA", "chrB"}
    for got, want in ((tsc, jsc), (tsd, jsd)):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= TOL[prec], err.max()
    summary = json.loads((tmp / f"torch_{prec}.json").read_text())
    assert summary["counters"]["device"] == "cpu"
    assert summary["counters"]["windows_evaluated"] > 0


def test_resume_reproduces_fresh_track(toy_pair):
    tmp = toy_pair
    fresh = tmp / "fresh.track"
    torch_cli(_args(tmp, fresh, "exact", "--device", "cpu"))
    resumed = tmp / "resumed.track"
    torch_cli(_args(tmp, resumed, "exact", "--device", "cpu", "--resume"))
    parts = tmp / "resumed.track.parts"
    assert sorted(p.name for p in parts.iterdir()) == ["chrA.tsv", "chrB.tsv"]
    assert resumed.read_bytes() == fresh.read_bytes()
    # a failed run that completed chrA only: chrB reruns, chrA is read back
    (parts / "chrB.tsv").unlink()
    resumed.unlink()
    torch_cli(_args(tmp, resumed, "exact", "--device", "cpu", "--resume"))
    assert resumed.read_bytes() == fresh.read_bytes()
    # single-chromosome remainder runs through run_fet, the genome-wide
    # path through run_fet_multi: the same bytes either way


def test_default_device_is_cuda(toy_pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        torch_cli(_args(toy_pair, tmp_path / "x.track", "fast"))


def _css_args(tmp, out, prec, *extra):
    return [
        "run-css", "--pop-a", str(tmp / "popA.gtrack"),
        "--pop-b", str(tmp / "popB.gtrack"), "--out", str(out),
        "--chrom-sizes", str(tmp / "chrom.sizes"), "--precision", prec,
        "--seed", "4", "--mc-runs", "2000", *extra,
    ]


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_cli_matches_jax_cli(toy_pair, prec):
    tmp = toy_pair
    jax_cli(_css_args(tmp, tmp / f"jax_css_{prec}.track", prec))
    torch_cli(
        _css_args(tmp, tmp / f"torch_css_{prec}.track", prec, "--device", "cpu",
                  "--summary", str(tmp / f"torch_css_{prec}.json"))
    )
    js, jstart, jsc, jp = jax_read_score_track(tmp / f"jax_css_{prec}.track")
    ts, tstart, tsc, tp = read_score_track(tmp / f"torch_css_{prec}.track")
    assert ts == js and np.array_equal(tstart, jstart)
    assert len(ts) > 50 and set(ts) == {"chrA", "chrB"}
    assert not np.isnan(tsc).any() and not np.isnan(tp).any()
    if prec == "exact":
        err = np.abs(tsc - jsc) / np.maximum(np.abs(jsc), 1.0)
        assert err.max() <= 1e-9, err.max()
    else:
        np.testing.assert_allclose(tsc, jsc, rtol=2e-3, atol=1e-4)
    assert (tp > 0).all() and (tp <= 1).all()
    assert (tp != jp).sum() <= 0.02 * len(tp)
    counters = json.loads((tmp / f"torch_css_{prec}.json").read_text())["counters"]
    assert counters["device"] == "cpu" and counters["windows_scored"] == len(ts)
    assert counters["mc_permutations"] > 0


def test_run_css_resume_reproduces_fresh_track(toy_pair):
    tmp = toy_pair
    fresh = tmp / "css_fresh.track"
    torch_cli(_css_args(tmp, fresh, "fast", "--device", "cpu"))
    resumed = tmp / "css_resumed.track"
    torch_cli(_css_args(tmp, resumed, "fast", "--device", "cpu", "--resume"))
    parts = tmp / "css_resumed.track.parts"
    assert sorted(p.name for p in parts.iterdir()) == ["chrA.tsv", "chrB.tsv"]
    assert resumed.read_bytes() == fresh.read_bytes()
    (parts / "chrA.tsv").unlink()
    resumed.unlink()
    torch_cli(_css_args(tmp, resumed, "fast", "--device", "cpu", "--resume"))
    assert resumed.read_bytes() == fresh.read_bytes()


@pytest.mark.parametrize("flags", [["--mds", "smacof"], ["--mds", "cmds+smacof"]])
def test_run_css_cli_smacof_matches_jax_cli(toy_pair, flags):
    """--mds smacof and --mds cmds+smacof, exact: rows identical, scores
    1e-9, p equal (the restarts are keyed by seed, chromosome and slot)."""
    tmp = toy_pair
    tag = flags[1].replace("+", "_")
    jax_cli(_css_args(tmp, tmp / f"jax_{tag}.track", "exact", *flags))
    torch_cli(_css_args(tmp, tmp / f"torch_{tag}.track", "exact", "--device", "cpu", *flags))
    js, jstart, jsc, jp = jax_read_score_track(tmp / f"jax_{tag}.track")
    ts, tstart, tsc, tp = read_score_track(tmp / f"torch_{tag}.track")
    assert ts == js and np.array_equal(tstart, jstart) and len(ts) > 50
    err = np.abs(tsc - jsc) / np.maximum(np.abs(jsc), 1.0)
    assert err.max() <= 1e-9, err.max()
    assert np.array_equal(tp, jp)


@pytest.fixture(scope="module")
def freq_pair(tmp_path_factory):
    """Drosophila-mode input: one allele-frequency value per SNP and
    population, two chromosomes."""
    tmp = tmp_path_factory.mktemp("torch_cli_freq")
    sizes = {"2L": 30_000, "2R": 24_000}
    for i, (seqid, region) in enumerate(sizes.items()):
        pos, fa, fb = synth.make_freq_chromosome(300, region, seed=80 + i)
        mode = "w" if i == 0 else "a"
        for name, col in (("freqA", fa), ("freqB", fb)):
            path = tmp / f"{name}_{seqid}.gtrack"
            synth.write_gtrack(path, seqid, pos, col)
            with open(tmp / f"{name}.gtrack", mode) as out:
                out.write(path.read_text())
    (tmp / "chrom.sizes").write_text("".join(f"{s}\t{n}\n" for s, n in sizes.items()))
    return tmp


def _freq_args(tmp, out, prec, *extra):
    return [
        "run-css", "--pop-a", str(tmp / "freqA.gtrack"),
        "--pop-b", str(tmp / "freqB.gtrack"), "--out", str(out),
        "--chrom-sizes", str(tmp / "chrom.sizes"), "--precision", prec,
        "--drosophila", "--mc-runs", "500", *extra,
    ]


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_cli_drosophila_matches_jax_cli(freq_pair, prec):
    """--drosophila: rows identical, scores 1e-9 (exact) or the CMDS fast
    band, p == 1 on every row in both CLIs (the reference's quirk)."""
    tmp = freq_pair
    jax_cli(_freq_args(tmp, tmp / f"jax_{prec}.track", prec))
    torch_cli(_freq_args(tmp, tmp / f"torch_{prec}.track", prec, "--device", "cpu"))
    js, jstart, jsc, jp = jax_read_score_track(tmp / f"jax_{prec}.track")
    ts, tstart, tsc, tp = read_score_track(tmp / f"torch_{prec}.track")
    assert ts == js and np.array_equal(tstart, jstart)
    assert len(ts) > 50 and set(ts) == {"2L", "2R"}
    if prec == "exact":
        err = np.abs(tsc - jsc) / np.maximum(np.abs(jsc), 1.0)
        assert err.max() <= 1e-9, err.max()
    else:
        np.testing.assert_allclose(tsc, jsc, rtol=2e-3, atol=1e-4)
    assert (tp == 1.0).all() and np.array_equal(tp, jp)


@pytest.mark.parametrize("flags", [
    ["--mds", "smacof"], ["--mds", "cmds+smacof"], ["--drosophila"],
])
def test_run_css_cli_ported_flags_run(toy_pair, tmp_path, flags):
    """The flags that raised before the port ran SMACOF and drosophila
    mode now write a track."""
    out = tmp_path / "x.track"
    torch_cli(_css_args(toy_pair, out, "fast", "--device", "cpu", *flags))
    seqids, starts, sc, pv = read_score_track(out)
    assert len(starts) > 50 and not np.isnan(sc).any()
    assert ((pv > 0) & (pv <= 1)).all()


NEW_FLAGS = [
    ["--p-mode", "approx"],
    ["--mc-stream", "window"],
    ["--mc-stream", "window", "--rng", "threefry"],
    ["--perm-backend", "native"],
    ["--rng", "threefry"],
]


@pytest.mark.parametrize("flags", NEW_FLAGS, ids=[" ".join(f) for f in NEW_FLAGS])
def test_run_css_cli_new_flags_match_jax_cli(toy_pair, flags):
    """The phase-2 options, exact: rows identical, scores 1e-9, p by the
    option's rule (tests/test_torch_css_engine.py)."""
    tmp = toy_pair
    tag = "_".join(f.strip("-") for f in flags)
    jax_cli(_css_args(tmp, tmp / f"jax_{tag}.track", "exact", *flags))
    torch_cli(_css_args(tmp, tmp / f"torch_{tag}.track", "exact", "--device", "cpu", *flags))
    js, jstart, jsc, jp = jax_read_score_track(tmp / f"jax_{tag}.track")
    ts, tstart, tsc, tp = read_score_track(tmp / f"torch_{tag}.track")
    assert ts == js and np.array_equal(tstart, jstart) and len(ts) > 50
    err = np.abs(tsc - jsc) / np.maximum(np.abs(jsc), 1.0)
    assert err.max() <= 1e-9, err.max()
    kw = {"p_mode": "approx"} if "approx" in flags else (
        {"perm_backend": "native"} if "native" in flags else {})
    assert_new_option_pvals_match(tp, jp, kw)
    assert ((tp > 0) & (tp <= 1)).all()
