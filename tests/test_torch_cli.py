"""The port's ``run-fet`` and ``run-css`` CLI (``--device cpu``) against
the JAX CLI on the same toy GTrack pair: identical rows (seqid, start),
values within tolerance relative to max(|ref|, 1), and ``--resume``
reproducing the fresh track byte for byte; ``run-css`` in its three MDS
modes, in drosophila mode on a frequency-track pair, and with every
phase-2 option (``--p-mode approx``, ``--mc-stream window``, ``--rng
threefry``, ``--perm-backend native``).  The region callers and
``report`` write the JAX CLI's bytes from the same tracks; ``run-all``
writes its staged subcommands' bytes (plain, ``--shard``, ``--resume``,
``--num-hosts 2``) and JAX ``run-all``'s rows and values.

run-fet: 1e-12 (exact) / 1e-5 (fast).  run-css: scores 1e-9 (exact) /
the JAX package's fast-vs-exact band, rtol 2e-3 atol 1e-4 (fast); p equal
except on near-tie windows (tests/test_torch_mc.py), approx p within the
band of tests/test_torch_approx.py."""

import json
from pathlib import Path

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


@pytest.fixture(scope="module")
def one_chrom(tmp_path_factory):
    """A one-chromosome genome: --num-hosts 2 must cut it into slot ranges."""
    tmp = tmp_path_factory.mktemp("torch_cli_hosts")
    pos, am, bm = synth.make_panel(1200, 60_000, 6, 5, seed=91)
    synth.write_gtrack(tmp / "popA.gtrack", "chrS", pos, am)
    synth.write_gtrack(tmp / "popB.gtrack", "chrS", pos, bm)
    (tmp / "chrom.sizes").write_text("chrS\t60000\n")
    return tmp


def _rows(path):
    return [ln for ln in path.read_text().splitlines() if ln and not ln.startswith("#")]


@pytest.mark.parametrize("sub,extra", [("run-fet", []), ("run-css", ["--mc-runs", "2000"])])
def test_multihost_merge_is_byte_identical(one_chrom, tmp_path, sub, extra, capsys):
    """Two hosts each score one slot half of the chromosome; the port's
    merge-tracks joins them into the single-host track byte for byte, and
    writes the JAX CLI's bytes from the same shards."""
    tmp = one_chrom
    common = [sub, "--pop-a", str(tmp / "popA.gtrack"), "--pop-b", str(tmp / "popB.gtrack"),
              "--chrom-sizes", str(tmp / "chrom.sizes"), "--device", "cpu", *extra]
    single = tmp_path / "single.track"
    torch_cli(common + ["--out", str(single)])
    shards = []
    for host in ("0", "1"):
        shards.append(tmp_path / f"h{host}.track")
        torch_cli(common + ["--out", str(shards[-1]), "--num-hosts", "2", "--host-id", host,
                            "--resume"])
    out = capsys.readouterr().out
    assert "host 0/2 takes ['chrS[0:60]']" in out and "host 1/2 takes ['chrS[60:120]']" in out
    # a partial chromosome's part file carries its slot range
    assert (tmp_path / "h1.track.parts" / f"chrS@60-{1 << 62}.tsv").exists()
    h0, h1 = _rows(shards[0]), _rows(shards[1])
    assert h0 and h1
    assert all(int(ln.split("\t")[1]) < 30_000 for ln in h0)
    assert all(int(ln.split("\t")[1]) >= 30_000 for ln in h1)
    merged, jmerged = tmp_path / "merged.track", tmp_path / "jax_merged.track"
    torch_cli(["merge-tracks", "--inputs", *map(str, shards), "--out", str(merged)])
    jax_cli(["merge-tracks", "--inputs", *map(str, shards), "--out", str(jmerged)])
    assert merged.read_bytes() == single.read_bytes()
    assert merged.read_bytes() == jmerged.read_bytes()
    # a second copy of a shard overlaps: refused
    with pytest.raises(SystemExit):
        torch_cli(["merge-tracks", "--inputs", str(shards[0]), str(shards[0]),
                   "--out", str(tmp_path / "bad.track")])


@pytest.mark.parametrize("sub", ["run-fet", "run-css"])
def test_shard_and_profile_flags(toy_pair, tmp_path, sub):
    """--shard (a (cpu,) mesh with --device cpu) writes the unsharded
    track's bytes; --profile writes a torch.profiler trace."""
    args = (_args if sub == "run-fet" else _css_args)(
        toy_pair, tmp_path / "plain.track", "fast", "--device", "cpu")
    torch_cli(args)
    sharded = tmp_path / "sharded.track"
    args = (_args if sub == "run-fet" else _css_args)(
        toy_pair, sharded, "fast", "--device", "cpu", "--shard",
        "--profile", str(tmp_path / "prof"), "--summary", str(tmp_path / "s.json"))
    torch_cli(args)
    assert sharded.read_bytes() == (tmp_path / "plain.track").read_bytes()
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert json.loads((tmp_path / "s.json").read_text())["counters"]["mesh"] == ["cpu"]


def test_bench_scaling_cli(capsys):
    torch_cli(["bench-scaling", "--device", "cpu", "--devices", "2",
               "--windows-per-device", "4", "--mc-chunk", "8"])
    report = json.loads(capsys.readouterr().out)
    assert report["backend"] == "cpu"
    assert [r["devices"] for r in report["weak_scaling"]] == [1, 2]


# ----------------------------------------------------------------------------
# the whole pipeline: region callers, report, run-all
# ----------------------------------------------------------------------------

def _seeded_score_tracks(tmp):
    """A FET and a CSS score track, two chromosomes with divergent runs, and
    their chrom.sizes, written by the port's writer."""
    from divergence_tpu_torch.io import write_score_track

    rs = np.random.default_rng(44)
    fet, css = {}, {}
    for seqid, n in (("chr1", 700), ("chr2", 400)):
        s = rs.gamma(2.0, 0.7, n)
        p = rs.uniform(0.01, 1.0, n)
        for lo in rs.integers(0, n - 10, 3):
            s[lo:lo + 6] += rs.uniform(5, 9)
            p[lo:lo + 4] = rs.uniform(1e-6, 1e-4, 4)
        empty = rs.random(n) < 0.1
        s[empty] = 0.0
        fet[seqid] = (s, np.where(empty, 0.0, rs.uniform(0.01, 0.3, n)))
        css[seqid] = (s * 0.3, np.where(empty, 0.0, p))
    write_score_track(tmp / "fet.track", fet, 500, ("score", "stddev"))
    write_score_track(tmp / "css.track", css, 500, ("score", "p"))
    (tmp / "sizes").write_text("chr1\t350200\nchr2\t200000\n")
    return tmp / "fet.track", tmp / "css.track", tmp / "sizes"


CALLER_ARGS = [
    ["filter-fet"],
    ["filter-fet", "--max-distance", "2000", "--norm-quantile", "0.99",
     "--stddev-percentile", "50"],
    ["call-css-regions"],
    ["call-css-regions", "--mode", "top", "--num-top", "20", "--window-size", "1000"],
    ["call-css-regions", "--fdr", "1e-9"],
]


@pytest.mark.parametrize("argv", CALLER_ARGS, ids=[" ".join(a) for a in CALLER_ARGS])
def test_region_callers_match_jax_cli(tmp_path, capsys, argv):
    """filter-fet and call-css-regions given the same track write the JAX
    CLI's region file byte for byte and print its JSON line."""
    fet, css, sizes = _seeded_score_tracks(tmp_path)
    scores = fet if argv[0] == "filter-fet" else css
    outs = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        out = tmp_path / f"{name}.gtrack"
        cli([*argv, "--scores", str(scores), "--out", str(out), "--chrom-sizes", str(sizes)])
        outs[name] = (out.read_bytes(), json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert outs["torch"][0] == outs["jax"][0]
    assert outs["torch"][1] == outs["jax"][1]
    assert outs["torch"][1]["regions"] > 0 or "1e-9" in argv


def test_report_matches_jax_cli(tmp_path, monkeypatch):
    """report over the same tracks, regions and run summary writes the JAX
    CLI's report.html byte for byte (relative paths: the page names them)."""
    fet, css, sizes = _seeded_score_tracks(tmp_path)
    monkeypatch.chdir(tmp_path)
    torch_cli(["filter-fet", "--scores", "fet.track", "--out", "fr.gtrack"])
    torch_cli(["call-css-regions", "--scores", "css.track", "--out", "cr.gtrack"])
    (tmp_path / "s.json").write_text(json.dumps({"name": "run-fet", "counters": {"x": 1}}))
    common = ["report", "--fet-track", "fet.track", "--css-track", "css.track",
              "--fet-regions", "fr.gtrack", "--css-regions", "cr.gtrack",
              "--run-summary", "s.json", "--title", "a <title>"]
    jax_cli([*common, "--out", "jax.html"])
    torch_cli([*common, "--out", "torch.html"])
    assert (tmp_path / "torch.html").read_bytes() == (tmp_path / "jax.html").read_bytes()
    assert "Top 20 windows" in (tmp_path / "torch.html").read_text()
    jax_cli(["report", "--css-track", "css.track", "--out", "jax1.html"])
    torch_cli(["report", "--css-track", "css.track", "--out", "torch1.html"])
    assert (tmp_path / "torch1.html").read_bytes() == (tmp_path / "jax1.html").read_bytes()


def _all_args(tmp, outdir, prec, *extra, cli_extra=("--device", "cpu")):
    return [
        "run-all", "--pop-a", str(tmp / "popA.gtrack"), "--pop-b", str(tmp / "popB.gtrack"),
        "--outdir", str(outdir), "--chrom-sizes", str(tmp / "chrom.sizes"),
        "--precision", prec, "--seed", "4", "--mc-runs", "400", *extra, *cli_extra,
    ]


OUTPUTS = ("fet.track", "css.track", "fet_regions.gtrack", "css_regions.gtrack")


def _without_summary(html):
    """report.html without its run-summary section (it holds timings)."""
    head, _, rest = html.partition("<h2>Run summary</h2>")
    return head + rest.partition("</pre>")[2]


@pytest.mark.parametrize("prec", ["fast", "exact"])
def test_run_all_matches_staged_pipeline(toy_pair, tmp_path, monkeypatch, prec):
    """run-all (one read and upload of the genome) writes the staged
    subcommands' tracks, region files and report byte for byte (the report
    but for its run-summary timings), and combines a user --summary."""
    tmp = toy_pair
    monkeypatch.chdir(tmp_path)
    (tmp_path / "all").mkdir()
    (tmp_path / "staged").mkdir()
    monkeypatch.chdir(tmp_path / "all")
    # a low --norm-quantile: the toy genome's Burke limit at 0.999 passes no window
    torch_cli(_all_args(tmp, "out", prec, "--summary", "combined.json", "--norm-quantile", "0.6"))
    combined = json.loads((tmp_path / "all" / "combined.json").read_text())
    assert set(combined) == {"fet", "css"}
    assert combined["fet"]["counters"]["windows_planned"] > 0
    assert combined["css"]["counters"]["mc_permutations"] > 0
    monkeypatch.chdir(tmp_path / "staged")
    Path("out").mkdir()
    common = ["--pop-a", str(tmp / "popA.gtrack"), "--pop-b", str(tmp / "popB.gtrack"),
              "--chrom-sizes", str(tmp / "chrom.sizes"), "--precision", prec, "--seed", "4",
              "--device", "cpu"]
    torch_cli(["run-fet", *common, "--out", "out/fet.track", "--summary", "out/fet_summary.json"])
    torch_cli(["run-css", *common, "--mc-runs", "400", "--out", "out/css.track"])
    torch_cli(["filter-fet", "--scores", "out/fet.track", "--out", "out/fet_regions.gtrack",
               "--chrom-sizes", str(tmp / "chrom.sizes"), "--norm-quantile", "0.6"])
    torch_cli(["call-css-regions", "--scores", "out/css.track", "--out",
               "out/css_regions.gtrack", "--chrom-sizes", str(tmp / "chrom.sizes")])
    torch_cli(["report", "--fet-track", "out/fet.track", "--css-track", "out/css.track",
               "--fet-regions", "out/fet_regions.gtrack", "--css-regions",
               "out/css_regions.gtrack", "--run-summary", "out/fet_summary.json",
               "--out", "out/report.html"])
    a, b = tmp_path / "all" / "out", tmp_path / "staged" / "out"
    for f in OUTPUTS:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert len(_rows(a / "fet.track")) > 50
    for f in ("fet_regions.gtrack", "css_regions.gtrack"):
        assert len(_rows(a / f)) > 1, f
    html = (a / "report.html").read_text()
    assert "Run summary" in html and "chrA" in html
    assert _without_summary(html) == _without_summary((b / "report.html").read_text())
    assert json.loads((a / "css_summary.json").read_text())["name"] == "run-css"


def test_run_all_sharded_resumed_and_multihost(toy_pair, tmp_path):
    """run-all with --shard (a CPU mesh) and with --resume (twice) writes
    the plain run's bytes; under --num-hosts 2 each host writes its track
    shards and no regions, and the merged shards are the one-host tracks."""
    tmp = toy_pair
    outs = {}
    for name, extra in (("plain", []), ("shard", ["--shard"]), ("resume", ["--resume"])):
        outs[name] = tmp_path / name
        torch_cli(_all_args(tmp, outs[name], "fast", *extra))
    torch_cli(_all_args(tmp, outs["resume"], "fast", "--resume"))   # from the parts
    assert (outs["resume"] / "fet.track.parts" / "chrA.tsv").exists()
    assert (outs["resume"] / "css.track.parts" / "chrB.tsv").exists()
    for name in ("shard", "resume"):
        for f in OUTPUTS:
            assert (outs[name] / f).read_bytes() == (outs["plain"] / f).read_bytes(), (name, f)
    hosts = []
    for h in (0, 1):
        d = tmp_path / f"host{h}"
        torch_cli(_all_args(tmp, d, "fast", "--num-hosts", "2", "--host-id", str(h)))
        assert not any((d / f).exists() for f in
                       ("fet_regions.gtrack", "css_regions.gtrack", "report.html"))
        hosts.append(d)
    for f in ("fet.track", "css.track"):
        merged = tmp_path / f"merged_{f}"
        torch_cli(["merge-tracks", "--inputs", *(str(d / f) for d in hosts), "--out", str(merged)])
        assert merged.read_bytes() == (outs["plain"] / f).read_bytes(), f


@pytest.mark.parametrize("prec", ["fast", "exact"])
def test_run_all_matches_jax_run_all(toy_pair, tmp_path, prec):
    """Against the JAX CLI's run-all: identical rows, FET values within TOL,
    CSS scores within the run-css band and p equal but for near ties; a
    region file is identical wherever its track is."""
    tmp = toy_pair
    torch_cli(_all_args(tmp, tmp_path / "torch", prec))
    jax_cli(_all_args(tmp, tmp_path / "jax", prec, cli_extra=()))
    t, j = tmp_path / "torch", tmp_path / "jax"
    ts, tstart, tsc, tsd = read_score_track(t / "fet.track")
    js, jstart, jsc, jsd = jax_read_score_track(j / "fet.track")
    assert ts == js and np.array_equal(tstart, jstart) and len(ts) > 50
    for got, want in ((tsc, jsc), (tsd, jsd)):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= TOL[prec], err.max()
    ts, tstart, tsc, tp = read_score_track(t / "css.track")
    js, jstart, jsc, jp = jax_read_score_track(j / "css.track")
    assert ts == js and np.array_equal(tstart, jstart)
    if prec == "exact":
        err = np.abs(tsc - jsc) / np.maximum(np.abs(jsc), 1.0)
        assert err.max() <= 1e-9, err.max()
    else:
        np.testing.assert_allclose(tsc, jsc, rtol=2e-3, atol=1e-4)
    assert (tp != jp).sum() <= 0.02 * len(tp)
    for caller, track, regions in (("filter-fet", "fet.track", "fet_regions.gtrack"),
                                   ("call-css-regions", "css.track", "css_regions.gtrack")):
        # the JAX CLI's caller on the port's track writes the port's regions
        jax_cli([caller, "--scores", str(t / track), "--out", str(tmp_path / regions),
                 "--chrom-sizes", str(tmp / "chrom.sizes")])
        assert (tmp_path / regions).read_bytes() == (t / regions).read_bytes(), regions
        if (t / track).read_bytes() == (j / track).read_bytes():
            assert (t / regions).read_bytes() == (j / regions).read_bytes(), regions
    assert (t / "report.html").exists() and (j / "report.html").exists()


@pytest.mark.parametrize("sub", ["run-all", "filter-fet", "call-css-regions", "report",
                                 "run-fet", "run-css"])
def test_subcommands_take_the_jax_cli_flags(sub):
    """Each subcommand has the JAX CLI's flags with the same defaults,
    choices and required-ness; the port adds only --device to the scans."""
    from divergence_tpu.tools.cli import build_parser as jax_parser
    from divergence_tpu_torch.tools.cli import build_parser as torch_parser

    def flags(parser):
        sub_action = next(a for a in parser._actions if a.dest == "cmd")
        return {
            a.option_strings[0]: (a.default, a.choices, a.required, a.nargs)
            for a in sub_action.choices[sub]._actions if a.option_strings and a.dest != "help"
        }

    got, want = flags(torch_parser()), flags(jax_parser())
    if sub.startswith("run-"):
        assert got.pop("--device")[0] == "cuda"
    assert got == want
