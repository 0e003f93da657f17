"""The port carries copies of the JAX package's jax-free host modules
(importing ``divergence_tpu`` imports jax, which the port must not need).
These tests hold each copy equal to its original: same source for the
verbatim parts, same output on the same input."""

import inspect
from pathlib import Path

import numpy as np
import pytest

import divergence_tpu.compat.analysisdef as jcompat
import divergence_tpu.config as jconfig
import divergence_tpu.core.windows as jwindows
import divergence_tpu.io.genome as jgenome
import divergence_tpu.io.gtrack as jgtrack
import divergence_tpu.io.snptable as jsnptable
import divergence_tpu.io.vcf as jvcf
import divergence_tpu.native as jnative
import divergence_tpu.parallel.mesh as jmesh
import divergence_tpu.parallel.multihost as jmultihost
import divergence_tpu.stats.regions as jregions
import divergence_tpu.tools.report as jreport
import divergence_tpu.utils.summary as jsummary
import divergence_tpu_torch.compat.analysisdef as tcompat
import divergence_tpu_torch.config as tconfig
import divergence_tpu_torch.core.windows as twindows
import divergence_tpu_torch.io.genome as tgenome
import divergence_tpu_torch.io.gtrack as tgtrack
import divergence_tpu_torch.io.snptable as tsnptable
import divergence_tpu_torch.io.vcf as tvcf
import divergence_tpu_torch.native as tnative
import divergence_tpu_torch.parallel.mesh as tmesh
import divergence_tpu_torch.parallel.multihost as tmultihost
import divergence_tpu_torch.stats.regions as tregions
import divergence_tpu_torch.tools.report as treport
import divergence_tpu_torch.utils.summary as tsummary
from divergence_tpu_torch.tools import synth

VERBATIM = [
    (jwindows, twindows, "WindowPlan"),
    (jwindows, twindows, "plan_windows"),
    (jgtrack, tgtrack, "PopulationTrack"),
    (jgtrack, tgtrack, "_infer_population_size"),
    (jgtrack, tgtrack, "_read_rows_chunked"),
    (jgtrack, tgtrack, "_group_rows_indexed"),
    (jgtrack, tgtrack, "gtrack_points_header"),
    (jgtrack, tgtrack, "write_score_track"),
    (jgtrack, tgtrack, "read_score_track"),
    (jgenome, tgenome, "read_chrom_sizes"),
    (jgenome, tgenome, "write_chrom_sizes"),
    (jsummary, tsummary, "RunSummary"),
    (jsummary, tsummary, "StageTimer"),
    (jconfig, tconfig, "WindowConfig"),
    (jconfig, tconfig, "FetConfig"),
    (jconfig, tconfig, "MdsAlgorithm"),
    (jconfig, tconfig, "SmacofConfig"),
    (jconfig, tconfig, "CssConfig"),
    (jmesh, tmesh, "pad_to_multiple"),
    (jmultihost, tmultihost, "WorkRange"),
    (jmultihost, tmultihost, "HostAssignment"),
    (jmultihost, tmultihost, "partition_chromosomes"),
    (jmultihost, tmultihost, "merge_score_shards"),
    (jconfig, tconfig, "FetFilterConfig"),
    (jconfig, tconfig, "CssRegionConfig"),
    (jgtrack, tgtrack, "write_segments_track"),
    (jregions, tregions, "RegionCall"),
    (jregions, tregions, "burke_components"),
    (jregions, tregions, "burke_limit"),
    (jregions, tregions, "bh_threshold"),
    (jregions, tregions, "top_n_threshold"),
    (jregions, tregions, "merge_windows"),
    (jregions, tregions, "filter_fet_regions"),
    (jregions, tregions, "call_css_regions"),
    (jreport, treport, "_track_section"),
    (jreport, treport, "_regions_section"),
    (jreport, treport, "write_report"),
    (jvcf, tvcf, "_convert_stream"),
    (jsnptable, tsnptable, "snp_table_to_gtrack"),
    (jcompat, tcompat, "parse_analysis_def"),
    (jcompat, tcompat, "_require"),
    (jcompat, tcompat, "config_from_analysis_def"),
    (jcompat, tcompat, "build_analysis_def"),
    (jnative, tnative, "_host_cpu_tag"),
    (jnative, tnative, "_GtrackResult"),
    (jnative, tnative, "parse_gtrack_native_indexed"),
    (jnative, tnative, "parse_gtrack_native"),
    (jnative, tnative, "vcf_convert_native"),
    (jnative, tnative, "native_available"),
]


@pytest.mark.parametrize(
    "orig,copy,name", VERBATIM, ids=[f"{m.__name__}.{n}" for m, _, n in VERBATIM]
)
def test_copy_is_verbatim(orig, copy, name):
    assert inspect.getsource(getattr(copy, name)) == inspect.getsource(
        getattr(orig, name)
    )


@pytest.mark.parametrize(
    "wsize,wstep,regend",
    [(2500, 500, 20_000), (1000, 1000, 7_777), (300, 700, 15_000), (5000, 500, 3000)],
)
def test_plan_windows_equal(wsize, wstep, regend):
    rs = np.random.default_rng(wsize + wstep)
    positions = np.sort(rs.choice(np.arange(1, regend + 500), 300, replace=False))
    a = jwindows.plan_windows(positions, regend, wsize, wstep)
    b = twindows.plan_windows(positions, regend, wsize, wstep)
    for f in ("starts", "lo", "npos", "slot"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.nslots, a.wsize, a.wstep) == (b.nslots, b.wsize, b.wstep)
    assert np.array_equal(a.valid_mask(), b.valid_mask())


def _equal_tracks(a, b):
    assert list(a) == list(b)
    for seqid in a:
        x, y = a[seqid], b[seqid]
        assert (x.seqid, x.size) == (y.seqid, y.size)
        assert np.array_equal(x.pos, y.pos) and np.array_equal(x.vals, y.vals)


def test_gtrack_reader_equal(tmp_path):
    """Port reader (Python parser) == JAX reader (native parser where built)
    on a multi-chromosome file with comments and out-of-order blocks."""
    path = tmp_path / "pop.gtrack"
    lines = []
    for seqid, seed in (("chrB", 1), ("chrA", 2), ("chrC", 3)):
        pos, am, _ = synth.make_panel(60, 5000, 4, 3, seed=seed)
        synth.write_gtrack(tmp_path / "one.gtrack", seqid, pos, am)
        lines += (tmp_path / "one.gtrack").read_text().splitlines(keepends=True)
        lines.append("# an interleaved comment\n")
    # move one block of chrA's rows ahead of chrB: forces the lexsort path
    chra = [ln for ln in lines if ln.startswith("chrA\t")][:4]
    rest = [ln for ln in lines if ln not in chra]
    path.write_text("".join(chra + rest))
    _equal_tracks(
        jgtrack.read_gtrack_points(path), tgtrack.read_gtrack_points(path)
    )
    _equal_tracks(
        jgtrack.read_gtrack_points(path, seqids=["chrC"]),
        tgtrack.read_gtrack_points(path, seqids=["chrC"]),
    )


def test_synth_gtrack_round_trip(tmp_path):
    pos, am, bm = synth.make_panel(500, 40_000, 11, 10, seed=5)
    assert am.dtype == np.int16 and am.shape == (500, 11) and bm.shape == (500, 10)
    assert set(np.unique(np.concatenate([am, bm], axis=1))) <= {3, -3, 0, -10000}
    assert np.all(np.diff(pos) > 0)
    synth.write_gtrack(tmp_path / "a.gtrack", "chrX", pos, am)
    track = tgtrack.read_gtrack_points(tmp_path / "a.gtrack")["chrX"]
    assert track.size == 11
    assert np.array_equal(track.positions_unique(), pos)
    assert np.array_equal(track.values_matrix(), am)


def test_score_track_writer_and_reader_equal(tmp_path):
    rs = np.random.default_rng(9)
    results = {}
    for seqid in ("chr2", "chr1"):
        s = rs.uniform(0, 6, 40)
        s[rs.random(40) < 0.3] = 0.0
        results[seqid] = (s, rs.uniform(0, 1, 40))
    jgtrack.write_score_track(tmp_path / "j.track", results, 500)
    tgtrack.write_score_track(tmp_path / "t.track", results, 500)
    assert (tmp_path / "j.track").read_bytes() == (tmp_path / "t.track").read_bytes()
    a = jgtrack.read_score_track(tmp_path / "j.track")
    b = tgtrack.read_score_track(tmp_path / "t.track")
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(x, y)


def test_chrom_sizes_equal(tmp_path):
    path = tmp_path / "g.sizes"
    path.write_text("# sizes\nchrI\t29000000\nchrII  23000000\n\nchrUn\t5\n")
    assert jgenome.read_chrom_sizes(path) == tgenome.read_chrom_sizes(path)


def test_config_defaults_and_validation_equal():
    t, j = tconfig.FetConfig(), jconfig.FetConfig()
    assert t.__dict__.keys() == j.__dict__.keys()
    assert (t.percentile, t.bootstrap_samples, t.seed, t.precision) == (
        j.percentile, j.bootstrap_samples, j.seed, j.precision
    )
    assert t.precision == "exact"           # the library default
    assert (t.window.wsize, t.window.wstep) == (j.window.wsize, j.window.wstep)
    for bad in ({"percentile": 1.5}, {"bootstrap_samples": 1}, {"precision": "x"}):
        with pytest.raises(ValueError):
            tconfig.FetConfig(**bad)
    w = tconfig.WindowConfig(wsize=2500, wstep=500)
    assert w.num_slots(20_001) == jconfig.WindowConfig().num_slots(20_001)
    assert w.num_windows(20_001) == jconfig.WindowConfig().num_windows(20_001)


def test_css_config_defaults_and_validation_equal():
    t, j = tconfig.CssConfig(), jconfig.CssConfig()
    assert t.__dict__.keys() == j.__dict__.keys()
    for name in t.__dict__:
        if name not in ("window", "smacof", "mds"):
            assert getattr(t, name) == getattr(j, name), name
    assert int(t.mds) == int(j.mds) == 0
    assert t.smacof.__dict__ == j.smacof.__dict__
    assert (t.precision, t.p_mode, t.mc_stream, t.rng, t.perm_backend) == (
        "exact", "mc", "shared", "mix", "xla"
    )
    bad = [{"mc_threshold": 0}, {"mc_chunk": 0}, {"precision": "x"},
           {"p_mode": "x"}, {"rng": "x"}, {"mc_stream": "x"},
           {"perm_backend": "native", "rng": "threefry"}]
    for kw in bad:
        with pytest.raises(ValueError):
            tconfig.CssConfig(**kw)
        with pytest.raises(ValueError):
            jconfig.CssConfig(**kw)
    # the native backend switches the stream, as in the JAX package
    assert tconfig.CssConfig(perm_backend="native").mc_stream == "window"


@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_partition_chromosomes_equal(num):
    """Same assignment from both copies, slot-granular included; the
    open-ended sentinel is the same."""
    assert tmultihost.TO_END == jmultihost.TO_END
    weights = {"chr1": 9000, "chr2": 400, "chr3": 2500, "chrUn": 1}
    nslots = {"chr1": 800, "chr2": 40, "chr3": 300, "chrUn": 2}
    for pid in range(num):
        for kw in ({}, {"seqid_nslots": nslots}):
            a = jmultihost.partition_chromosomes(weights, num, pid, **kw)
            b = tmultihost.partition_chromosomes(weights, num, pid, **kw)
            assert (a.seqids, a.num_processes, a.process_id) == (
                b.seqids, b.num_processes, b.process_id)
            assert [(r.seqid, r.slot_lo, r.slot_hi) for r in a.ranges] == [
                (r.seqid, r.slot_lo, r.slot_hi) for r in b.ranges]


def test_region_configs_equal():
    t, j = tconfig.FetFilterConfig(), jconfig.FetFilterConfig()
    assert t.__dict__ == j.__dict__
    t, j = tconfig.CssRegionConfig(), jconfig.CssRegionConfig()
    assert t.__dict__ == j.__dict__
    for cls in ("FetFilterConfig", "CssRegionConfig"):
        for bad in ({"max_distance": -1}, {"norm_quantile": 1.0}, {"stddev_percentile": 101.0},
                    {"mode": "x"}, {"fdr": 0.0}, {"num_top": 0}, {"window_size": 0}):
            kw = {k: v for k, v in bad.items() if k in getattr(jconfig, cls).__dataclass_fields__}
            if not kw:
                continue
            with pytest.raises(ValueError):
                getattr(tconfig, cls)(**kw)
            with pytest.raises(ValueError):
                getattr(jconfig, cls)(**kw)


def test_report_style_and_segments_writer_equal(tmp_path):
    """The report's stylesheet, and the segments files both writers give."""
    assert treport._STYLE == jreport._STYLE
    segs = [("chr2", 0, 101_000), ("chr10", 5, 7), ("chrUn", 300_000, 349_999)]
    for sorted_elements in (False, True):
        jgtrack.write_segments_track(tmp_path / "j.gtrack", segs, sorted_elements)
        tgtrack.write_segments_track(tmp_path / "t.gtrack", segs, sorted_elements)
        assert (tmp_path / "j.gtrack").read_bytes() == (tmp_path / "t.gtrack").read_bytes()


def test_converter_tables_equal():
    assert tvcf.GENOTYPE_CODES == jvcf.GENOTYPE_CODES
    assert tsnptable.MISSING_MARKERS == jsnptable.MISSING_MARKERS
    assert (tcompat.FET_STAT, tcompat.CSS_STAT) == (jcompat.FET_STAT, jcompat.CSS_STAT)
    assert tcompat._KWARG_RE.pattern == jcompat._KWARG_RE.pattern
    assert tcompat._STAT_RE.pattern == jcompat._STAT_RE.pattern


@pytest.mark.parametrize("name", ["gtrack_parser.cpp", "vcf_convert.cpp"])
def test_native_sources_are_byte_copies(name):
    orig = Path(jnative.__file__).parent / name
    copy = Path(tnative.__file__).parent / name
    assert copy.read_bytes() == orig.read_bytes()


def test_native_carries_no_mc_evaluator():
    """The port's host library is the parser and the converter only:
    perm_backend="native" runs K8's float64 form on the card."""
    here = Path(tnative.__file__).parent
    assert sorted(p.name for p in here.glob("*.cpp")) == ["gtrack_parser.cpp",
                                                          "vcf_convert.cpp"]
    assert not hasattr(tnative, "mc_native") and not hasattr(tnative, "fold_in_native")
