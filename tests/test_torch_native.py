"""The port's native host library (``divergence_tpu_torch/native``): its
build into ``_build/`` with an atomic rename, the C++ GTrack parser
against the Python reader, and the C++ VCF converter against the Python
converter, byte for byte (``tests/test_native.py``'s cases).

The JAX side is its Python semantics, never its native ``.so`` (whose
build writes straight onto its final path and can lose a race between
test workers): ``divergence_tpu.io.gtrack._read_rows_chunked`` /
``_group_rows_indexed`` and ``divergence_tpu.io.vcf._convert_stream``."""

import ctypes
import gzip
import io
import threading

import numpy as np
import pytest

import divergence_tpu.io.gtrack as jgtrack
import divergence_tpu.io.vcf as jvcf
import divergence_tpu_torch.io.gtrack as tgtrack
from divergence_tpu_torch import native
from divergence_tpu_torch.io import read_gtrack_points, vcf_to_gtrack
from divergence_tpu_torch.native import (
    native_available,
    parse_gtrack_native,
    parse_gtrack_native_indexed,
    vcf_convert_native,
)
from divergence_tpu_torch.tools import synth


def jax_python_tracks(path, seqids=None):
    """The JAX package's reader on its Python path."""
    return jgtrack._group_rows_indexed(*jgtrack._read_rows_chunked(path), seqids=seqids)


def assert_tracks_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        assert (x.seqid, x.size) == (y.seqid, y.size)
        np.testing.assert_array_equal(x.pos, y.pos)
        np.testing.assert_array_equal(x.vals, y.vals)
        assert x.pos.dtype == y.pos.dtype and x.vals.dtype == y.vals.dtype


@pytest.fixture(scope="module")
def gtrack_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_native")
    rng = np.random.default_rng(3)
    path = tmp / "pop.gtrack"
    rows = []
    with open(path, "w") as fh:
        fh.write("##gtrack version: 1.0\n##track type: valued points\n")
        fh.write("###seqid\tstart\tvalue\tgenomeid\n")
        for chrom in ("chrI", "chrII"):
            positions = np.sort(rng.choice(np.arange(1, 50_000), 200, replace=False))
            for p in positions:
                for ind in range(5):
                    v = float(rng.choice([3, -3, 0, -10000]))
                    fh.write(f"{chrom}\t{p}\t{v:g}\tind{ind}\n")
                    rows.append((chrom, int(p), v))
    return path, rows


def test_native_builds_into_build_dir():
    assert native_available(), native.build_error()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.endswith(
        f"_{native._host_cpu_tag()}.so")
    assert path.name in (native.library_name(t) for t in native.CXX_TUNINGS)
    assert native.build_error() is None


def test_native_rows_match_python_reader(gtrack_file):
    path, rows = gtrack_file
    seq, pos, vals = parse_gtrack_native(path)
    assert len(pos) == len(rows)
    assert [(str(s), int(p), float(v)) for s, p, v in zip(seq, pos, vals)] == rows
    names, idx, ppos, pvals = jgtrack._read_rows_chunked(path)
    nnames, nidx, npos, nvals = parse_gtrack_native_indexed(path)
    assert nnames == names
    np.testing.assert_array_equal(nidx, idx)
    np.testing.assert_array_equal(npos, ppos)
    np.testing.assert_array_equal(nvals, pvals)


def test_read_gtrack_points_takes_native_and_equals_jax(gtrack_file, monkeypatch):
    path, _ = gtrack_file
    monkeypatch.setitem(tgtrack.PARSES, "native", 0)
    monkeypatch.setitem(tgtrack.PARSES, "python", 0)
    via_native = read_gtrack_points(path)
    assert tgtrack.PARSES == {"native": 1, "python": 0}
    assert_tracks_equal(via_native, jax_python_tracks(path))
    assert_tracks_equal(read_gtrack_points(path, seqids=["chrII"]),
                        jax_python_tracks(path, seqids=["chrII"]))
    # the Python path, where the library is unavailable, gives the same
    monkeypatch.setattr(native, "parse_gtrack_native_indexed", lambda p: None)
    assert_tracks_equal(read_gtrack_points(path), via_native)
    assert tgtrack.PARSES == {"native": 2, "python": 1}


def test_no_native_variable_turns_the_library_off(gtrack_file, monkeypatch):
    path, _ = gtrack_file
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setenv("DIVERGENCE_TPU_NO_NATIVE", "1")
    assert not native_available()
    assert parse_gtrack_native_indexed(path) is None
    assert native.build_error() == "DIVERGENCE_TPU_NO_NATIVE is set"
    assert_tracks_equal(read_gtrack_points(path), jax_python_tracks(path))


def test_native_missing_file():
    assert parse_gtrack_native("/nonexistent/file.gtrack") is None


def test_synth_pair_equals_jax_reader(tmp_path):
    """A multi-chromosome file with comments and a block out of order
    (the lexsort path), as the port's tools write it."""
    lines = []
    for seqid, seed in (("chrB", 1), ("chrA", 2), ("chrC", 3)):
        pos, am, _ = synth.make_panel(60, 5000, 4, 3, seed=seed)
        synth.write_gtrack(tmp_path / "one.gtrack", seqid, pos, am)
        lines += (tmp_path / "one.gtrack").read_text().splitlines(keepends=True)
        lines.append("# an interleaved comment\n")
    chra = [ln for ln in lines if ln.startswith("chrA\t")][:4]
    path = tmp_path / "pop.gtrack"
    path.write_text("".join(chra + [ln for ln in lines if ln not in chra]))
    assert_tracks_equal(read_gtrack_points(path), jax_python_tracks(path))


def test_interleaved_chromosomes_group_identically(tmp_path):
    rng = np.random.default_rng(8)
    rows = []
    for chrom in ("chrA", "chrB"):
        positions = rng.choice(np.arange(1, 9999), 60, replace=False)
        for p in positions:
            for ind in range(3):
                rows.append((chrom, int(p), float(rng.choice([3, -3, 0]))))
    inter = rows[::2] + rows[1::2]

    def write(path, rws):
        with open(path, "w") as fh:
            fh.write("#h\n")
            for c, p, v in rws:
                fh.write(f"{c}\t{p}\t{v:g}\tx\n")

    f_grouped, f_inter = tmp_path / "grouped.gtrack", tmp_path / "inter.gtrack"
    write(f_grouped, sorted(rows, key=lambda r: (r[0], r[1])))
    write(f_inter, inter)
    a, b = read_gtrack_points(f_grouped), read_gtrack_points(f_inter)
    assert set(a) == set(b) == {"chrA", "chrB"}
    for k in a:
        np.testing.assert_array_equal(a[k].pos, b[k].pos)
        assert a[k].size == b[k].size == 3
    assert_tracks_equal(b, jax_python_tracks(f_inter))


BAD_ROWS = [
    "chr1\tabc\t3\n",       # non-integer position
    "chr1\t12\n",           # missing value column
    "chr1\t12\t1.2.3\n",    # malformed float
    "chr1\t1.5\t3\n",       # fractional position
    "chr1\t12\t\t\n",       # empty value token
]


@pytest.mark.parametrize("bad", BAD_ROWS, ids=["pos", "no-value", "float", "frac", "empty"])
def test_malformed_rows_are_refused_as_strictly(tmp_path, bad):
    """A malformed row refuses the whole native parse, and the Python
    reader then raises as the JAX package's does: the native path never
    fabricates rows."""
    f = tmp_path / "bad.gtrack"
    f.write_text("#h\n" + bad)
    assert parse_gtrack_native(f) is None
    with pytest.raises((ValueError, IndexError)) as port:
        read_gtrack_points(f)
    with pytest.raises((ValueError, IndexError)) as ref:
        jax_python_tracks(f)
    assert type(port.value) is type(ref.value)


def test_blank_and_comment_lines_skipped(tmp_path):
    ok = tmp_path / "ok.gtrack"
    ok.write_text("#h\n   \n\t\n  # indented comment\r\nchr1\t5\t3\ta\n\r\n")
    seq, pos, vals = parse_gtrack_native(ok)
    assert list(seq) == ["chr1"] and list(pos) == [5] and list(vals) == [3.0]
    assert_tracks_equal(read_gtrack_points(ok), jax_python_tracks(ok))


def test_negative_and_float_values(tmp_path):
    path = tmp_path / "x.gtrack"
    path.write_text(
        "#h\nchr1\t100\t-10000\ta\nchr1\t100\t0.25\tb\n"
        "chr1\t200\t-3\ta\nchr1\t200\t1e-3\tb\n"
    )
    _, pos, vals = parse_gtrack_native(path)
    np.testing.assert_array_equal(pos, [100, 100, 200, 200])
    np.testing.assert_array_equal(vals, [-10000.0, 0.25, -3.0, 1e-3])
    assert_tracks_equal(read_gtrack_points(path), jax_python_tracks(path))


EDGE_VCF = (
    "##fileformat=VCFv4.2\n"
    "##contig=<ID=chr1>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
    "s1\ts2\ts3\n"
    "chr1\t100\t.\tA\tT\t50\tPASS\t.\tGT:DP\t0/0:3\t0|1:9\t1/1:2\n"
    "chr1\t180\t.\tG\tC\t50\tPASS\t.\tGT:DP\t./.:0\t1|0:4\t0|0:7\n"
    "chr2\t40\t.\tC\tA\t50\tPASS\t.\tGT:DP\t./1:1\t2/1:5\t1/1:6\n"
    "chr2\t90\t.\tT\tG\t50\tPASS\t.\tGT:DP\t1/1:8\t.|.:0\t0/1:3\n"
)


@pytest.mark.parametrize("population", [["s1", "ghost", "s3"], ["s3", "s2", "s1"], ["s2"]])
def test_native_vcf_convert_matches_jax_python(tmp_path, population):
    """Phased, half-missing, multi-allelic and missing names: the port's
    C++ converter writes the JAX package's Python converter's bytes."""
    vcf = tmp_path / "t.vcf"
    vcf.write_text(EDGE_VCF)
    ref = io.StringIO()
    ref.write(jgtrack.gtrack_points_header("g"))
    with open(vcf) as fh:
        found_ref = jvcf._convert_stream(fh, population, ref)
    out = tmp_path / "native.gtrack"
    found = vcf_convert_native(vcf, out, tgtrack.gtrack_points_header("g"), population)
    assert found == found_ref == [n for n in population if n != "ghost"]
    assert out.read_text() == ref.getvalue()


def test_vcf_to_gtrack_plain_and_gz_equal(tmp_path):
    """The public converter takes the native path for a plain file and
    the Python path for .gz: the same bytes, and the JAX converter's on
    the .gz."""
    plain = tmp_path / "x.vcf"
    pos, am, bm = synth.make_panel(300, 30_000, 4, 3, seed=12)
    names = synth.write_vcf(plain, "chrX", pos, am, bm)
    gz = tmp_path / "x.vcf.gz"
    with gzip.open(gz, "wt") as f:
        f.write(plain.read_text())
    outs = {k: tmp_path / f"{k}.gtrack" for k in ("plain", "gz", "jax")}
    assert vcf_to_gtrack(plain, names[:4], outs["plain"], "g") == names[:4]
    assert vcf_to_gtrack(gz, names[:4], outs["gz"], "g") == names[:4]
    assert jvcf.vcf_to_gtrack(gz, names[:4], outs["jax"], "g") == names[:4]
    assert outs["plain"].read_bytes() == outs["gz"].read_bytes() == outs["jax"].read_bytes()
    # and its rows are write_gtrack's values
    track = read_gtrack_points(outs["plain"])["chrX"]
    assert track.size == 4
    np.testing.assert_array_equal(track.values_matrix(), am)


def test_malformed_vcf_raises_as_jax(tmp_path):
    """A truncated data line: the native converter reports failure and the
    Python fallback raises, as the JAX package's converter does."""
    vcf = tmp_path / "t.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ta\tb\n"
        "chr1\t10\t.\tA\tT\t50\tPASS\t.\tGT\t0/0\t1/1\n"
        "chr1\t20\t.\tA\tT\t50\tPASS\t.\tGT\t0/1\n"
    )
    out = tmp_path / "o.gtrack"
    assert vcf_convert_native(vcf, out, tgtrack.gtrack_points_header("g"), ["a", "b"]) is None
    with pytest.raises(IndexError):
        vcf_to_gtrack(vcf, ["a", "b"], out, "g")
    with open(vcf) as fh, pytest.raises(IndexError):
        jvcf._convert_stream(fh, ["a", "b"], io.StringIO())
    no_header = tmp_path / "n.vcf"
    no_header.write_text("chr1\t10\t.\tA\tT\t50\tPASS\t.\tGT\t0/0\n")
    with pytest.raises(ValueError, match="#CHROM"):
        vcf_to_gtrack(no_header, ["a"], out, "g")


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Six threads build into one empty directory at once: each compiler
    writes its own temporary name and renames it into place, so every
    thread loads a whole library (no "file too short") and no temporary
    file is left."""
    paths, errors = [None] * 6, []
    barrier = threading.Barrier(6)

    def build(i):
        try:
            barrier.wait()
            paths[i] = native._build(tmp_path)
            lib = ctypes.CDLL(str(paths[i]))
            assert lib.gtrack_parse and lib.vcf_convert
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
