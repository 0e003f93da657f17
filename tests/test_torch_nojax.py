"""divergence_tpu_torch runs where JAX is absent: a fresh interpreter with
``sys.modules["jax"] = None`` (every ``import jax`` raises) imports the
package and runs run_fet, run_css (CMDS, SMACOF, drosophila, approx mode,
the window stream with threefry draws, the native evaluator), the sharded
step and the engines over a CPU mesh, bench-scaling, both CLI scans (one
of them split over two hosts and merged), ``run-all`` with the exact
FET rank path, the region callers and the report, ``convert-vcf`` and the
native GTrack parse, the analysisDef protocol and ``bench-mc``, on the
CPU."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)   # small ops; the test workers share the cores
import numpy as np
import divergence_tpu_torch
from divergence_tpu_torch.config import CssConfig, FetConfig
from divergence_tpu_torch.engine import SnpPair, run_css, run_fet
from divergence_tpu_torch.kernels import css, linalg, perm
from divergence_tpu_torch.tools import bench_scaling, cli, report, synth
from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
from divergence_tpu_torch.stats import call_css_regions, filter_fet_regions


def no_jax():
    assert "divergence_tpu" not in sys.modules
    for name, mod in list(sys.modules.items()):
        assert mod is None or not name.startswith("jax"), name


no_jax()
pos, am, bm = synth.make_panel(300, 20_000, 11, 10, seed=1)
for prec in ("exact", "fast"):
    s, d = run_fet(SnpPair(pos, am, bm), 20_000, FetConfig(precision=prec), device="cpu")
    assert s.shape == (40,) and np.isfinite(s).all() and (s != 0).sum() > 10
    s, p = run_css(SnpPair(pos, am, bm), 20_000, CssConfig(precision=prec, mc_runs=500),
                   device="cpu")
    assert s.shape == (40,) and np.isfinite(s).all() and ((p > 0) == (s != 0)).all()
s, p = run_css(SnpPair(pos, am, bm), 20_000, CssConfig(mds=1, mc_runs=300), device="cpu")
assert np.isfinite(s).all() and (s != 0).sum() > 10
for kw in ({"p_mode": "approx"}, {"mc_stream": "window", "rng": "threefry"},
           {"perm_backend": "native"}):
    s, p = run_css(SnpPair(pos, am, bm), 20_000, CssConfig(mc_runs=300, **kw), device="cpu")
    assert (s != 0).sum() > 10 and ((p > 0) == (s != 0)).all(), kw
fpos, fa, fb = synth.make_freq_chromosome(300, 20_000, 2)
s, p = run_css(SnpPair(fpos, fa, fb), 20_000, CssConfig(drosophila=True, mc_runs=300),
               device="cpu")
assert (s != 0).sum() > 10 and (p[s != 0] == 1.0).all()
cpu = torch.device("cpu")
mesh = make_mesh(devices=[cpu] * 2)
codes = np.random.default_rng(0).choice(np.array([3, -3, 0], np.int16), size=(8, 32, 21))
out = make_divergence_step(mesh, 11, 10, nsamples=4, mc_chunk=8)(
    codes[..., :11], codes[..., 11:], np.full(8, 30), np.arange(8), divergence_tpu_torch.rng.prng_key(0))
assert float(out["windows_evaluated"]) == 8 and np.isfinite(float(out["score_sum"]))
s0, _ = run_fet(SnpPair(pos, am, bm), 20_000, FetConfig(), device="cpu")
s1, _ = run_fet(SnpPair(pos, am, bm), 20_000, FetConfig(), sharding=mesh)
assert np.array_equal(s0, s1)
s, p = run_css(SnpPair(pos, am, bm), 20_000, CssConfig(mc_runs=300), sharding=mesh)
assert (s != 0).sum() > 10
rep = bench_scaling.run_scaling_bench(max_devices=2, windows_per_device=4, npos=16,
                                      nsamples=2, mc_chunk=8, repeats=1, devices=[cpu] * 2)
assert rep["backend"] == "cpu"
tmp = sys.argv[2]
synth.write_gtrack(tmp + "/a.gtrack", "chrZ", pos, am)
synth.write_gtrack(tmp + "/b.gtrack", "chrZ", pos, bm)
cli.main(["run-fet", "--pop-a", tmp + "/a.gtrack", "--pop-b", tmp + "/b.gtrack",
          "--out", tmp + "/o.track", "--device", "cpu"])
cli.main(["run-css", "--pop-a", tmp + "/a.gtrack", "--pop-b", tmp + "/b.gtrack",
          "--out", tmp + "/c.track", "--device", "cpu", "--mc-runs", "500"])
for h in ("0", "1"):
    cli.main(["run-fet", "--pop-a", tmp + "/a.gtrack", "--pop-b", tmp + "/b.gtrack",
              "--out", tmp + "/o" + h + ".track", "--device", "cpu", "--num-hosts", "2",
              "--host-id", h, "--shard"])
cli.main(["merge-tracks", "--inputs", tmp + "/o0.track", tmp + "/o1.track", "--out",
          tmp + "/m.track"])
assert open(tmp + "/m.track").read() == open(tmp + "/o.track").read()
cli.main(["run-all", "--pop-a", tmp + "/a.gtrack", "--pop-b", tmp + "/b.gtrack", "--outdir",
          tmp + "/all", "--device", "cpu", "--mc-runs", "300", "--precision", "exact"])
import os
for f in ("fet.track", "css.track", "fet_regions.gtrack", "css_regions.gtrack", "report.html"):
    assert os.path.getsize(tmp + "/all/" + f) > 0, f
cli.main(["report", "--fet-track", tmp + "/all/fet.track", "--out", tmp + "/r.html"])
names = synth.write_vcf(tmp + "/p.vcf", "chrZ", pos, am, bm)
cli.main(["convert-vcf", "--vcf", tmp + "/p.vcf", "--population", ",".join(names[:11]),
          "--out", tmp + "/va.gtrack"])
from divergence_tpu_torch.io import gtrack, read_gtrack_points
assert np.array_equal(read_gtrack_points(tmp + "/va.gtrack")["chrZ"].values_matrix(), am)
assert gtrack.PARSES["native"] > 0
from divergence_tpu_torch.compat import config_from_analysis_def
from divergence_tpu_torch.tools import bench_mc, doctor
assert config_from_analysis_def(
    "x ([wStep=500] [wSize=2500] [percentile=0.95])-> FisherExactScoreStat").percentile == 0.95
rep = bench_mc.run_mc_bench(window_batch=4, chunk=8, iters=1, backends=("inloop", "xla"),
                            device="cpu")
assert "error" not in rep["inloop"] and "error" not in rep["xla"]
no_jax()
print("NOJAX-OK")
"""


def test_port_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=300, check=False,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout
    assert (tmp_path / "o.track").exists() and (tmp_path / "c.track").exists()
    assert (tmp_path / "all" / "report.html").exists()


def test_port_sources_never_import_jax():
    for path in (ROOT / "divergence_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
            assert not stripped.startswith(
                ("import divergence_tpu.", "from divergence_tpu.", "from divergence_tpu ")
            ), path
