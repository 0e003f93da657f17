"""The port's ``run-fet`` CLI (``--device cpu``) against the JAX CLI's
``run-fet`` on the same toy GTrack pair: identical rows (seqid, start),
values within 1e-12 (exact) / 1e-5 (fast) relative to max(|ref|, 1), and
``--resume`` reproducing the fresh track byte for byte."""

import json

import numpy as np
import pytest
import torch

from divergence_tpu.io.gtrack import read_score_track as jax_read_score_track
from divergence_tpu.tools.cli import main as jax_cli
from divergence_tpu_torch.io import read_score_track
from divergence_tpu_torch.tools import synth
from divergence_tpu_torch.tools.cli import main as torch_cli

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
