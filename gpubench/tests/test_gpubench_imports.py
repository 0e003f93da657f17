"""Nothing the command loads is JAX or the JAX package, by whole top-level
names (``divergence_tpu_torch`` begins with ``divergence_tpu`` and is not
it); the reference loads nothing of the program either."""

import json
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.tests.tiny import REPO

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=REPO,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_module_loads_no_jax():
    names = loaded("import gpubench.run, gpubench.harness, gpubench.scans, gpubench.trace\n"
                   "import gpubench.scans as s; s.Program  # noqa\n"
                   "import divergence_tpu_torch.engine")
    assert not names & {"jax", "jaxlib", "flax", "divergence_tpu"}
    assert "divergence_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded("import gpubench.reference.css, gpubench.reference.fet, "
                   "gpubench.reference.mc, gpubench.check, gpubench.traffic")
    assert not names & {"jax", "jaxlib", "flax", "divergence_tpu", "divergence_tpu_torch"}


@pytest.mark.parametrize("name,found", [("divergence_tpu_torch.engine", []),
                                        ("divergence_tpu.kernels", ["divergence_tpu"]),
                                        ("jaxlib.xla_client", ["jaxlib"])])
def test_forbidden_by_whole_name(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, object())
    got = harness.forbidden_modules()
    assert [f for f in got if f in ("divergence_tpu", "jaxlib")] == found


PLANTING_READER = '''
"""planted (host clock): a reader that loads a module named flax."""
import sys
import types


def read(run):
    sys.modules.setdefault("flax", types.ModuleType("flax"))
    return 1.0
'''


def test_a_module_loaded_after_the_window_refuses_the_result(tmp_path, monkeypatch, capsys):
    """A reader runs after the window and the check: what it loads is
    looked for before the result is given, and no result line is printed."""
    import torch

    from gpubench import run
    from gpubench.tests.tiny import tiny_root

    root = tiny_root(tmp_path)
    (root / "gpubench" / "metrics" / "planted.py").write_text(PLANTING_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "planted", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    real = harness.run_cell
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda root_, wl, seed, secs, tr, _dev, t0: real(
        root_, wl, seed, secs, tr, torch.device("cpu"), t0))
    assert "flax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="flax"):
            run.main(["--workload", "stickleback.css_hot", "--seed", "2147483713",
                      "--seconds", "0", "--trace", "0"])
    finally:
        sys.modules.pop("flax", None)
    assert capsys.readouterr().out == ""
