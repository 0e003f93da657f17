"""Environment diagnostics of the port: torch and CUDA, the devices, the
card's name and power limit, ``nvcc``, the kernel cache, the native host
library (``divergence_tpu/tools/doctor.py``, with this machine's layers in
place of the TPU tunnel probes).

A CUDA deployment fails in its own ways: a wedged device blocks its
initialisation, ``nvcc`` is missing so the kernels cannot build, the
``_build/`` cache holds a library of other sources, ``g++`` is missing so
the GTrack parse falls back to Python.  ``doctor`` probes each layer, the
device in a subprocess under ``--timeout``, and prints one JSON report; a
probe that fails is reported in its field.

Usage: ``python -m divergence_tpu_torch.tools.cli doctor [--timeout S]``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def _run(cmd: list[str], timeout_s: int) -> dict:
    """{"ok", "stdout"} of a command, or {"ok": False, "error"}."""
    try:
        r = subprocess.run(cmd, timeout=timeout_s, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"{cmd[0]} exceeded {timeout_s}s"}
    except OSError as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    if r.returncode != 0:
        return {"ok": False, "error": (r.stderr or r.stdout or "no output")[-400:]}
    return {"ok": True, "stdout": r.stdout}


def _probe_devices(timeout_s: int) -> dict:
    """CUDA initialisation in a subprocess (a wedged device blocks the
    calling process indefinitely; a thread cannot be killed)."""
    code = (
        "import json, torch; "
        "n = torch.cuda.device_count() if torch.cuda.is_available() else 0; "
        "print(json.dumps({'platform': 'cuda' if n else 'cpu', 'cuda_available': n > 0, "
        "'n': n, 'kind': torch.cuda.get_device_name(0) if n else 'cpu', "
        "'names': [torch.cuda.get_device_name(i) for i in range(n)]}))"
    )
    r = _run([sys.executable, "-c", code], timeout_s)
    if not r["ok"]:
        if "exceeded" in r["error"]:
            r["error"] = (f"CUDA initialisation exceeded {timeout_s}s "
                          "(device wedged or held by another process?)")
        return r
    # warnings can interleave with the JSON line; a diagnosis tool must
    # report the garbage, not crash on it
    try:
        out = json.loads(r["stdout"].strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return {"ok": False,
                "error": "probe emitted non-JSON stdout: " + r["stdout"].strip()[-300:]}
    out["ok"] = True
    return out


def _probe_card(timeout_s: int) -> dict:
    """The cards' name and power limit as ``nvidia-smi`` gives them."""
    r = _run(CARD_QUERY, timeout_s)
    if not r["ok"]:
        return r
    return {"ok": True, "cards": [ln.strip() for ln in r["stdout"].splitlines() if ln.strip()]}


def _probe_nvcc(timeout_s: int) -> dict:
    from divergence_tpu_torch.kernels import _build

    try:
        path = _build._nvcc()
    except RuntimeError as e:
        return {"ok": False, "error": str(e)}
    r = _run([path, "--version"], timeout_s)
    if not r["ok"]:
        return {"path": path, **r}
    lines = r["stdout"].strip().splitlines()
    return {"ok": True, "path": path, "version": lines[-1] if lines else ""}


def _kernel_cache() -> dict:
    """The ``_build/`` directory: its entries, and whether the kernel
    library of the current ``csrc/`` sources is built there."""
    from divergence_tpu_torch.kernels import _build

    cache = _build.BUILD_DIR
    report: dict = {"dir": str(cache)}
    try:
        entries = sorted(os.listdir(cache)) if cache.is_dir() else []
        lib = f"libdivergence_kernels_{_build._digest()}.so"
        report.update({
            "entries": len(entries),
            "kernel_library": lib,
            "kernel_library_built": lib in entries,
        })
    except OSError as e:
        report["error"] = str(e)
    return report


def run_doctor(timeout_s: int = 60) -> dict:
    report: dict = {
        "python": sys.version.split()[0],
        "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "DIVERGENCE_TPU_NO_NATIVE": os.environ.get("DIVERGENCE_TPU_NO_NATIVE"),
    }

    import torch

    report["torch"] = torch.__version__
    report["torch_cuda"] = torch.version.cuda

    report["default_backend_probe"] = _probe_devices(timeout_s)
    report["nvidia_smi"] = _probe_card(timeout_s)
    report["nvcc"] = _probe_nvcc(timeout_s)
    report["compile_cache"] = _kernel_cache()

    try:
        from divergence_tpu_torch import native

        report["native_parser"] = bool(native.native_available())
        if report["native_parser"]:
            report["native_library"] = str(native.library_path())
        else:
            report["native_error"] = native.build_error()
    except Exception as e:
        report["native_parser"] = f"error: {e}"

    # a tiny torch compute check on the CPU, away from the device
    code = "import torch; print(float((torch.ones(8, 8) @ torch.ones(8, 8)).sum()))"
    r = _run([sys.executable, "-c", code], timeout_s)
    if r["ok"]:
        report["cpu_compute"] = "ok" if "512" in r["stdout"] else "failed"
    else:
        report["cpu_compute"] = "timeout" if "exceeded" in r["error"] else "failed"

    return report


def main(args) -> None:
    print(json.dumps(run_doctor(timeout_s=args.timeout), indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=int, default=60)
    main(ap.parse_args())
