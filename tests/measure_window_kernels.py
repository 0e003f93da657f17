"""Device time of the window kernels K2, K2r, K10 and K3 on the bench FET
workload (make_chromosome(8_000_000, 400_000_000, 11, 10, 7): 799,997
windows, their codes gathered at P = 128 for K10 and K3's gather form),
per kernel by torch.profiler (each kernel's self time, mean of 5 calls
after a warm call, descriptors on the card), for the copy of the port
found at TREE.  The rows with nsamples 1 and perc 1 split K2's and K10's
time between the bootstrap and the rest.  Needs one CUDA card:

    python tests/measure_window_kernels.py TREE TAG

To compare two commits on one card, unpack the other commit's
``divergence_tpu_torch`` with ``git archive`` into a directory and run
TREE = that directory and TREE = this checkout in turns (a, b, b, a).
A commit whose K3 has no gather form times its joint-matrix route (the
codes concatenated, then the chromosome form on windows at b P)."""

import re
import sys

TREE, TAG = sys.argv[1], sys.argv[2]
sys.path.insert(0, TREE)
sys.modules["jax"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import divergence_tpu_torch  # noqa: E402
from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.engine.fet_engine import chromosome_key  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.kernels import fet as kfet  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

REPS = 5
P = 128


def kernel_ms(fn, keys) -> dict:
    """{kernel name: mean self device ms} of the kernels whose names hold
    one of ``keys``, over REPS calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            # the kernel's own name: the first identifier followed by its
            # template or argument list ("void (anonymous namespace)::k<T>(...)")
            found = re.search(r"(\w+)(?=<|\()", e.key)
            name = found.group(1) if found else e.key[:40]
            if any(k in name for k in keys):
                out[name] = round(out.get(name, 0.0) + e.self_device_time_total / 1e3 / REPS, 4)
    return out


def main() -> None:
    assert divergence_tpu_torch.__file__.startswith(TREE), divergence_tpu_torch.__file__
    dev = torch.device("cuda", 0)
    pos, am, bm = make_chromosome(8_000_000, 400_000_000, 11, 10, 7)
    plan = plan_windows(pos, 400_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    lo, npos, slot = (torch.from_numpy(a[ids].copy()).to(dev)
                      for a in (plan.lo, plan.npos, plan.slot))
    vals = SnpPair(pos, am, bm).to_device(dev)
    key = chromosome_key(0, "chrBench")
    maxs, nmax = kfet.support_size(11, 10), 23
    B = lo.numel()
    offs = torch.arange(P, device=dev)[None, :]
    g = vals[torch.where(offs < npos[:, None], lo[:, None] + offs, lo[:, None])]
    av, bv = g[..., :11].contiguous(), g[..., 11:].contiguous()
    del g
    rows = {}
    for fast in (True, False):
        prec = "fast" if fast else "exact"
        dt = torch.float32 if fast else torch.float64
        logs = kfet.fet_snp_logs(vals, 11, maxs, nmax, fast)
        for label, perc, ns in (("", 0.95, 100), (" nsamples 1", 0.95, 1), (" perc 1", 1.0, 100)):
            rows[f"K2 {prec}{label}"] = kernel_ms(
                lambda: kfet.fet_aggregate(logs, lo, npos, slot, key, perc, ns), ["fet_aggregate"])
        ls, r = kfet.fet_snp_ranks(vals, 11, maxs, nmax, fast)
        rows[f"K2r {prec}"] = kernel_ms(
            lambda: kfet.fet_aggregate_ranks(ls, r, lo, npos, slot, key, 0.95, 100),
            ["fet_aggregate_ranks"])
        for label, ns in (("", 100), (" nsamples 1", 1)):
            rows[f"K10 {prec}{label}"] = kernel_ms(
                lambda: kfet.fet_window_batch(av, bv, npos, 0.95, key, ns, maxs, nmax, fast, slot),
                ["fet_window"])
        rows[f"K3 chromosome {prec}"] = kernel_ms(
            lambda: kcss.css_dissim(vals, lo, npos, dt), ["css_dissim", "css_pack"])
        if hasattr(kcss, "css_dissim_gathered"):
            rows[f"K3 gathered {prec}"] = kernel_ms(
                lambda: kcss.css_dissim_gathered(av, bv, npos, dt), ["css_dissim"])
        else:
            rows[f"K3 gathered {prec} (joint route)"] = kernel_ms(
                lambda: kcss.css_dissim(torch.cat([av, bv], -1).reshape(B * P, 21),
                                        torch.arange(B, device=dev) * P, npos, dt),
                ["css_dissim", "CatArray"])
    for name, ms in rows.items():
        print(f"{TAG} | {name} | {ms}", flush=True)


if __name__ == "__main__":
    main()
