"""K1r on the card: the LUT sort alone at four panels and the 8 M-SNP
call split into its three launches.  Builds a tree's ``csrc/fet_snp.cu``
and ``csrc/fet_rank.cu`` (this tree's by default) into a library of their
own and calls the exports directly.

* The sort alone (``fet_lut_rank``) on K1's LUT at 11 + 10, 15 + 15,
  20 + 20 and 38 + 38, fast and exact: the median of 5 calls by CUDA
  events, its outputs held bit for bit to ``fet_lut_rank_plain``; beside
  it ``torch.sort(lut + 0.0, stable=True)`` alone (values and indices) and
  the whole plain version.
* K1r on the 8 M SNPs of the bench workload (8 M SNPs / 400 Mbp at
  11 + 10, ``bench.py:240-241``), split by ablation: the LUT build, the
  sort and the per-SNP lookup together, then without the sort (the
  lookup reads a rank table made beforehand), then the build alone; the
  differences are the sort's and the lookup's shares.

A tree whose sort is the counting rank (``lut_count_rank``: one pass up
to 65,536 entries, runs of 1,024 and merge passes above) is called as
that tree's wrapper called it; a tree whose sort is the radix sort with
the scratch its ``fet_lut_rank_scratch`` query names.  ``--variants
[LABEL ...]`` also times the sort of radix trees built with one change
each: the entries a thread fixed at 4 or 16, the look-back reading 32
tiles' words at a time, and ablations that split the sort's time (their
outputs are wrong and not held): its passes without the write-out to
device memory, and its launches cut after 0, 1 or 2 passes (0: the
scratch's zeroing and the histogram alone).

``--profile`` also runs torch.profiler over 5 calls of the sort at each
panel and prints its kernels' device time a call.

    python tests/measure_lut_rank.py [--csrc DIR] [--out DIR] [--variants] [--profile]

(--csrc: another tree's ``divergence_tpu_torch/csrc``, e.g. the parent
commit's unpacked by ``git archive`` into a gitignored directory.)"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.modules["jax"] = None

from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import fet as kfet  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

PANELS = ((11, 10), (15, 15), (20, 20), (38, 38))
BENCH = (8_000_000, 400_000_000, 11, 10, 7)
# the counting rank's wrapper constants (one run to this many entries,
# runs of COUNT_RUN above)
COUNT_WHOLE, COUNT_RUN = 1 << 16, 1024
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ITEMS_RULE = "    return G >= 2 * sms * kThreads * 16 ? 16 : 4;"
WRITE_OUT = """        if (final_pass) {
            lut_sorted[g] = x;
            rank_of_entry[ti[q]] = g;
        } else {
            vout[g] = x;
            iout[g] = ti[q];
        }
"""
PASS_LOOP = "    for (int p = 0; p < static_cast<int>(sizeof(T)); ++p) {"
LOOK_BACK = "        while (!done) {"


CLOCKS = [
    ("    if (tid == 0) misc[0] = static_cast<int>(atomicAdd(head->ticket + p, 1u));",
     "    const long long c0 = clock64();\n"
     "    if (tid == 0) misc[0] = static_cast<int>(atomicAdd(head->ticket + p, 1u));"),
    ("    const int tile = misc[0];", "    const int tile = misc[0];\n    const long long c1 = clock64();"),
    ("    // thread t takes digit t: the tile's count, published at once, and",
     "    const long long c2 = clock64();\n"
     "    // thread t takes digit t: the tile's count, published at once, and"),
    ("    tstart[tid] = start;\n    __syncthreads();",
     "    tstart[tid] = start;\n    __syncthreads();\n    const long long c3 = clock64();"),
    ("    // decoupled look-back: the entries",
     "    __syncthreads();\n    const long long c4 = clock64();\n    // decoupled look-back: the entries"),
    ("    // out in digit runs: entry q",
     "    const long long c5 = clock64();\n    // out in digit runs: entry q"),
    ("""            iout[g] = ti[q];
        }
    }
}""", """            iout[g] = ti[q];
        }
    }
    __syncthreads();
    if (tid == 0) {
        int* o = index + G + 8 * tile;
        o[0] = int(c1 - c0); o[1] = int(c2 - c1); o[2] = int(c3 - c2);
        o[3] = int(c4 - c3); o[4] = int(c5 - c4); o[5] = int(clock64() - c5);
    }
}"""),
]
PHASES = ("load", "count walks", "scans", "scatter walks", "write-out")
PHASES = ("ticket", "load + rank", "counts + scan", "scatter to shared", "look-back",
          "write-out")


def passes(k: int) -> tuple[str, str]:
    return PASS_LOOP, f"    for (int p = 0; p < {k}; ++p) {{"


# label -> [(text of a radix tree's fet_rank.cu, its replacement), ...]
VARIANTS = {
    **{f"{n} entries a thread": [(ITEMS_RULE, f"    return {n};")] for n in (4, 16)},
    "look-back window 32": [("constexpr int kWindow = 16;", "constexpr int kWindow = 32;")],
    "ablation: no write-out": [(WRITE_OUT, "        if (g < 0) vout[0] = x;\n")],
    **{f"ablation: {k} pass{'es' if k != 1 else ''}": [passes(k)] for k in (0, 1, 2)},
    # the first pass alone reads the LUT and writes scratch only, so its
    # tiles may take their offsets as 0 (overlapping writes) safely
    "ablation: 1 pass, no look-back": [passes(1), (LOOK_BACK, "        while (done) {")],
    # the first pass alone, thread 0 of each tile writing its cycles by
    # phase into the index scratch's second half (unused by that pass)
    "clocks: 1 pass": [passes(1), *CLOCKS],
}


def build(csrc: Path, work: Path, patches: dict) -> dict:
    """{label: (library, kind)}: the tree's K1 and K1r sources as they are
    (label "as built") and with each patch, one nvcc each, all at once."""
    procs = {}
    for i, label in enumerate(["as built", *patches]):
        d = work / f"tree{i}"
        shutil.copytree(csrc, d)
        for old, new in patches.get(label, []):
            src = (d / "fet_rank.cu").read_text()
            if src.count(old) != 1:
                raise RuntimeError(f"{label}: the text to change is not in fet_rank.cu once")
            (d / "fet_rank.cu").write_text(src.replace(old, new))
        lib = d / "k1r.so"
        procs[label] = (d, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-shared", "-o", str(lib),
             str(d / "fet_snp.cu"), str(d / "fet_rank.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (d, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({label}):\n{log[-4000:]}")
        kind = "counting" if "lut_count_rank" in (d / "fet_rank.cu").read_text() else "radix"
        out[label] = (load(lib, kind), kind)
        if label == "as built":
            print("ptxas: " + ptxas(log), flush=True)
    return out


def ptxas(log: str) -> str:
    """Each sort kernel's registers, stack and spills from ptxas -v."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            entry = next((k for k in ("lut_onesweep", "lut_histogram",
                                      "lut_count_rank", "lut_merge") if k in name), None)
            if entry:
                entry += "<f64>" if "IdE" in name or "Id" in name[-6:] else ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if entry and m:
            rows.append(f"{entry}: stack {m.group(1)}, spills {m.group(2)} / {m.group(3)}")
        m = re.search(r"Used (\d+) registers", line)
        if entry and m and rows:
            rows[-1] += f", {m.group(1)} registers"
            entry = None
    return "; ".join(rows)


def load(path: Path, kind: str) -> ctypes.CDLL:
    out = ctypes.CDLL(str(path))
    for t in ("f64", "f32"):
        getattr(out, f"fet_lut_build_{t}").argtypes = (_P, _I, _I, _I, _I, _P, _P)
        getattr(out, f"fet_lut_rank_{t}").argtypes = (
            (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P) if kind == "counting"
            else (_P, _I, _P, _P, _P, _P))
    out.fet_snp_ranks.argtypes = (_P, _I64, _I, _I, _P, _P, _P)
    if kind == "radix":
        out.fet_lut_rank_scratch.argtypes = (_I, _I, ctypes.POINTER(ctypes.c_int64))
    out.fet_cuda_error_string.restype = ctypes.c_char_p
    return out


def checked(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.fet_cuda_error_string(rc).decode()})")


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` warm calls, each between
    its own two CUDA events and enqueued behind a busy kernel
    (``torch.cuda._sleep``), so that the host's time to enqueue the
    launches does not show."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def lut_of(lib, a: int, b: int, dt, dev) -> torch.Tensor:
    nmax, maxs = a + b + 2, kfet.support_size(a, b)
    lf = kfet._lf_table(nmax, dt, dev)
    lut = torch.empty((a + 1) ** 2 * (b + 1) ** 2, dtype=dt, device=dev)
    sfx = "f64" if dt == torch.float64 else "f32"
    checked(lib, getattr(lib, f"fet_lut_build_{sfx}")(lf.data_ptr(), nmax, a, b, maxs,
                                                     lut.data_ptr(), None), "fet_lut_build")
    return lut


class Sorter:
    """The tree's LUT sort on one LUT, its outputs and scratch made once."""

    def __init__(self, lib, kind: str, lut: torch.Tensor):
        self.lib, self.kind, self.lut = lib, kind, lut
        G = lut.numel()
        self.G = G
        self.sfx = "f64" if lut.dtype == torch.float64 else "f32"
        self.sorted = torch.empty_like(lut)
        self.rank = torch.empty(G, dtype=torch.int32, device=lut.device)
        if kind == "counting":
            self.span = G if G <= COUNT_WHOLE else COUNT_RUN
            self.scratch = ([torch.empty_like(t) for t in (lut, self.rank, lut, self.rank)]
                            if self.span < G else [None] * 4)
            self.form = "one run" if self.span >= G else f"runs of {COUNT_RUN} + merges"
        else:
            nbytes = ctypes.c_int64(0)
            rc = lib.fet_lut_rank_scratch(G, lut.element_size(), ctypes.byref(nbytes))
            if rc < 0:
                raise RuntimeError(f"fet_lut_rank_scratch({G}) failed (code {rc})")
            self.form = "radix"
            self.scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=lut.device)

    def __call__(self) -> None:
        fn = getattr(self.lib, f"fet_lut_rank_{self.sfx}")
        if self.kind == "counting":
            ptrs = [None if t is None else t.data_ptr() for t in self.scratch]
            rc = fn(self.lut.data_ptr(), self.G, self.span, *ptrs, self.sorted.data_ptr(),
                    self.rank.data_ptr(), None)
        else:
            rc = fn(self.lut.data_ptr(), self.G, self.scratch.data_ptr(),
                    self.sorted.data_ptr(), self.rank.data_ptr(), None)
        checked(self.lib, rc, "fet_lut_rank")

    def equal_to_plain(self) -> bool:
        self()
        ps, pr = kfet.fet_lut_rank_plain(self.lut)
        bits = torch.int64 if self.lut.dtype == torch.float64 else torch.int32
        return bool(torch.equal(self.rank, pr)
                    and torch.equal(self.sorted.view(bits), ps.view(bits)))


def sort_table(lib, kind: str, dev, tag: str = "", hold: bool = True) -> None:
    for a, b in PANELS:
        for prec, dt in (("fast", torch.float32), ("exact", torch.float64)):
            lut = lut_of(lib, a, b, dt, dev)
            G = lut.numel()
            s = Sorter(lib, kind, lut)
            lib_ms = median_ms(lambda: torch.sort(lut + 0.0, stable=True))  # noqa: B023
            plain_ms = median_ms(lambda: kfet.fet_lut_rank_plain(lut))  # noqa: B023
            eq = s.equal_to_plain() if hold else "not held"
            ms = median_ms(s)
            if "clocks: 1 pass" in tag:
                print_clocks(s, a, b, prec)
            print(f"[sort{tag} {a}+{b} {prec}] G={G} {s.form}: {ms:.4f} ms, equal to the plain "
                  f"version: {eq}; torch.sort(lut + 0.0, stable=True) {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x); the plain version {plain_ms:.4f} ms", flush=True)
            if eq is False:
                raise RuntimeError(f"fet_lut_rank {a}+{b} {prec} differs from its plain version")
            del lut, s


def print_clocks(s: "Sorter", a: int, b: int, prec: str) -> None:
    """The cycles by phase thread 0 of each tile wrote (clocks variants)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    items = 16 if s.G >= 2 * sms * 256 * 16 else 4
    tiles = -(-s.G // (256 * items))
    index_at = s.scratch.numel() - 2 * (-(-s.G * 4 // 256) * 256)
    c = s.scratch[index_at:].view(torch.int32)[s.G:s.G + 8 * tiles].view(tiles, 8)[:, :6]
    c = c.double().cpu()
    print(f"[clocks {a}+{b} {prec}] {tiles} tiles, cycles of thread 0 by phase, mean / max: "
          + "; ".join(f"{k} {float(c[:, i].mean()):.0f} / {float(c[:, i].max()):.0f}"
                      for i, k in enumerate(PHASES)), flush=True)


def profile_table(lib, kind: str, dev) -> None:
    """Each sort kernel's device time a call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for a, b in PANELS:
        for prec, dt in (("fast", torch.float32), ("exact", torch.float64)):
            s = Sorter(lib, kind, lut_of(lib, a, b, dt, dev))
            s()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    s()
                torch.cuda.synchronize()
            rows = [(e.key, getattr(e, "device_time_total", 0.0) / 5, e.count // 5)
                    for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0.0) > 0]
            rows.sort(key=lambda r: -r[1])
            print(f"[profile {a}+{b} {prec} {s.form}] device us a call: " + "; ".join(
                f"{k[:40]} x{n} {t:.2f}" for k, t, n in rows), flush=True)


def bench_split(lib, kind: str, dev) -> None:
    npos, region, a, b, seed = BENCH
    pos, am, bm = make_chromosome(npos, region, a, b, seed)
    vals = SnpPair(pos, am, bm).to_device(dev)
    del pos, am, bm
    N = vals.shape[0]
    out = torch.empty(N, dtype=torch.int32, device=dev)
    for prec, dt in (("fast", torch.float32), ("exact", torch.float64)):
        lut = lut_of(lib, a, b, dt, dev)
        sort = Sorter(lib, kind, lut)
        sort()
        table = sort.rank.clone()     # the rank table the ablated calls read

        def build_only():
            lut_of(lib, a, b, dt, dev)  # noqa: B023

        def lookup(rank):
            checked(lib, lib.fet_snp_ranks(vals.data_ptr(), N, a, b, rank.data_ptr(),
                                           out.data_ptr(), None), "fet_snp_ranks")

        def whole():
            sort.lut = lut_of(lib, a, b, dt, dev)  # noqa: B023
            sort()  # noqa: B023
            lookup(sort.rank)  # noqa: B023

        def no_sort():
            build_only()
            lookup(table)  # noqa: B023

        t = {k: median_ms(f) for k, f in (("whole", whole), ("no sort", no_sort),
                                          ("build", build_only))}
        alone = median_ms(lambda: lookup(table))  # noqa: B023
        torch.cuda.synchronize()
        print(f"[K1r {prec}, {N:,} SNPs at {a}+{b}, sort {sort.form}] build + sort + lookup "
              f"{t['whole']:.4f} ms; by ablation: build {t['build']:.4f}, sort "
              f"{t['whole'] - t['no sort']:.4f}, lookup {t['no sort'] - t['build']:.4f} "
              f"(the lookup alone {alone:.4f}; its bytes bound "
              f"{(vals.numel() * 2 + N * 4) / 3.35e12 * 1e3:.4f})", flush=True)
        del lut, sort, table


def main(csrc: Path, out: Path, variants: list | None, prof: bool) -> None:
    work = out / "lut_rank"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    libs = build(csrc, work, {} if variants is None else
                 {k: v for k, v in VARIANTS.items() if not variants or k in variants})
    lib, kind = libs.pop("as built")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"{card}; {csrc} (sort: {kind})", flush=True)
    sort_table(lib, kind, dev)
    for label, (vlib, vkind) in libs.items():
        sort_table(vlib, vkind, dev, f", {label}",
                   hold=not label.startswith(("ablation", "clocks")))
    if prof:
        profile_table(lib, kind, dev)
    bench_split(lib, kind, dev)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="a radix tree: also the sort built with these of VARIANTS (all "
                         "where none is named)")
    ap.add_argument("--profile", action="store_true",
                    help="also each sort kernel's device time by torch.profiler")
    ns = ap.parse_args()
    if ns.out is not None:
        ns.out.mkdir(parents=True, exist_ok=True)
        main(ns.csrc.resolve(), ns.out, ns.variants, ns.profile)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(ns.csrc.resolve(), Path(tmp), ns.variants, ns.profile)
