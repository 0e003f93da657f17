"""Where K6's block form (css_smacof_block) spends its cycles, by phase, on
the card: builds an instrumented copy of a tree's ``csrc/css_smacof.cu``
(this tree's by default) in which thread 0 of each block adds the clock64
cycles since its last stamp to a phase's count after each phase's closing
barrier:

    fill      — the window's fill statistics (fill_stats_block);
    embed     — mode 2's cmds_embed_block (mode 1's inits: see "F");
    F         — the diagonal's sum and F's upper triangle staged once a
                window, then each restart's inits;
    pairs     — the fused pass over the pairs, which also sums the
                transform;
    rows      — the transform's finish;
    epilogue  — the task's hand-off, the argmin, distances and score.

It runs the kernel on the envelope cell's 997 windows (10 k SNPs / 500
kbp, seed 11) at 70 + 58 and 110 + 90, modes 1 and 2, both precisions,
in the form the tree's own form query picks, and prints cycles a window by
phase (summed over the blocks), cycles a transform for the passes, and the
launch's time by CUDA events (the second of two calls).  The stamps add no
barrier but one after the staging of F.  On a machine with a card and
nvcc:

    python tests/measure_smacof_block.py [--csrc DIR] [--out DIR]

(--csrc: another tree's ``divergence_tpu_torch/csrc`` with the same block
body, e.g. an edited copy in a gitignored directory.)"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

PHASES = ("fill", "embed", "F", "pairs", "rows", "epilogue")
FILL, EMBED, STAGE, PAIRS, ROWS, EPI = range(len(PHASES))
AFTER, BEFORE = "after", "before"
# (phase, where, lines): a stamp for the phase after or before the lines
# (each set unique in the source), indented as their last line
STAMPS = [
    (FILL, AFTER, "        const Fill<T> fs = fill_stats_block<NT>(D, m, red);\n"),
    (EMBED, AFTER, "        if (mode == 2) cmds_embed_block<NT>(D, m, fs.avg, S, X0, red);"
                   "   // ends with a barrier\n"),
    (STAGE, BEFORE, "        int best = 0, best_n = 0, total = 0;\n"),
    (STAGE, BEFORE, "            T* X = X0;\n"),
    (PAIRS, AFTER, "    T sig = pair_sums(Fp, *X, colp, rowp, spw, m, diag);\n"),
    (ROWS, AFTER, "        guttman_finish(colp, rowp, *X, *XN, m);\n"),
    (PAIRS, AFTER, "        const T s = pair_sums(Fp, *X, colp, rowp, spw, m, diag);\n"),
    (EPI, AFTER, "            __syncthreads();   // X0 and the stress slots are the next restart's\n"),
    (EPI, AFTER, "        if (w >= nwin) break;\n"),
    (EPI, AFTER, "        __syncthreads();   // Xb and bc are the next task's\n"),
]
# where the block kernel begins and ends (its stamps' set-up and flush)
START = "    constexpr int NT = kSmacofThreads;\n    int* bc ="
END = "        __syncthreads();   // Xb and bc are the next task's\n        PH(5);\n    }\n}\n"

HEAD = f"""
#define NPH {len(PHASES)}
__shared__ long long ph_acc[NPH];
__shared__ long long ph_last;
__device__ unsigned long long ph_total[NPH];
#define PH(k) if (threadIdx.x == 0) {{ const long long n_ = clock64(); \\
    ph_acc[k] += n_ - ph_last; ph_last = n_; }}
#define PH_INIT if (threadIdx.x == 0) {{ for (int q_ = 0; q_ < NPH; ++q_) ph_acc[q_] = 0; \\
    ph_last = clock64(); }}
#define PH_FLUSH if (threadIdx.x == 0) {{ for (int q_ = 0; q_ < NPH; ++q_) \\
    atomicAdd(&ph_total[q_], static_cast<unsigned long long>(ph_acc[q_])); }}
"""
TAIL = """
extern "C" int ph_read(unsigned long long* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, ph_total, sizeof(ph_total)));
}
extern "C" int ph_reset() {
    unsigned long long z[NPH] = {};
    return static_cast<int>(cudaMemcpyToSymbol(ph_total, z, sizeof(z)));
}
"""


def instrumented_source(csrc: Path) -> str:
    """The tree's css_smacof.cu with the stamps."""
    src = (csrc / "css_smacof.cu").read_text()
    for k, where, lines in STAMPS:
        if src.count(lines) != 1:
            raise RuntimeError(f"css_smacof.cu changed: lines {lines!r} found "
                               f"{src.count(lines)} times")
        last = lines.rstrip("\n").rsplit("\n", 1)[-1]
        indent = " " * (len(last) - len(last.lstrip()))
        stamp = f"{indent}PH({k});\n"
        if where == BEFORE and k == STAGE and "best" in lines:
            stamp = f"{indent}__syncthreads();\n{stamp}"   # the staging ends with no barrier
        src = src.replace(lines, lines + stamp if where == AFTER else stamp + lines)
    for anchor in (START, END):
        if anchor not in src:
            raise RuntimeError(f"css_smacof.cu changed: no lines {anchor!r}")
    src = src.replace(START, "    PH_INIT;\n" + START, 1)
    src = src.replace(END, END[: -len("    }\n}\n")] + "    }\n    PH_FLUSH;\n}\n", 1)
    return HEAD + src + TAIL


def cells(a: int, b: int, dev):
    """The envelope cell's windows at a + b: (dissimilarities [B, m, m],
    npos, slots) on the card."""
    pos, am, bm = make_chromosome(10_000, 500_000, a, b, 11)
    plan = plan_windows(pos, 500_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1).astype(np.int16)).to(dev)
    dis = kcss.dissimilarity_plain(vals, torch.from_numpy(plan.lo[ids]),
                                   torch.from_numpy(plan.npos[ids]))
    return (dis, torch.from_numpy(plan.npos[ids].copy()).to(dev),
            torch.from_numpy(plan.slot[ids].copy()).to(dev))


def main(csrc: Path, out: Path) -> None:
    src, lib_path = out / "smacof_block_phases.cu", out / "smacof_block_phases.so"
    src.write_text(instrumented_source(csrc))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"{card}; {csrc}")
    key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("_"))   # run_css's default
    k0, k1 = (int(v) for v in key.tolist())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P = ctypes.c_void_p
    for a, b in ((70, 58), (110, 90)):
        m = a + b
        dis, npos, slots = cells(a, b, dev)
        B = dis.shape[0]
        w = kcss.chain_weights_host(a, b)
        for dt in (torch.float32, torch.float64):
            sfx = "f32" if dt == torch.float32 else "f64"
            d = dis.to(dt).contiguous()
            for mds in (1, 2):
                elems = ctypes.c_int64(0)
                form = getattr(lib, f"css_smacof_form_{sfx}")(m, mds, ctypes.byref(elems))
                if form < 1:
                    raise RuntimeError(f"m = {m} takes the warp form ({form})")
                slabs = (torch.empty(sms * elems.value, dtype=dt, device=dev) if form == 2
                         else None)
                scores = torch.empty(B, dtype=dt, device=dev)
                dist = torch.empty_like(d)
                ints = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
                valid = torch.empty(B, dtype=torch.bool, device=dev)
                fn = getattr(lib, f"css_smacof_block_{sfx}")
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                for _ in range(2):   # the second call is the one read
                    counters = torch.zeros(B + 1, dtype=torch.int32, device=dev)
                    lib.ph_reset()
                    args = [P(d.data_ptr()), P(npos.data_ptr()), P(slots.data_ptr()),
                            ctypes.c_int64(B), ctypes.c_uint32(k0), ctypes.c_uint32(k1), a, b,
                            mds, 4, 300, ctypes.c_double(1e-6), ctypes.c_double(float(w[0])),
                            ctypes.c_double(float(w[-1])), P(scores.data_ptr()),
                            P(dist.data_ptr()), P(valid.data_ptr()), P(ints[0].data_ptr()),
                            P(ints[1].data_ptr()), P(ints[2].data_ptr()),
                            P(counters.data_ptr()),
                            P(None if slabs is None else slabs.data_ptr()),
                            ctypes.c_int64(sms if slabs is not None else 0), P(None)]
                    start.record()
                    rc = fn(*args)
                    stop.record()
                    torch.cuda.synchronize()
                    if rc != 0:
                        raise RuntimeError(f"css_smacof_block launch failed: CUDA error {rc}")
                cyc = (ctypes.c_ulonglong * len(PHASES))()
                if lib.ph_read(cyc) != 0:
                    raise RuntimeError("reading the stamps failed")
                cyc = np.array(cyc[:], dtype=np.float64)
                transforms = int(ints[2].sum())
                total = cyc.sum()
                print(f"m={m} {sfx} mode {mds} ({['', 'block', 'device'][form]}): "
                      f"{start.elapsed_time(stop):.3f} ms for {B} windows, {transforms} "
                      f"transforms; {total / B:,.0f} block-cycles a window: " + ", ".join(
                          f"{name} {v / B:,.0f} ({100 * v / total:.1f} %)"
                          for name, v in zip(PHASES, cyc))
                      + f"; a transform: pairs {cyc[PAIRS] / transforms:,.0f}, rows "
                        f"{cyc[ROWS] / transforms:,.0f} cycles", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None)
    ns = ap.parse_args()
    if ns.out is not None:
        ns.out.mkdir(parents=True, exist_ok=True)
        main(ns.csrc.resolve(), ns.out)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(ns.csrc.resolve(), Path(tmp))
